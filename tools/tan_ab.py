"""The single-ended tangent sweeps K3 and K4 (banded/tan.py) of one checkout
of the port on the card, for comparing two versions in one call.

Imports ``asvgp_tpu_torch`` from ROOT (a checkout's root, e.g. an earlier
commit unpacked with ``git archive`` into a directory that .gitignore
lists), builds its kernels there, holds K3 and K4 against their plain
versions on a random SPD Kuu and P, a random symmetric tangent band and a
random b (``chip_smoke.py``'s generators; k = 3, m = 10⁴) and times K3, K4
and the two together: CUDA events (median of 50 after a warm-up) and
device time by kernel (torch.profiler, 20 calls).  Options:

  --steps            also the value-and-grad steps at the north star
                     (``chip_smoke.py``'s data and model): the
                     single-ended one (under ``twist_scope(False)``: K3 and
                     K4) and the twisted one (K5, the mid step and K6), each
                     by CUDA events (median of 10) and device time;
  --first-chunk DIR  build the kernels of the checkout at DIR too (its
                     ``banded/_build.py`` loaded on its own), run its K3
                     and K4 and say whether the first chunk of each walk
                     (K3's first 128 columns, its bands' rows inside them;
                     K4's last 64) equals, bit for bit, this checkout's on
                     the same inputs; and whether K1, K2, K5 and K6 (whose
                     shared code moved) equal DIR's whole;
  --schur-chunk N    build with the Cholesky sweeps' chunks at least N
                     columns (``ASVGP_SCHUR_CHUNK``: K3, K5, K9, K15, K17);
  --tak-chunk N      build with K4's and K6's chunks at least N columns
                     (``ASVGP_TAK_QUAD_CHUNK``).

Needs an NVIDIA GPU and nvcc; run from the repository root, the versions
in turns:

    python tools/tan_ab.py build/parent --steps
    python tools/tan_ab.py . --steps --first-chunk build/parent

Prints one JSON object.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

from solve_ab import device_ms, event_ms
from twist_ab import arg, call, chunk_flags, other_library

REPO = Path(__file__).resolve().parents[1]
FIRST = (128, 64)  # K3's and K4's smallest chunks


def steps(dev) -> dict:
    """The single-ended and the twisted value-and-grad step at the north
    star."""
    import torch

    import chip_smoke as cs
    from asvgp_tpu_torch.banded import twist_scope

    x, y = cs.bench_data(cs.N, cs.SEED)
    x_d, y_d = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
    model = cs.make_model(x_d, y_d, cs.M, dev)

    def single():
        with twist_scope(False):
            cs.value_and_grad(model)

    out = {}
    for name, fn in (("single_ended", single), ("twisted", lambda: cs.value_and_grad(model))):
        out[f"{name}_step_ms"] = event_ms(fn, reps=10)
        out[f"{name}_step_device_ms"] = sum(device_ms(fn, 5).values())
    return out


def first_chunk_vs(root: str, dev, bands, mine3, mine4) -> dict:
    """This checkout's K3 and K4 outputs (``mine3``, ``mine4``) against the
    other checkout's on the same inputs: each walk's first chunk bit for
    bit; then K1, K2, K5 and K6 whole."""
    import torch

    from asvgp_tpu_torch.banded import core, twist
    from asvgp_tpu_torch.banded.twisted import split_point

    other, lib = other_library(root)
    kuu, tanb, p, b = bands
    k, m = kuu.shape[0] - 1, kuu.shape[1]
    ws = ("asvgp_tan_workspace", (k, m))
    theirs3 = [torch.empty_like(t) for t in mine3]
    call(other, lib, "asvgp_chol_pair_solve_tan", k, m, *bands, *theirs3, ws_of=ws)
    c = FIRST[0]
    inside = (torch.arange(k + 1)[:, None] + torch.arange(c)[None] < c).to(dev)
    out = {"k3": all(torch.equal(a[:, :c][inside], t[:, :c][inside]) if i in (0, 1, 4)
                     else torch.equal(a[..., :c], t[..., :c])
                     for i, (a, t) in enumerate(zip(mine3, theirs3)))}
    theirs4 = [torch.empty_like(t) for t in mine4]
    call(other, lib, "asvgp_tak_pair_solve_tan", k, m, *mine3, *theirs4, ws_of=ws)
    c = FIRST[1]
    out["k4"] = all(torch.equal(a[..., m - c:], t[..., m - c:]) for a, t in zip(mine4, theirs4))
    # the kernels whose shared code moved, whole
    ws1 = ("asvgp_core_workspace", (k, m))
    k1 = core.chol_pair_solve(kuu, p, b)
    theirs1 = [torch.empty_like(t) for t in k1]
    call(other, lib, "asvgp_chol_pair_solve", k, m, kuu, p, b, *theirs1, ws_of=ws1)
    k2 = core.tak_pair_solve(*k1)
    theirs2 = [torch.empty_like(t) for t in k2]
    call(other, lib, "asvgp_tak_pair_solve", k, m, *k1, *theirs2, ws_of=ws1)
    out["k1_whole"] = all(torch.equal(a, t) for a, t in zip(k1, theirs1))
    out["k2_whole"] = all(torch.equal(a, t) for a, t in zip(k2, theirs2))
    h = split_point(m, k)
    ws5 = ("asvgp_twist_workspace", (k, m))
    k5 = twist.chol_quad_solve_tan(*bands)
    theirs5 = [torch.empty_like(t) for t in k5]
    call(other, lib, "asvgp_chol_quad_solve_tan", k, m, h, *bands, *theirs5, ws_of=ws5)
    out["k5_whole"] = all(torch.equal(a, t) for a, t in zip(k5, theirs5))
    _, z, x2, _ = twist.mid_step(*bands, k5[0], k5[1], k5[4])
    z, x2 = z.contiguous(), x2.contiguous()
    k6 = twist.tak_quad_solve_tan(*k5, z, x2, m)
    theirs6 = [torch.empty_like(t) for t in k6]
    call(other, lib, "asvgp_tak_quad_solve_tan", k, m, h, *k5, z, x2, *theirs6, ws_of=ws5)
    out["k6_whole"] = all(torch.equal(a, t) for a, t in zip(k6, theirs6))
    core.reset_counters()
    return out


def main() -> None:
    root = sys.argv[1]
    sys.path.insert(0, root)
    import torch

    from asvgp_tpu_torch.banded import _build, tan

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    _build.NVCC_FLAGS = (*_build.NVCC_FLAGS, *chunk_flags())
    build = _build.build()
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    sys.path.append(str(REPO))
    import chip_smoke as cs
    import numpy as np

    k, m = 3, 10_000
    rng = np.random.RandomState(0)
    host = [torch.as_tensor(a) for a in (cs.spd_band(k, m, rng), cs.sym_band(k, m, rng),
                                          cs.spd_band(k, m, rng), rng.randn(m))]
    bands = [t.to(dev) for t in host]
    k3 = tan.chol_pair_solve_tan(*bands)
    want3 = tan.chol_pair_solve_tan_plain(*host)
    k4 = tan.tak_pair_solve_tan(*k3)
    want4 = tan.tak_pair_solve_tan_plain(*(t.cpu() for t in k3))

    def rel(got, want):
        return max(float((g.cpu() - w).abs().max() / w.abs().max()) for g, w in zip(got, want))

    out = {"root": root, "card": card.strip(), "build_s": build["seconds"], "k": k, "m": m,
           "schur_chunk": arg("--schur-chunk"), "tak_chunk": arg("--tak-chunk")}
    for name, fn, got, want in (
            ("chol_pair_solve_tan", lambda: tan.chol_pair_solve_tan(*bands), k3, want3),
            ("tak_pair_solve_tan", lambda: tan.tak_pair_solve_tan(*k3), k4, want4),
            ("k3_k4", lambda: tan.factor_takahashi_solve_tan(*bands), None, None)):
        by_kernel = device_ms(fn)
        out[name] = {"event_ms": event_ms(fn), "device_ms": sum(by_kernel.values()),
                     "by_kernel": by_kernel}
        if got is not None:
            out[name]["rel"] = rel(got, want)
    if arg("--first-chunk"):
        out["first_chunk_equal"] = first_chunk_vs(arg("--first-chunk"), dev, bands, k3, k4)
    if "--steps" in sys.argv:
        out |= steps(dev)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
