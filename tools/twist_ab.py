"""The twisted tangent sweeps K5 and K6 and the mid step between them
(banded/twist.py) of one checkout of the port on the card, for comparing
two versions in one call.

Imports ``asvgp_tpu_torch`` from ROOT (a checkout's root, e.g. an earlier
commit unpacked with ``git archive`` into a directory that .gitignore
lists), builds its kernels there, holds K5 and K6 against their plain
versions on a random SPD Kuu and P, a random symmetric tangent band and a
random b (``chip_smoke.py``'s generators; k = 3, m = 10⁴) and times K5,
the mid step and K6: CUDA events
(median of 50 after a warm-up) and device time by kernel (torch.profiler,
20 calls).  Options:

  --steps            also the paths that run them at the north star
                     (``chip_smoke.py``'s data and model): the twisted
                     value-and-grad step (CUDA events, median of 10, and
                     its device time) and ``fit_lbfgs`` (max_iters=10,
                     curv_rtol=10, as phase 5 runs it; ms per iteration on
                     the host clock, median of 3 fits after a warm-up);
  --first-chunk DIR  build the kernels of the checkout at DIR too (its
                     ``banded/_build.py`` loaded on its own), run its K5
                     and K6 and say whether the first chunk of each stream
                     (its first 64 columns: K5's from the ends, K6's next
                     to the middle block) equals, bit for bit, this
                     checkout's on the same inputs; and whether K3, K4, K9,
                     K11, K15, K17 and K19 (whose code moved or gained role
                     flags) equal DIR's whole;
  --schur-chunk N    build with the Cholesky sweeps' chunks at least N
                     columns (``ASVGP_SCHUR_CHUNK``: K5, and K9, K15, K17);
  --tak-chunk N      build with K6's chunks at least N columns
                     (``ASVGP_TAK_QUAD_CHUNK``).

Needs an NVIDIA GPU and nvcc; run from the repository root, the versions
in turns:

    python tools/twist_ab.py build/parent --steps
    python tools/twist_ab.py . --steps --first-chunk build/parent

Prints one JSON object.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

from solve_ab import device_ms, event_ms

REPO = Path(__file__).resolve().parents[1]
FIRST = 64  # columns of the smallest chunk


def arg(name: str):
    return sys.argv[sys.argv.index(name) + 1] if name in sys.argv else None


def steps(dev) -> dict:
    """The twisted value-and-grad step and the north-star fit."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from asvgp_tpu_torch.train import fit_lbfgs

    x, y = cs.bench_data(cs.N, cs.SEED)
    x_d, y_d = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
    model = cs.make_model(x_d, y_d, cs.M, dev)
    step = lambda: cs.value_and_grad(model)  # noqa: E731
    out = {"value_and_grad_ms": event_ms(step, reps=10),
           "value_and_grad_device_ms": sum(device_ms(step, 5).values())}
    start = model.params()
    per_iter = []
    for _ in range(4):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        _, loss, iters = fit_lbfgs(model.training_loss, start, max_iters=10, curv_rtol=10.0)
        torch.cuda.synchronize(dev)
        per_iter.append((time.perf_counter() - t0) * 1e3 / iters)
    out |= {"fit_ms_per_iter": float(np.median(per_iter[1:])), "fit_iters": iters,
            "fit_loss": float(loss)}
    return out


def chunk_flags() -> tuple:
    """The nvcc flags of --schur-chunk and --tak-chunk."""
    flags = ()
    for opt, macro in (("--schur-chunk", "ASVGP_SCHUR_CHUNK"),
                       ("--tak-chunk", "ASVGP_TAK_QUAD_CHUNK")):
        if arg(opt):
            flags += (f"-D{macro}={int(arg(opt))}",)
    return flags


def other_library(root: str):
    """The kernels' library of the checkout at ``root``, built there, with
    its entry points declared; and its ENTRY_POINTS."""
    path = Path(root).resolve() / "asvgp_tpu_torch" / "banded" / "_build.py"
    spec = importlib.util.spec_from_file_location("other_build", path)
    other = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other)
    other.NVCC_FLAGS = (*other.NVCC_FLAGS, *chunk_flags())
    other.build()
    return other, other.load()


def call(other, lib, entry: str, k: int, m: int, *ints_and_tensors, ws_of=None):
    """Call ``entry`` of the other library: ints, then tensors' pointers,
    then a workspace (when its entry point takes one: ``ws_of`` names the
    library's workspace function and its arguments), then the stream."""
    import torch

    ints = [v for v in ints_and_tensors if isinstance(v, int)]
    ptrs = [t.data_ptr() for t in ints_and_tensors if not isinstance(t, int)]
    n_args = len(other.ENTRY_POINTS[entry])
    keep = None
    if n_args == len(ints) + 2 + len(ptrs) + 2:  # k, ..., a workspace, the stream
        fn, fargs = ws_of
        keep = torch.empty(max(1, getattr(lib, fn)(*fargs)), dtype=torch.float64, device="cuda")
        ptrs.append(keep.data_ptr())
    rc = getattr(lib, entry)(k, m, *ints, *ptrs, torch.cuda.current_stream().cuda_stream)
    other.check(lib, rc, entry)
    torch.cuda.synchronize()


def first_chunk_vs(root: str, dev, kuu, tanb, p, b, mine5, z, x2, mine6) -> dict:
    """This checkout's K5 and K6 outputs (``mine5``, ``mine6``) against the
    other checkout's on the same inputs: each stream's first FIRST columns
    bit for bit; then K3/K4 and the single-matrix forward sweeps whole."""
    import torch

    from asvgp_tpu_torch.banded import core, ops, single, tan
    from asvgp_tpu_torch.banded.twisted import split_point

    other, lib = other_library(root)
    k, m = kuu.shape[0] - 1, kuu.shape[1]
    h = split_point(m, k)
    g = m - h - k
    c = min(FIRST, g)
    ws5 = ("asvgp_twist_workspace", (k, m))
    theirs5 = [torch.empty_like(t) for t in mine5]
    call(other, lib, "asvgp_chol_quad_solve_tan", k, m, h, kuu, tanb, p, b, *theirs5, ws_of=ws5)
    out = {"k5": all(torch.equal(a[..., :c], t[..., :c]) for a, t in zip(mine5, theirs5))}
    theirs6 = [torch.empty_like(t) for t in mine6]
    call(other, lib, "asvgp_tak_quad_solve_tan", k, m, h, *mine5, z, x2, *theirs6, ws_of=ws5)
    # F's chunk next to the middle, and the middle: band columns h-c..h+k-1
    # (R's first chunk writes the middle columns' entries below the dense
    # block) and u there; R's: its columns g-c..g-1, band column m-1-j-r
    # of row r, so band columns m-g..m-g+c-1-k and u[m-g..m-g+c-1]
    f = slice(h - c, h + k)
    r = slice(m - g, m - g + c - k)
    bands = ((mine6[0], theirs6[0]), (mine6[1], theirs6[1]), (mine6[3], theirs6[3]))
    out["k6"] = (all(torch.equal(a[:, f], t[:, f]) and torch.equal(a[:, r], t[:, r])
                     for a, t in bands)
                 and torch.equal(mine6[2][h - c: m - g + c], theirs6[2][h - c: m - g + c]))
    # the kernels whose code moved or gained role flags, whole
    k3 = tan.chol_pair_solve_tan(kuu, tanb, p, b)
    theirs3 = [torch.empty_like(t) for t in k3]
    call(other, lib, "asvgp_chol_pair_solve_tan", k, m, kuu, tanb, p, b, *theirs3)
    out["k3_whole"] = all(torch.equal(a, t) for a, t in zip(k3, theirs3))
    k4 = tan.tak_pair_solve_tan(*k3)
    theirs4 = [torch.empty_like(t) for t in k4]
    call(other, lib, "asvgp_tak_pair_solve_tan", k, m, *k3, *theirs4)
    out["k4_whole"] = all(torch.equal(a, t) for a, t in zip(k4, theirs4))
    l = ops.cholesky_band_plain(kuu.cpu()).to(dev)
    for name, fn, entry, band, nb, wsfn in (
            ("chol_fwd", single.chol_fwd, "asvgp_chol_fwd", kuu, 1, "asvgp_schur_workspace"),
            ("tak_fwd", single.tak_fwd, "asvgp_tak_fwd", l, 1, "asvgp_carry_workspace"),
            ("chol_fwd_f32", single.chol_fwd, "asvgp_chol_fwd_f32", kuu.float(), 1,
             "asvgp_schur_workspace"),
            ("tak_fwd_f32", single.tak_fwd, "asvgp_tak_fwd_f32", l.float(), 1,
             "asvgp_carry_workspace"),
            ("chol_fwd_pair", lambda a: torch.stack(single.chol_fwd_pair(a[0], a[1])),
             "asvgp_chol_fwd", torch.stack([kuu, p]), 2, "asvgp_schur_workspace")):
        mine = fn(band)
        theirs = torch.empty_like(band)
        call(other, lib, entry, k, m, nb, band, theirs, ws_of=(wsfn, (k, m, nb)))
        out[f"{name}_whole"] = bool(torch.equal(mine, theirs))
    core.reset_counters()
    return out


def main() -> None:
    root = sys.argv[1]
    sys.path.insert(0, root)
    import torch

    from asvgp_tpu_torch.banded import _build, twist

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
    kuu, tanb, p, b = (t.to(dev) for t in host)
    k5 = twist.chol_quad_solve_tan(kuu, tanb, p, b)
    want5 = twist.chol_quad_solve_tan_plain(*host)
    _, z, x2, _ = twist.mid_step(kuu, tanb, p, b, k5[0], k5[1], k5[4])
    z, x2 = z.contiguous(), x2.contiguous()
    k6 = twist.tak_quad_solve_tan(*k5, z, x2, m)
    want6 = twist.tak_quad_solve_tan_plain(*(t.cpu() for t in k5), z.cpu(), x2.cpu(), m)

    def rel(got, want):
        return max(float((g.cpu() - w).abs().max() / w.abs().max()) for g, w in zip(got, want))

    out = {"root": root, "card": card.strip(), "build_s": build["seconds"], "k": k, "m": m,
           "schur_chunk": arg("--schur-chunk"), "tak_chunk": arg("--tak-chunk")}
    for name, fn, got, want in (
            ("chol_quad_solve_tan", lambda: twist.chol_quad_solve_tan(kuu, tanb, p, b), k5, want5),
            ("mid_step", lambda: twist.mid_step(kuu, tanb, p, b, k5[0], k5[1], k5[4]), None, None),
            ("tak_quad_solve_tan", lambda: twist.tak_quad_solve_tan(*k5, z, x2, m), k6, want6),
            ("k5_mid_k6", lambda: twist.factor_takahashi_solve_tan_twist(kuu, tanb, p, b), None,
             None)):
        by_kernel = device_ms(fn)
        out[name] = {"event_ms": event_ms(fn), "device_ms": sum(by_kernel.values()),
                     "by_kernel": by_kernel}
        if got is not None:
            out[name]["rel"] = rel(got, want)
    if arg("--first-chunk"):
        out["first_chunk_equal"] = first_chunk_vs(arg("--first-chunk"), dev, kuu, tanb, p, b,
                                                  k5, z, x2, k6)
    if "--steps" in sys.argv:
        out |= steps(dev)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
