"""The forward banded sweeps (K9, K11, K15, K17, K19) of one checkout of the
port on the card, for comparing two versions in one call.

Imports ``asvgp_tpu_torch`` from ROOT (a checkout's root, e.g. an earlier
commit unpacked with ``git archive`` into a directory that .gitignore
lists), builds its kernels there, holds each sweep against its plain
version on a random SPD band (k = 3, m = 10⁴; K15 on two) and times it:
CUDA events (median of 50 after a warm-up) and device time by kernel
(torch.profiler, 20 calls).  Options:

  --steps            also the paths that run them at the north star
                     (``chip_smoke.py``'s data and models): one SVGP step
                     (batch 100, from the seeded C*; K9 ×4, K11 ×3), one
                     SVGP prediction on 10⁵ points (K9 ×2, K11 ×2), one
                     float32 GPR1D value-and-grad step (K17 ×2, K19) and
                     its posterior (K17 ×2, K19 ×2), each by CUDA events
                     (median of 10) and its device time;
  --first-chunk DIR  build the kernels of the checkout at DIR too (its
                     ``banded/_build.py`` loaded on its own) and say whether
                     the first 64 columns of each sweep's walk (where its
                     first chunk runs the one-chain recursion) equal, bit
                     for bit, those of DIR's kernels on the same inputs;
  --schur-chunk N    build with the Cholesky sweep's chunks at least N
                     columns (``ASVGP_SCHUR_CHUNK``), to measure the length.

Needs an NVIDIA GPU and nvcc; run from the repository root, the versions
in turns:

    python tools/forward_ab.py build/parent --steps
    python tools/forward_ab.py . --steps --first-chunk build/parent

Prints one JSON object.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

from solve_ab import device_ms, event_ms

REPO = Path(__file__).resolve().parents[1]
FIRST = 64  # columns of the smallest chunk


def arg(name: str):
    return sys.argv[sys.argv.index(name) + 1] if name in sys.argv else None


def steps(dev) -> dict:
    """The four paths that run the forward sweeps, at the north star."""
    import torch

    sys.path.append(str(REPO))
    import chip_smoke as cs
    from asvgp_tpu_torch.basis import B3Spline
    from asvgp_tpu_torch.models import Matern32, SVGP1D, fit_svgp

    x, y = cs.bench_data(cs.N, cs.SEED)
    x_d, y_d = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
    xt = torch.as_tensor(cs.bench_data(cs.N_TEST, cs.TEST_SEED)[0], device=dev)
    svgp = SVGP1D(Matern32(variance=1.0, lengthscales=1e-3), B3Spline(0.0, 1.0, cs.M),
                  noise_variance=0.1, num_data=cs.N, device=dev)
    seeded, _ = fit_svgp(svgp, x_d, y_d, svgp.init_params(), steps=0,
                         batch_size=cs.SVGP_BATCH, device=dev)
    idx = torch.as_tensor(cs.index_stream(cs.SVGP_INDEX_SEED, 1, cs.SVGP_BATCH, cs.N)[0],
                          device=dev)
    p = {g: ({k: v.clone().requires_grad_() for k, v in d.items()} if isinstance(d, dict)
             else d.clone().requires_grad_()) for g, d in seeded.items()}

    def svgp_step():
        svgp.training_loss(x_d[idx], y_d[idx], p).backward()

    def svgp_predict():
        with torch.no_grad():
            svgp.predict_f(xt, params=seeded)

    f32 = cs.make_model(x_d, y_d, cs.M, dev, dtype=torch.float32)

    def f32_posterior():
        with torch.no_grad():
            f32.posterior()

    out = {}
    for name, fn in (("svgp_step", svgp_step), ("svgp_predict", svgp_predict),
                     ("f32_value_and_grad", lambda: cs.value_and_grad(f32)),
                     ("f32_posterior", f32_posterior)):
        out[f"{name}_ms"] = event_ms(fn, reps=10)
        out[f"{name}_device_ms"] = sum(device_ms(fn, 5).values())
    return out


def first_chunk_vs(other_root: str, cases: dict, dev) -> dict:
    """Each case's first FIRST columns of its walk, by this checkout's
    kernel and by ``other_root``'s (its ``_build.py`` loaded on its own and
    its C entry points called directly, with a workspace when they take
    one), equal bit for bit?"""
    import torch

    path = Path(other_root).resolve() / "asvgp_tpu_torch" / "banded" / "_build.py"
    spec = importlib.util.spec_from_file_location("other_build", path)
    other = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other)
    other.build()
    lib = other.load()
    out = {}
    for name, (fn, _, args) in cases.items():
        chol = name.startswith("chol")
        band = torch.stack([t.to(dev) for t in args]).contiguous()
        nb, kp1, m = band.shape
        k = kp1 - 1
        entry = ("asvgp_chol_fwd" if chol else "asvgp_tak_fwd") + (
            "_f32" if band.dtype == torch.float32 else "")
        res = torch.empty_like(band)
        ptrs = [band.data_ptr(), res.data_ptr()]
        if len(other.ENTRY_POINTS[entry]) == 7:  # a workspace pointer
            n = getattr(lib, "asvgp_schur_workspace" if chol else "asvgp_carry_workspace")(
                k, m, nb)
            ws = band.new_empty(n)
            ptrs.append(ws.data_ptr())
        rc = getattr(lib, entry)(k, m, nb, *ptrs, torch.cuda.current_stream().cuda_stream)
        other.check(lib, rc, entry)
        mine = fn(*[t.to(dev) for t in args])
        mine = torch.stack(mine) if isinstance(mine, tuple) else mine[None]
        cols = slice(0, FIRST) if chol else slice(m - FIRST, m)
        out[name] = bool(torch.equal(mine[..., cols], res[..., cols]))
    return out


def main() -> None:
    root = sys.argv[1]
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from asvgp_tpu_torch.banded import _build, ops, single

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    if arg("--schur-chunk"):
        _build.NVCC_FLAGS = (*_build.NVCC_FLAGS, f"-DASVGP_SCHUR_CHUNK={int(arg('--schur-chunk'))}")
    build = _build.build()
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    rng = np.random.RandomState(0)
    k, m = 3, 10_000
    a = []
    for _ in range(2):
        x = 0.3 * rng.randn(k + 1, m)
        x[0] = np.abs(x[0]) + 2 * k + 1
        for j in range(1, k + 1):
            x[j, m - j:] = 0
        a.append(torch.as_tensor(x))
    l = ops.cholesky_band_plain(a[0])
    f32 = torch.float32
    cases = {  # name: (wrapper, plain version, CPU arguments)
        "chol_fwd": (single.chol_fwd, single.chol_fwd_plain, (a[0],)),
        "tak_fwd": (single.tak_fwd, single.tak_fwd_plain, (l,)),
        "chol_fwd_f32": (single.chol_fwd, single.chol_fwd_plain, (a[0].to(f32),)),
        "tak_fwd_f32": (single.tak_fwd, single.tak_fwd_plain, (l.to(f32),)),
        "chol_fwd_pair": (single.chol_fwd_pair, single.chol_fwd_pair_plain, (a[0], a[1])),
    }
    out = {"root": root, "card": card.strip(), "build_s": build["seconds"], "k": k, "m": m,
           "schur_chunk": arg("--schur-chunk")}
    for name, (fn, plain, args) in cases.items():
        dargs = [t.to(dev).contiguous() for t in args]
        got, want = fn(*dargs), plain(*args)
        got, want = ((t,) if isinstance(t, torch.Tensor) else t for t in (got, want))
        by_kernel = device_ms(lambda: fn(*dargs))
        out[name] = {
            "rel": max(float((g.cpu() - w).abs().max() / w.abs().max())
                       for g, w in zip(got, want)),
            "event_ms": event_ms(lambda: fn(*dargs)),
            "device_ms": sum(by_kernel.values()),
            "by_kernel": by_kernel,
        }
    if arg("--first-chunk"):
        out["first_chunk_equal"] = first_chunk_vs(arg("--first-chunk"), cases, dev)
    if "--steps" in sys.argv:
        out |= steps(dev)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
