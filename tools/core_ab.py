"""The serving sweeps K1 and K2 (banded/core.py) of one checkout of the port
on the card, for comparing two versions in one call.

Imports ``asvgp_tpu_torch`` from ROOT (a checkout's root, e.g. an earlier
commit unpacked with ``git archive`` into a directory that .gitignore
lists), builds its kernels there, holds K1 and K2 against their plain
versions on a random SPD Kuu and P and a random b (``chip_smoke.py``'s
generators; k = 3, m = 10⁴) and times K1, K2 and the two together: CUDA
events (median of 50 after a warm-up) and device time by kernel
(torch.profiler, 20 calls).  Options:

  --steps            also the stages that run them at the north star
                     (``chip_smoke.py``'s data and model): the float64
                     posterior and the value-only ELBO (CUDA events, median
                     of 50, and device time), and a step of
                     ``fit_adam_minibatch`` (batch 4096, 20 steps on
                     ``chip_smoke.py``'s index stream; ms per step on the
                     host clock, median and each of 7 fits after a
                     warm-up; and one fit under torch.profiler: device
                     time, kernels and host time per step, the six
                     costliest kernels);
  --first-chunk DIR  build the kernels of the checkout at DIR too (its
                     ``banded/_build.py`` loaded on its own), run its K1
                     and K2 and say whether the first chunk of each walk
                     (K1's first 128 columns, K2's last 64) equals, bit for
                     bit, this checkout's on the same inputs; and whether
                     K5, K6, K9, K11, K15, K17 and K19 (whose code moved)
                     equal DIR's whole.

Needs an NVIDIA GPU and nvcc; run from the repository root, the versions
in turns:

    python tools/core_ab.py build/parent --steps
    python tools/core_ab.py . --steps --first-chunk build/parent

Prints one JSON object.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

from solve_ab import device_ms, event_ms
from twist_ab import arg, call, other_library

REPO = Path(__file__).resolve().parents[1]
FIRST = (128, 64)  # K1's and K2's smallest chunks
ADAM_FITS = 7  # timed fits of --steps, after a warm-up


def steps(dev) -> dict:
    """The float64 posterior, the value-only ELBO and an Adam step."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from asvgp_tpu_torch.basis import B3Spline
    from asvgp_tpu_torch.models import Matern32
    from asvgp_tpu_torch.models.gpr1d import default_params
    from asvgp_tpu_torch.train import fit_adam_minibatch

    x, y = cs.bench_data(cs.N, cs.SEED)
    x_d, y_d = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
    model = cs.make_model(x_d, y_d, cs.M, dev)

    def elbo_value():
        with torch.no_grad():
            model.training_loss()

    out = {}
    for name, fn in (("posterior", model.posterior), ("elbo_value", elbo_value)):
        out[f"{name}_ms"] = event_ms(fn)
        out[f"{name}_device_ms"] = sum(device_ms(fn).values())
    basis = B3Spline(0.0, 1.0, cs.M)
    params0 = default_params(Matern32(variance=1.0, lengthscales=1e-3), 0.1)
    idx = cs.index_stream(cs.ADAM_INDEX_SEED, cs.ADAM_STEPS, cs.ADAM_BATCH, cs.N)

    def fit():
        fit_adam_minibatch(basis, 3, x_d, y_d, params0, batch_size=cs.ADAM_BATCH,
                           steps=cs.ADAM_STEPS, learning_rate=cs.ADAM_LR, indices=idx)

    per_step = []
    for _ in range(ADAM_FITS + 1):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fit()
        torch.cuda.synchronize(dev)
        per_step.append((time.perf_counter() - t0) * 1e3 / cs.ADAM_STEPS)
    out["adam_ms_per_step"] = float(np.median(per_step[1:]))
    out["adam_ms_per_step_each"] = per_step[1:]
    out["adam_trace"] = adam_trace(fit, cs.ADAM_STEPS)
    return out


def adam_trace(fit, steps: int) -> dict:
    """One Adam fit under torch.profiler, per step: the device time and the
    kernels launched, the host time of the fit's own CPU operations, the
    wall time under the profiler, and the six kernels that take the most
    device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fit()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fit()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    gpu = [e for e in events if e.device_type == DeviceType.CUDA]
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    top = sorted(gpu, key=lambda e: -e.self_device_time_total)[:6]
    return {"wall_ms": wall / steps,
            "device_ms": sum(e.self_device_time_total for e in gpu) / 1e3 / steps,
            "kernels": sum(e.count for e in gpu) / steps,
            "cpu_self_ms": sum(e.self_cpu_time_total for e in cpu) / 1e3 / steps,
            "top": {e.key[:60]: [e.self_device_time_total / 1e3 / steps, e.count / steps]
                    for e in top}}


def first_chunk_vs(root: str, dev, kuu, p, b, mine1, mine2) -> dict:
    """This checkout's K1 and K2 outputs (``mine1``, ``mine2``) against the
    other checkout's on the same inputs: each walk's first chunk bit for
    bit; then K5, K6 and the single-matrix forward sweeps whole."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from asvgp_tpu_torch.banded import core, ops, single, twist
    from asvgp_tpu_torch.banded.twisted import split_point

    other, lib = other_library(root)
    k, m = kuu.shape[0] - 1, kuu.shape[1]
    ws = ("asvgp_core_workspace", (k, m))
    theirs1 = [torch.empty_like(t) for t in mine1]
    call(other, lib, "asvgp_chol_pair_solve", k, m, kuu, p, b, *theirs1, ws_of=ws)
    c = FIRST[0]
    inside = (torch.arange(k + 1)[:, None] + torch.arange(c)[None] < c).to(dev)
    out = {"k1": all(torch.equal(a[:, :c][inside], t[:, :c][inside])
                     for a, t in zip(mine1[:2], theirs1[:2]))
           and all(torch.equal(a[..., :c], t[..., :c]) for a, t in zip(mine1[2:], theirs1[2:]))}
    theirs2 = [torch.empty_like(t) for t in mine2]
    call(other, lib, "asvgp_tak_pair_solve", k, m, *mine1, *theirs2, ws_of=ws)
    c = FIRST[1]
    out["k2"] = all(torch.equal(a[..., m - c:], t[..., m - c:]) for a, t in zip(mine2, theirs2))
    # the kernels whose code moved, whole
    tanb = torch.as_tensor(cs.sym_band(k, m, np.random.RandomState(1)), device=dev)
    h = split_point(m, k)
    ws5 = ("asvgp_twist_workspace", (k, m))
    k5 = twist.chol_quad_solve_tan(kuu, tanb, p, b)
    theirs5 = [torch.empty_like(t) for t in k5]
    call(other, lib, "asvgp_chol_quad_solve_tan", k, m, h, kuu, tanb, p, b, *theirs5, ws_of=ws5)
    out["k5_whole"] = all(torch.equal(a, t) for a, t in zip(k5, theirs5))
    _, z, x2, _ = twist.mid_step(kuu, tanb, p, b, k5[0], k5[1], k5[4])
    z, x2 = z.contiguous(), x2.contiguous()
    k6 = twist.tak_quad_solve_tan(*k5, z, x2, m)
    theirs6 = [torch.empty_like(t) for t in k6]
    call(other, lib, "asvgp_tak_quad_solve_tan", k, m, h, *k5, z, x2, *theirs6, ws_of=ws5)
    out["k6_whole"] = all(torch.equal(a, t) for a, t in zip(k6, theirs6))
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

    from asvgp_tpu_torch.banded import _build, core

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    build = _build.build()
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    sys.path.append(str(REPO))
    import chip_smoke as cs
    import numpy as np

    k, m = 3, 10_000
    rng = np.random.RandomState(0)
    host = [torch.as_tensor(a) for a in (cs.spd_band(k, m, rng), cs.spd_band(k, m, rng),
                                          rng.randn(m))]
    kuu, p, b = (t.to(dev) for t in host)
    k1 = core.chol_pair_solve(kuu, p, b)
    want1 = core.chol_pair_solve_plain(*host)
    k2 = core.tak_pair_solve(*k1)
    want2 = core.tak_pair_solve_plain(*(t.cpu() for t in k1))

    def rel(got, want):
        return max(float((g.cpu() - w).abs().max() / w.abs().max()) for g, w in zip(got, want))

    out = {"root": root, "card": card.strip(), "build_s": build["seconds"], "k": k, "m": m}
    for name, fn, got, want in (
            ("chol_pair_solve", lambda: core.chol_pair_solve(kuu, p, b), k1, want1),
            ("tak_pair_solve", lambda: core.tak_pair_solve(*k1), k2, want2),
            ("factor_takahashi_solve", lambda: core.factor_takahashi_solve(kuu, p, b), None,
             None)):
        by_kernel = device_ms(fn)
        out[name] = {"event_ms": event_ms(fn), "device_ms": sum(by_kernel.values()),
                     "by_kernel": by_kernel}
        if got is not None:
            out[name]["rel"] = rel(got, want)
    if arg("--first-chunk"):
        out["first_chunk_equal"] = first_chunk_vs(arg("--first-chunk"), dev, kuu, p, b, k1, k2)
    if "--steps" in sys.argv:
        out |= steps(dev)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
