"""The four banded solves (K13, K14, K21, K22) of one checkout of the port on
the card, for comparing two versions in one call.

Imports ``asvgp_tpu_torch`` from ROOT (a checkout's root, e.g. an earlier
commit unpacked with ``git archive`` into a directory that .gitignore
lists), builds its kernels there, holds each solve against its plain
version on a random SPD band (k = 3, m = 10⁴, a vector) and times it: CUDA
events (median of 50 after a warm-up) and device time by kernel
(torch.profiler, 20 calls), beside ``torch.linalg.solve_triangular`` on the
dense factor and ``banded.cholesky_solve_band`` in both dtypes.  With
``--steps`` also the float32 GPR1D at the north star (``chip_smoke.py``'s
data and model): one value-and-grad step and the posterior (events,
median of 10) and the step's device time.  Needs an NVIDIA GPU and nvcc;
run from the repository root, the versions in turns:

    python tools/solve_ab.py build/parent --steps
    python tools/solve_ab.py . --steps

Prints one JSON object.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def event_ms(fn, reps: int = 50) -> float:
    import numpy as np
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end))
    return float(np.median(ts))


def device_ms(fn, reps: int = 20) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return {e.key[:70]: e.self_device_time_total / 1e3 / reps for e in events}


def main() -> None:
    root = sys.argv[1]
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from asvgp_tpu_torch import banded
    from asvgp_tpu_torch.banded import _build, ops, solve

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    build = _build.build()
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    rng = np.random.RandomState(0)
    k, m = 3, 10_000
    a = 0.3 * rng.randn(k + 1, m)
    a[0] = np.abs(a[0]) + 2 * k + 1
    for j in range(1, k + 1):
        a[j, m - j:] = 0
    l = ops.cholesky_band_plain(torch.as_tensor(a))
    b = torch.as_tensor(rng.randn(m))
    out = {"root": root, "card": card.strip(), "build_s": build["seconds"]}
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).removeprefix("torch.")
        ld, bd = l.to(dev, dtype), b.to(dev, dtype)
        dense = banded.lower_band_to_dense(ld)
        for name, fn, plain, lhs, upper in (
                ("lower", solve.solve_lower, solve.solve_lower_plain, dense, False),
                ("upper_t", solve.solve_upper_t, solve.solve_upper_t_plain, dense.mT, True)):
            got = fn(ld, bd).cpu()
            want = plain(l.to(dtype), b.to(dtype))
            by_kernel = device_ms(lambda: fn(ld, bd))
            out[f"{name}_{tag}"] = {
                "rel": float((got - want).abs().max() / want.abs().max()),
                "event_ms": event_ms(lambda: fn(ld, bd)),
                "device_ms": sum(by_kernel.values()),
                "by_kernel": by_kernel,
                "solve_triangular_ms": event_ms(
                    lambda: torch.linalg.solve_triangular(lhs, bd[:, None], upper=upper)),
            }
        out[f"cholesky_solve_band_{tag}_ms"] = event_ms(
            lambda: banded.cholesky_solve_band(ld, bd))
    if "--steps" in sys.argv:
        sys.path.append(str(REPO))
        import chip_smoke as cs

        x, y = cs.bench_data(cs.N, cs.SEED)
        model = cs.make_model(torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev),
                              cs.M, dev, dtype=torch.float32)
        out["f32_value_and_grad_ms"] = event_ms(lambda: cs.value_and_grad(model), reps=10)
        out["f32_posterior_ms"] = event_ms(model.posterior, reps=10)
        out["f32_step_device_ms"] = sum(device_ms(lambda: cs.value_and_grad(model), 5).values())
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
