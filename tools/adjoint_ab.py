"""The banded Cholesky and Takahashi adjoints (K7, K8, K10, K12, K18, K20,
K23) of one checkout of the port on the card, for comparing two versions
in one call.

Imports ``asvgp_tpu_torch`` from ROOT (a checkout's root, e.g. an earlier
commit unpacked with ``git archive`` into a directory that .gitignore
lists), builds its kernels there, holds each adjoint against its plain
version on a random SPD band (k = 3, m = 10⁴; K23 and K8 also on two) and
times it: CUDA events (median of 50 after a warm-up) and device time by
kernel (torch.profiler, 20 calls).  With ``--steps`` also the steps that
run them at the north star (``chip_smoke.py``'s data and models): one SVGP
step (batch 100, from the seeded C*; K10 ×4, K12 ×3), one minibatch Adam
step (batch 4096; K7, K8) and one float32 GPR1D value-and-grad step (K18
×2, K20), each by CUDA events (median of 10) and its device time.  Needs an
NVIDIA GPU and nvcc; run from the repository root, the versions in turns:

    python tools/adjoint_ab.py build/parent --steps
    python tools/adjoint_ab.py . --steps

Prints one JSON object.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

from solve_ab import device_ms, event_ms

REPO = Path(__file__).resolve().parents[1]


def steps(dev) -> dict:
    """The three steps that run the adjoints, at the north star."""
    import torch

    sys.path.append(str(REPO))
    import chip_smoke as cs
    from asvgp_tpu_torch.basis import B3Spline
    from asvgp_tpu_torch.models import Matern32, SVGP1D, fit_svgp
    from asvgp_tpu_torch.models.gpr1d import default_params
    from asvgp_tpu_torch.train.adam import minibatch_loss

    x, y = cs.bench_data(cs.N, cs.SEED)
    x_d, y_d = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
    out = {}

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

    basis = B3Spline(0.0, 1.0, cs.M)
    params0 = default_params(Matern32(variance=1.0, lengthscales=1e-3), 0.1)
    pa = {g: {k: torch.tensor(float(v), dtype=torch.float64, device=dev, requires_grad=True)
              for k, v in d.items()} for g, d in params0.items()}
    ia = torch.as_tensor(cs.index_stream(cs.ADAM_INDEX_SEED, 1, cs.ADAM_BATCH, cs.N)[0],
                         device=dev)

    def adam_step():
        minibatch_loss(basis, 3, cs.N, pa, x_d[ia], y_d[ia]).backward()

    f32 = cs.make_model(x_d, y_d, cs.M, dev, dtype=torch.float32)
    for name, fn in (("svgp_step", svgp_step), ("adam_step", adam_step),
                     ("f32_value_and_grad", lambda: cs.value_and_grad(f32))):
        out[f"{name}_ms"] = event_ms(fn, reps=10)
        out[f"{name}_device_ms"] = sum(device_ms(fn, 5).values())
    return out


def main() -> None:
    root = sys.argv[1]
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from asvgp_tpu_torch.banded import _build, core, ops, single

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    build = _build.build()
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    rng = np.random.RandomState(0)
    k, m = 3, 10_000
    ls, ss = [], []
    for _ in range(2):
        a = 0.3 * rng.randn(k + 1, m)
        a[0] = np.abs(a[0]) + 2 * k + 1
        for j in range(1, k + 1):
            a[j, m - j:] = 0
        ls.append(ops.cholesky_band_plain(torch.as_tensor(a)))
        ss.append(ops.takahashi_inverse_band_plain(ls[-1]))
    l, s = torch.stack(ls), torch.stack(ss)
    cot = torch.as_tensor(rng.randn(2, k + 1, m))
    iv = (1.0 / l[:, 0]).contiguous()
    f32 = torch.float32
    cases = {  # name: (wrapper, plain version, CPU arguments)
        "chol_bwd": (single.chol_bwd, single.chol_bwd_plain, (l[0], cot[0])),
        "tak_bwd": (single.tak_bwd, single.tak_bwd_plain, (l[0], s[0], cot[0])),
        "chol_bwd_f32": (single.chol_bwd, single.chol_bwd_plain, (l[0].to(f32), cot[0].to(f32))),
        "tak_bwd_f32": (single.tak_bwd, single.tak_bwd_plain,
                        (l[0].to(f32), s[0].to(f32), cot[0].to(f32))),
        "tak_bwd_vec": (core.tak_bwd_vec, core.tak_bwd_vec_plain, (l[0], s[0], cot[0], iv[0])),
        "chol_bwd_pair": (core.chol_bwd_pair, core.chol_bwd_pair_plain, (l[0], cot[0])),
        "chol_bwd_pair_nb2": (core.chol_bwd_pair, core.chol_bwd_pair_plain, (l, cot)),
        "tak_bwd_pair": (core.tak_bwd_pair, core.tak_bwd_pair_plain, (l, s, cot, iv)),
    }
    out = {"root": root, "card": card.strip(), "build_s": build["seconds"], "k": k, "m": m}
    for name, (fn, plain, args) in cases.items():
        dargs = [t.to(dev).contiguous() for t in args]
        got = fn(*dargs).cpu()
        want = plain(*args)
        by_kernel = device_ms(lambda: fn(*dargs))
        out[name] = {
            "rel": float((got - want).abs().max() / want.abs().max()),
            "event_ms": event_ms(lambda: fn(*dargs)),
            "device_ms": sum(by_kernel.values()),
            "by_kernel": by_kernel,
        }
    if "--steps" in sys.argv:
        out |= steps(dev)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
