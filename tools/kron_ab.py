"""GPRKron's stages at the eNATL60 protocol's shape (D = 2) for one checkout
of the port on the card, for comparing two versions in one call.

Imports ``asvgp_tpu_torch`` from ROOT (a checkout's root, e.g. an earlier
commit unpacked with ``git archive`` into a directory that .gitignore
lists), builds its kernels there and runs ``chip_smoke.py``'s Kron model at
its initial parameters: 2·10⁶ points of experiments/spatial_2d/
ocean_ssh.py's field, 2 × B4 of m = 100, Matérn-3/2 at ℓ = 0.1, noise 0.1.
It times the statistics build, the value-and-grad step, its backward, the
posterior and predict on 10⁵ points in batches of 30 000 (CUDA events,
median of REPS after a warm-up) and profiles the step (``chip_smoke.py``'s
``device_profile``: device time, device operations, busy share).  Only the
public surface that both versions have is used.

Needs an NVIDIA GPU and nvcc; run from the repository root, the versions
in turns:

    python tools/kron_ab.py build/parent
    python tools/kron_ab.py .

Prints one JSON object.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main() -> None:
    root = sys.argv[1]
    sys.path.insert(0, root)
    import torch

    from asvgp_tpu_torch.banded import _build
    from asvgp_tpu_torch.basis import BSplineBasis
    from asvgp_tpu_torch.models import GPRKron, Matern32
    from asvgp_tpu_torch.stats import compute_kron_stats

    sys.path.append(str(REPO))
    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("kron_ab: needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    device = torch.device("cuda", 0)
    _build.build()
    X, y = cs.synthetic_ssh(cs.N_KRON + cs.N_KRON_TEST)
    xtr, ytr, xte = X[cs.N_KRON_TEST:], y[cs.N_KRON_TEST:], X[:cs.N_KRON_TEST]
    bases = [BSplineBasis(0.0, 1.0, cs.KRON_M, cs.KRON_ORDER)] * 2
    kernels = [Matern32(lengthscales=cs.KRON_ELL), Matern32(lengthscales=cs.KRON_ELL)]
    model = GPRKron((xtr, ytr), kernels, bases, noise_variance=cs.KRON_NOISE, device=device)
    xtr_d = torch.as_tensor(xtr, device=device)
    ytr_d = torch.as_tensor(ytr, device=device)
    xte_d = torch.as_tensor(xte, device=device)
    post = model.posterior()
    times = {
        "stats_build": cs.cuda_ms(lambda: compute_kron_stats(bases, xtr_d, ytr_d)),
        "value_and_grad": cs.cuda_ms(lambda: cs.per_dim_value_and_grad(model)),
        "backward": cs.backward_ms(model),
        "posterior": cs.cuda_ms(lambda: model.posterior()),
        "predict_1e5": cs.cuda_ms(lambda: post.predict_f(xte_d, batch=cs.PREDICT_BATCH)),
    }
    profile = cs.device_profile(lambda: cs.per_dim_value_and_grad(model))
    print(json.dumps({
        "root": root, "card": smi, "loss": cs.per_dim_value_and_grad(model)[0],
        "median_ms": {name: t["median_ms"] for name, t in times.items()},
        "ms": {name: t["ms"] for name, t in times.items()},
        "step_profile": {k: v for k, v in profile.items() if k != "top"},
    }), flush=True)


if __name__ == "__main__":
    main()
