"""The float32 GPR1D at high κ(Kuu) three ways, on the CPU: the port's
float32 route with the card's partitioned K17/K19 (their numpy
emulations), the JAX package's float32 route (x64 off, scan) and its
float64 model, at m = 320, B3, Matérn-3/2, ℓ = (ℓ/δ)/m; each float32
route's distance from float64 in the loss, the gradient in the raw
parameters (lengthscale, variance, noise), the predictive variance on
held-out points and their NLPD (see tests/test_torch_f32_high_kappa.py,
which holds the same figures).

Run from the repository root (about 15 s a value):

    python tools/f32_high_kappa.py [ell_over_delta ...]     # default 100 10

Prints one JSON object.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from test_torch_f32_high_kappa import high_kappa  # noqa: E402


def main() -> None:
    ratios = [float(a) for a in sys.argv[1:]] or [100.0, 10.0]
    print(json.dumps({"runs": [high_kappa(r) for r in ratios]}))


if __name__ == "__main__":
    main()
