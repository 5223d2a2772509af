"""Reference values of GPRKron at the eNATL60 protocol's shape, from the JAX
package on a CPU in float64 (lax.scan recursions).

The PyTorch port's ``chip_smoke.py`` holds its GPRKron run on the GPU to
these numbers: the protocol of experiments/spatial_2d/ocean_ssh.py with
nothing cut but the iteration count (synthetic_ssh(2_000_000 + 100_000),
seed 1997, the first 10⁵ points held out, 2 × BSplineBasis(0, 1, 100, 4),
2 × Matern32(lengthscales=0.1), noise 0.1), its statistics summarised as
``stat_summary`` does, the training loss and its gradient at the initial
parameters, ``fit_lbfgs(max_iters=10, curv_rtol=10.0)`` and the MSE and
NLPD of the fitted posterior on the held-out points.

Run from the repository root (about 10 GB of memory, a few minutes):

    python tools/kron_anchors.py [--n 2000000] [--n-test 100000]

Prints one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from asvgp_tpu.banded import ops  # noqa: E402
from asvgp_tpu.basis import BSplineBasis  # noqa: E402
from asvgp_tpu.models import Matern32  # noqa: E402
from asvgp_tpu.models.kron import GPRKron  # noqa: E402
from asvgp_tpu.train import fit_lbfgs, mse, nlpd  # noqa: E402

SUMMARY_SEED = 7


def synthetic_ssh(n, seed=1997):
    """experiments/spatial_2d/ocean_ssh.py's field (that module configures
    caches on import, so the generator is repeated here)."""
    rng = np.random.RandomState(seed)
    X = rng.uniform(0.02, 0.98, (n, 2))
    u, v = X[:, 0], X[:, 1]
    f = (
        np.sin(9 * u + 3 * v)
        + 0.6 * np.cos(14 * v) * np.sin(5 * u)
        + 0.3 * np.sin(31 * u * v + 2)
    )
    return X, (f + 0.15 * rng.randn(n)).reshape(-1, 1)


def stat_summary(a: np.ndarray) -> dict:
    """Sum, sum of squares and a fixed random projection of one statistic
    (the weights from RandomState(SUMMARY_SEED), shaped like ``a``), with
    the sums of absolute values that scale their errors."""
    a = np.asarray(a, dtype=np.float64)
    w = np.random.RandomState(SUMMARY_SEED).randn(*a.shape)
    return {"sum": float(a.sum()), "abs_sum": float(np.abs(a).sum()),
            "sumsq": float((a * a).sum()), "proj": float((w * a).sum()),
            "proj_abs": float(np.abs(w * a).sum())}


def _leaves(tree):
    return [float(x) for x in jax.tree.leaves(tree)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2_000_000)
    ap.add_argument("--n-test", type=int, default=100_000)
    args = ap.parse_args()
    ops.set_impl("scan")
    out = {"n": args.n, "n_test": args.n_test}

    X, y = synthetic_ssh(args.n + args.n_test)
    Xtr, ytr = X[args.n_test:], y[args.n_test:]
    Xte, yte = X[:args.n_test], y[:args.n_test]
    bases = [BSplineBasis(0.0, 1.0, 100, 4)] * 2
    kernels = [Matern32(lengthscales=0.1), Matern32(lengthscales=0.1)]

    t0 = time.perf_counter()
    model = GPRKron((Xtr, ytr), kernels, bases, noise_variance=0.1)
    jax.block_until_ready(model.stats.kuf_y)
    out["stats_s"] = time.perf_counter() - t0
    s = model.stats
    out["stats"] = {"kuf_y": stat_summary(s.kuf_y), "t_band": stat_summary(s.t_band),
                    "yty": float(s.yty), "n": float(s.n)}

    p0 = model.init_params()
    t0 = time.perf_counter()
    loss, grad = jax.jit(jax.value_and_grad(model.training_loss))(p0)
    out["loss"] = float(loss)
    out["grad"] = _leaves(grad)  # kernels[0] (ℓ, σ²), kernels[1] (ℓ, σ²), noise
    out["value_and_grad_s"] = time.perf_counter() - t0

    info = {}
    t0 = time.perf_counter()
    params, fit_loss, iters = fit_lbfgs(jax.jit(model.training_loss), p0, max_iters=10,
                                        curv_rtol=10.0, info=info)
    out["fit"] = {"loss": float(fit_loss), "iters": int(iters), "evals": int(info["ls_evals"]),
                  "params": _leaves(params)}
    out["fit_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    post = model.posterior(params)
    mean, var = post.predict_f(jnp.asarray(Xte))
    ld = post.predict_log_density((Xte, yte))
    out["mse"] = float(mse(yte, mean))
    out["nlpd"] = float(nlpd(ld))
    out["predict"] = {"mean_sum": float(jnp.sum(mean)), "var_sum": float(jnp.sum(var)),
                      "var_min": float(jnp.min(var))}
    out["predict_s"] = time.perf_counter() - t0
    print(json.dumps(out))


if __name__ == "__main__":
    main()
