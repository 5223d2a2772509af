"""Reference values of the float32 GPR1D at bench.py's shape, from the JAX
package on a CPU, and how far the PyTorch port's plain float32 route is
from them.

The port's ``chip_smoke.py`` holds its float32 GPR1D run on the GPU to
these numbers.  The model is the JAX package's ``GPR1D(..., dtype=float32)``
as it runs with x64 off (its float32 route): bench.py's data
(``bench_data(10**6, 0)``), ``B3Spline(0, 1, 10_000)``, ``Matern32(1.0,
1e-3)``, noise 0.1, the statistics accumulated in float64 and cast once to
float32, then under ``jax.enable_x64(False)`` with ``set_impl("scan")``:
the training loss and its gradient at ``init_params()``, the posterior's
mean and variance on the 10⁵ held-out points ``bench_data(10**5, 1)`` (each
as a sum and a projection on fixed random weights, with the sums of their
absolute terms) and the NLPD there.

The same numbers from the JAX package's float64 model (x64 on, scan) give
``f32_error``: how far the float32 route lies from float64, each quantity
relative to its float32 value (for the predictions also the largest
pointwise distance relative to the largest value).  At this shape κ(Kuu)
amplifies float32 rounding, so two float32 routes that round in other
orders may differ by up to that much: ``chip_smoke.py`` holds the card's
float32 run to the float32 anchors within ``f32_error``, or 1e-5 where
that is larger.

With ``--port`` the same numbers come also from the port's float32 GPR1D on
the CPU (the plain versions of K17–K22), with the distance of each from
the JAX float32 values (``port_rel``, measured the same way).

Run from the repository root (a few GB of memory, a few minutes):

    python tools/f32_anchors.py [--port] [--n 1000000] [--m 10000]

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
from asvgp_tpu.basis import B3Spline  # noqa: E402
from asvgp_tpu.models import GPR1D, Matern32  # noqa: E402

SUMMARY_SEED = 7
PREDICT_BATCH = 30_000
GRAD_NAMES = (("kernel", "raw_lengthscales"), ("kernel", "raw_variance"),
              ("likelihood", "raw_variance"))


def bench_data(n, seed):
    """bench.py's generator: ~700 periods on (0.005, 0.995), noise 0.3."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(0.005, 0.995, n)
    y = np.sin(4400.0 * x) + 0.5 * np.sin(1100.0 * x) + 0.3 * rng.randn(n)
    return x, y


def summary(a) -> dict:
    """Sum and projection on fixed random weights of a (n, 1) prediction,
    each with the sum of its absolute terms, in float64."""
    a = np.asarray(a, dtype=np.float64).reshape(-1)
    w = np.random.RandomState(SUMMARY_SEED).randn(a.shape[0])
    return {"sum": float(a.sum()), "abs_sum": float(np.abs(a).sum()),
            "proj": float((w * a).sum()), "proj_abs": float(np.abs(w * a).sum())}


def summary_rel(got: dict, want: dict) -> float:
    """The larger distance of sum and projection, each relative to the sum
    of the absolute terms it is made of."""
    return max(abs(got["sum"] - want["sum"]) / want["abs_sum"],
               abs(got["proj"] - want["proj"]) / want["proj_abs"])


def jax_values(x, y, xt, yt, m, f32: bool = True) -> dict:
    """The JAX package's values on the scan route: its float32 model under
    x64 off, or (``f32=False``) its float64 model."""
    ops.set_impl("scan")
    model = GPR1D((jnp.asarray(x), jnp.asarray(y)), Matern32(1.0, 1e-3), B3Spline(0.0, 1.0, m),
                  noise_variance=0.1, dtype=jnp.float32 if f32 else None)
    params = model.init_params()
    with jax.enable_x64(not f32):
        if f32:
            params = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float32), params)
        loss, grad = jax.jit(jax.value_and_grad(model.training_loss))(params)
        post = model.posterior(params)
        mean, var = post.predict_f(jnp.asarray(xt), batch=PREDICT_BATCH)
        log_density = post.predict_log_density((jnp.asarray(xt), jnp.asarray(yt)))
        nlpd = -jnp.mean(log_density)
        assert loss.dtype == mean.dtype == (jnp.float32 if f32 else jnp.float64)
    return ({"loss": float(loss), "grad": [float(grad[g][k]) for g, k in GRAD_NAMES],
             "mean": summary(mean), "var": summary(var), "nlpd": float(nlpd)},
            (np.asarray(mean), np.asarray(var)))


def port_values(x, y, xt, yt, m) -> dict:
    import torch

    from asvgp_tpu_torch.basis import B3Spline as TB3Spline
    from asvgp_tpu_torch.models import GPR1D as TGPR1D
    from asvgp_tpu_torch.models import Matern32 as TMatern32
    from asvgp_tpu_torch.train import nlpd

    model = TGPR1D((x, y), TMatern32(1.0, 1e-3), TB3Spline(0.0, 1.0, m), noise_variance=0.1,
                   device="cpu", dtype=torch.float32)
    loss = model.training_loss()
    loss.backward()
    grad = [float(model.raw_lengthscales.grad), float(model.raw_variance.grad),
            float(model.raw_noise_variance.grad)]
    post = model.posterior()
    mean, var = post.predict_f(xt, batch=PREDICT_BATCH)
    score = nlpd(post.predict_log_density((xt, yt)))
    assert loss.dtype == mean.dtype == torch.float32
    return ({"loss": float(loss.detach()), "grad": grad, "mean": summary(mean.numpy()),
             "var": summary(var.numpy()), "nlpd": float(score)},
            (mean.numpy(), var.numpy()))


def distances(got: dict, want: dict, got_pred, want_pred) -> dict:
    """Relative distances of every value; for the predictions also the
    largest pointwise distance relative to the largest value."""
    def rel(a, b):
        return abs(a - b) / abs(b)

    def max_rel(a, b):
        b = np.asarray(b, np.float64)
        return float(np.max(np.abs(np.asarray(a, np.float64) - b)) / np.max(np.abs(b)))

    return {"loss": rel(got["loss"], want["loss"]),
            "grad": [rel(a, b) for a, b in zip(got["grad"], want["grad"])],
            "mean": summary_rel(got["mean"], want["mean"]),
            "var": summary_rel(got["var"], want["var"]),
            "nlpd": rel(got["nlpd"], want["nlpd"]),
            "mean_pointwise": max_rel(got_pred[0], want_pred[0]),
            "var_pointwise": max_rel(got_pred[1], want_pred[1])}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--n-test", type=int, default=100_000)
    ap.add_argument("--m", type=int, default=10_000)
    ap.add_argument("--port", action="store_true",
                    help="also run the port's float32 GPR1D on the CPU and report its distances")
    args = ap.parse_args()
    x, y = bench_data(args.n, 0)
    xt, yt = bench_data(args.n_test, 1)
    t0 = time.perf_counter()
    out = {"n": args.n, "n_test": args.n_test, "m": args.m, "summary_seed": SUMMARY_SEED}
    out["jax"], jax_pred = jax_values(x, y, xt, yt, args.m)
    out["jax_f64"], f64_pred = jax_values(x, y, xt, yt, args.m, f32=False)
    # how far the float32 route is from the float64 one, relative to the
    # float32 values: what float32 leaves undetermined at this shape
    out["f32_error"] = distances(out["jax_f64"], out["jax"], f64_pred, jax_pred)
    out["jax_seconds"] = time.perf_counter() - t0
    if args.port:
        t0 = time.perf_counter()
        out["port"], port_pred = port_values(x, y, xt, yt, args.m)
        out["port_seconds"] = time.perf_counter() - t0
        out["port_rel"] = distances(out["port"], out["jax"], port_pred, jax_pred)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
