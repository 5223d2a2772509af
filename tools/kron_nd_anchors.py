"""Reference values of GPRKron at D = 3, from the JAX package on a CPU in
float64 (lax.scan recursions).

The PyTorch port's ``chip_smoke.py`` (phase 6r) holds its D = 3 run on the
GPU to these numbers.  The shape: ``synthetic_field_3d(1_100_000)`` from
seed 2024 with the first 10⁵ points held out, 3 × BSplineBasis(0, 1, 20, 3)
(M = 8000 features, m₁ = 20 block columns of dense blocks of side
M₂ = 400), 3 × Matern32(lengthscales=0.2), noise 0.1: a 3-D field
(longitude, latitude, and time or depth).  The script prints the
statistics summarised as ``stat_summary`` does, the loss and its 7
raw-parameter gradients at init, ``fit_lbfgs(max_iters=10,
curv_rtol=10.0)`` (loss, iterations, evaluations, parameters), and the MSE
and NLPD of the fitted posterior on the held-out points with summaries of
its predictions.

``--spread`` also measures how far float64 rounding alone leaves these
values undetermined, from SPREAD_SEEDS: the same quantities with the
statistics (the multiband T and Kuf·y) each multiplied entrywise by
(1 + 1e-15 ε), ε standard normal, and, apart, with each dimension's Kuu
band so multiplied wherever the JAX package's GPRKron builds it (the loss,
the fit and the posterior).  It prints each value's largest relative move
under each ("stats", "kuu"), beside the bars at which chip_smoke.py holds
the port.

Run from the repository root (about 10 GB of memory; a few minutes, with
``--spread`` about three times as long):

    python tools/kron_nd_anchors.py [--n 1000000] [--n-test 100000] [--spread]

Prints one JSON object.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
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
from asvgp_tpu.models.kron import GPRKron, PosteriorKron, kron_collapsed_elbo  # noqa: E402
from asvgp_tpu.stats.kron import KronStats  # noqa: E402
from asvgp_tpu.train import fit_lbfgs, mse, nlpd  # noqa: E402

D, M_PER_DIM, ORDER, ELL, NOISE = 3, 20, 3, 0.2, 0.1
SEED = 2024
SUMMARY_SEED = 7
SPREAD_SEEDS = (0, 1, 2)


def synthetic_field_3d(n, seed=SEED):
    """A smooth 3-D field on (0.02, 0.98)³ with noise 0.1:
    f = sin(6u + 2v) + ½ cos(5w) sin(4v) + 0.3 sin(11uw + 1)."""
    rng = np.random.RandomState(seed)
    X = rng.uniform(0.02, 0.98, (n, 3))
    u, v, w = X[:, 0], X[:, 1], X[:, 2]
    f = np.sin(6 * u + 2 * v) + 0.5 * np.cos(5 * w) * np.sin(4 * v) + 0.3 * np.sin(11 * u * w + 1)
    return X, (f + 0.1 * rng.randn(n)).reshape(-1, 1)


def stat_summary(a) -> dict:
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


def progress(what, t0):
    """One line on stderr: a stage and its seconds."""
    print(f"{what}: {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)


class Runner:
    """The loss and its gradient, the 10-iteration fit, and the fitted
    posterior's metrics from given statistics.  The loss takes the
    statistics as an argument and the fit reuses one compiled loop, so a
    run on other statistics compiles nothing; a new Runner traces anew
    (and so reads a perturbed Kuu)."""

    def __init__(self, model):
        self.model = model
        bases, nu2s = model.bases, model.nu2s
        self.loss = jax.jit(lambda p, *s: -kron_collapsed_elbo(bases, nu2s, p, KronStats(*s)))
        self.value_and_grad = jax.jit(jax.value_and_grad(self.loss))
        self.posterior = jax.jit(model._posterior_arrays)
        self.fit_cache = {}

    def __call__(self, stats, p0, Xte, yte) -> dict:
        s = (stats.kuf_y, stats.t_band, stats.yty, stats.n)
        loss, grad = self.value_and_grad(p0, *s)
        info = {}
        params, fit_loss, iters = fit_lbfgs(self.loss, p0, max_iters=10, curv_rtol=10.0,
                                            info=info, data_args=s, cache=self.fit_cache)
        kernels, lik = self.model._build(params)
        w_flat, sp, s_bands = self.posterior(params, stats.t_band, stats.kuf_y)
        post = PosteriorKron(kernels, lik, self.model.bases, w_flat, sp, s_bands,
                             cache_tag="kron-nd-anchors")
        mean, var = post.predict_f(jnp.asarray(Xte))
        ld = post.predict_log_density((Xte, yte))
        return {"loss": float(loss),
                "grad": _leaves(grad),  # kernels[d] (ℓ, σ²) for d = 0..2, then the noise
                "fit": {"loss": float(fit_loss), "iters": int(iters),
                        "evals": int(info["ls_evals"]), "params": _leaves(params)},
                "mse": float(mse(yte, mean)), "nlpd": float(nlpd(ld)),
                "predict": {"mean_sum": float(jnp.sum(mean)), "var_sum": float(jnp.sum(var)),
                            "var_min": float(jnp.min(var))}}


def perturbed(stats, seed):
    """The multiband T and Kuf·y times (1 + 1e-15 ε)."""
    rng = np.random.RandomState(seed)
    tb, ky = np.asarray(stats.t_band), np.asarray(stats.kuf_y)
    return KronStats(kuf_y=jnp.asarray(ky * (1.0 + 1e-15 * rng.randn(*ky.shape))),
                     t_band=jnp.asarray(tb * (1.0 + 1e-15 * rng.randn(*tb.shape))),
                     yty=stats.yty, n=stats.n)


@contextlib.contextmanager
def kuu_perturbed(seed):
    """The JAX package's GPRKron with each dimension's Kuu band times
    (1 + 1e-15 ε), one ε a dimension from RandomState(seed): the model
    builds the bands by ``make_kuu`` for d = 0..D-1 in turn, in the loss
    and in the posterior alike."""
    import asvgp_tpu.models.kron as kron

    rng = np.random.RandomState(seed)
    eps = [rng.randn(ORDER + 1, M_PER_DIM) for _ in range(D)]
    calls = itertools.count()
    plain = kron.make_kuu

    def make_kuu(kernel, basis):
        return plain(kernel, basis) * (1.0 + 1e-15 * jnp.asarray(eps[next(calls) % D]))

    kron.make_kuu = make_kuu
    try:
        yield
    finally:
        kron.make_kuu = plain


def spread(model, runner, p0, Xte, yte, base: dict) -> dict:
    """Each value's largest relative move from ``base`` over SPREAD_SEEDS'
    perturbed statistics and, apart, perturbed Kuu; and the perturbed
    fits' iteration and evaluation counts."""
    def values(r):
        return {"loss": r["loss"], "fit": r["fit"]["loss"], "mse": r["mse"], "nlpd": r["nlpd"]}

    def no_moves():
        return dict.fromkeys(values(base), 0.0) | {"grad": [0.0] * len(base["grad"])}

    def add_move(moves, r):
        for key, v in values(r).items():
            moves[key] = max(moves[key], abs(v - values(base)[key]) / abs(values(base)[key]))
        moves["grad"] = [max(m, abs(g - b) / abs(b))
                         for m, g, b in zip(moves["grad"], r["grad"], base["grad"])]

    by_kind, counts = {"stats": no_moves(), "kuu": no_moves()}, []
    for seed in SPREAD_SEEDS:
        t0 = time.perf_counter()
        r = runner(perturbed(model.stats, seed), p0, Xte, yte)
        progress(f"spread, statistics, seed {seed}", t0)
        t0 = time.perf_counter()
        with kuu_perturbed(seed):
            r_kuu = Runner(model)(model.stats, p0, Xte, yte)
        progress(f"spread, Kuu, seed {seed}", t0)
        for kind, got in (("stats", r), ("kuu", r_kuu)):
            counts.append((got["fit"]["iters"], got["fit"]["evals"]))
            add_move(by_kind[kind], got)
    return {"seeds": list(SPREAD_SEEDS), **by_kind, "iters_evals": counts}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--n-test", type=int, default=100_000)
    ap.add_argument("--spread", action="store_true")
    args = ap.parse_args()
    ops.set_impl("scan")
    out = {"n": args.n, "n_test": args.n_test, "d": D, "m_per_dim": M_PER_DIM, "order": ORDER}

    X, y = synthetic_field_3d(args.n + args.n_test)
    Xtr, ytr = X[args.n_test:], y[args.n_test:]
    Xte, yte = X[:args.n_test], y[:args.n_test]
    bases = [BSplineBasis(0.0, 1.0, M_PER_DIM, ORDER)] * D
    kernels = [Matern32(lengthscales=ELL)] * D

    t0 = time.perf_counter()
    model = GPRKron((Xtr, ytr), kernels, bases, noise_variance=NOISE)
    jax.block_until_ready(model.stats.kuf_y)
    out["stats_s"] = time.perf_counter() - t0
    progress("statistics", t0)
    s = model.stats
    out["stats"] = {"kuf_y": stat_summary(s.kuf_y), "t_band": stat_summary(s.t_band),
                    "yty": float(s.yty), "n": float(s.n)}

    p0 = model.init_params()
    t0 = time.perf_counter()
    runner = Runner(model)
    base = runner(model.stats, p0, Xte, yte)
    out |= base
    out["run_s"] = time.perf_counter() - t0
    progress("loss, gradient, fit, posterior, predictions", t0)
    if args.spread:
        t0 = time.perf_counter()
        out["spread"] = spread(model, runner, p0, Xte, yte, base)
        out["spread_s"] = time.perf_counter() - t0
    print(json.dumps(out))


if __name__ == "__main__":
    main()
