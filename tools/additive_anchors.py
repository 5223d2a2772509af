"""Reference values of GPRAdditive at ADDITIVE_PROBE.json's shape, from the
JAX package on a CPU in float64.

The PyTorch port's ``chip_smoke.py`` holds its GPRAdditive run on the GPU
to these numbers.  The shape and the data are tools/additive_probe.py's:
N = 5·10⁵ points in D = 4 dimensions from ``np.random.RandomState(0)``,
y = Σ_d sin((3 + 2d) x_d) + 0.2 ε, 4 × B3Spline(0, 1, 250) (M = 1000),
4 × Matern32(lengthscales=0.2), noise 0.1.  The held-out points are
N_TEST = 10⁵ more drawn the same way from ``np.random.RandomState(1)``.
The script prints the statistics summarised as ``stat_summary`` does,
the loss and its 9 raw-parameter gradients at init,
``fit_lbfgs(max_iters=10, curv_rtol=10.0)`` (loss, iterations,
evaluations, parameters) and the MSE and NLPD of the fitted posterior on
the held-out points.  It also computes the loss at init as the probe
computes it (the first of a scan of value-and-grad steps under one jit)
and its distance from ADDITIVE_PROBE.json's CPU loss0; it fails unless
the two agree to PROBE_TOL, which shows that the data are the probe's.

``--spread`` also measures how far float64 rounding alone leaves these
values undetermined, from SPREAD_SEEDS: the same quantities with KufKfu
and Kuf·y each multiplied entrywise by (1 + 1e-15 ε), ε standard normal
(KufKfu's kept symmetric), and, apart, with each dimension's Kuu band so
multiplied wherever the JAX package's GPRAdditive builds it (the loss, the
fit and the posterior).  It prints each value's largest relative move
under each ("stats", "kuu"): how precisely the anchors determine a
float64 result, beside the bars at which chip_smoke.py holds the port.
At the full shape Kuu's rounding alone moves the loss by about as much
as ADDITIVE_PROBE.json's record and this JAX build differ (PROBE_TOL).

Run from the repository root (a few GB of memory, a few minutes; with
``--spread`` seven times as long):

    python tools/additive_anchors.py [--n 500000] [--n-test 100000] [--spread]

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

from asvgp_tpu.basis import B3Spline  # noqa: E402
from asvgp_tpu.models import Matern32  # noqa: E402
from asvgp_tpu.models.additive import GPRAdditive, additive_collapsed_elbo  # noqa: E402
from asvgp_tpu.stats.additive import AdditiveStats  # noqa: E402
from asvgp_tpu.train import fit_lbfgs, mse, nlpd  # noqa: E402

D, M_PER_DIM = 4, 250
KUU_ROWS = 4  # B3: Kuu's lower band has k + 1 = 4 rows
SUMMARY_SEED = 7
PROBE_LOSS0 = 493038.7796382103  # ADDITIVE_PROBE.json, cpu_f64.loss0
# the probe's record and this JAX build's value differ in the ninth digit,
# as far as a perturbation of Kuu at the rounding level moves it
# (``--spread``), far less than other data would
PROBE_TOL = 1e-8
SPREAD_SEEDS = (0, 1, 2)


def probe_data(n, seed):
    """tools/additive_probe.py's generator (lines 42-45)."""
    rng = np.random.RandomState(seed)
    X = rng.uniform(0.02, 0.98, (n, D))
    y = sum(np.sin((3 + 2 * d) * X[:, d]) for d in range(D))
    return X, (y + 0.2 * rng.randn(n)).reshape(-1, 1)


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


def probe_loss0(model, p0, iters=5):
    """tools/additive_probe.py's loss0 (lines 64-79): the first value of a
    scan of ``iters`` value-and-grad steps in one jit, the noise moved by
    1e-12·i in step i (by 0 in the first)."""

    @jax.jit
    def k_steps(p):
        def body(c, i):
            q = jax.tree.map(lambda a: a, p)
            q["likelihood"] = dict(p["likelihood"])
            q["likelihood"]["raw_variance"] = p["likelihood"]["raw_variance"] + 1e-12 * i
            v, _ = jax.value_and_grad(model.training_loss)(q)
            return c + v, v

        return jax.lax.scan(body, jnp.zeros(()), jnp.arange(iters, dtype=jnp.float64))[1]

    return float(k_steps(p0)[0])


def run(model, stats, p0, Xte, yte) -> dict:
    """The loss and its gradient at ``p0``, the 10-iteration fit, and the
    fitted posterior's MSE and NLPD, from the statistics ``stats`` (each
    function traced anew, with the statistics its argument or read then)."""
    loss_fn = jax.jit(lambda p, s: -additive_collapsed_elbo(model.bases, model.nu2s, p, s))
    loss, grad = jax.jit(jax.value_and_grad(loss_fn))(p0, stats)
    info = {}
    params, fit_loss, iters = fit_lbfgs(jax.jit(lambda p: loss_fn(p, stats)), p0, max_iters=10,
                                        curv_rtol=10.0, info=info)
    saved, model.stats = model.stats, stats
    # a new function, so that the trace reads these statistics
    mean, var = jax.jit(lambda p, x: model._predict_f_inner(p, x))(params, jnp.asarray(Xte))
    model.stats = saved
    _, lik = model._build(params)
    ld = lik.predict_log_density(mean, var, jnp.reshape(jnp.asarray(yte), mean.shape))
    return {"loss": float(loss),
            "grad": _leaves(grad),  # kernels[d] (ℓ, σ²) for d = 0..3, then the noise
            "fit": {"loss": float(fit_loss), "iters": int(iters),
                    "evals": int(info["ls_evals"]), "params": _leaves(params)},
            "mse": float(mse(yte, mean)), "nlpd": float(nlpd(ld))}


def perturbed(stats, seed):
    """KufKfu and Kuf·y times (1 + 1e-15 ε), KufKfu's ε symmetric."""
    rng = np.random.RandomState(seed)
    kk = np.asarray(stats.kufkfu)
    eps = rng.randn(*kk.shape)
    eps = (eps + eps.T) / np.sqrt(2.0)
    ky = np.asarray(stats.kuf_y)
    return AdditiveStats(kuf_y=jnp.asarray(ky * (1.0 + 1e-15 * rng.randn(*ky.shape))),
                         kufkfu=jnp.asarray(kk * (1.0 + 1e-15 * eps)),
                         yty=stats.yty, n=stats.n)


@contextlib.contextmanager
def kuu_perturbed(seed):
    """The JAX package's GPRAdditive with each dimension's Kuu band times
    (1 + 1e-15 ε), one ε a dimension from RandomState(seed): the model
    builds the bands by ``make_kuu`` for d = 0..D-1 in turn, in the loss
    and in the posterior alike."""
    import asvgp_tpu.models.additive as additive

    rng = np.random.RandomState(seed)
    eps = [rng.randn(KUU_ROWS, M_PER_DIM) for _ in range(D)]
    calls = itertools.count()
    plain = additive.make_kuu

    def make_kuu(kernel, basis):
        return plain(kernel, basis) * (1.0 + 1e-15 * jnp.asarray(eps[next(calls) % D]))

    additive.make_kuu = make_kuu
    try:
        yield
    finally:
        additive.make_kuu = plain


def spread(model, p0, Xte, yte, base: dict) -> dict:
    """Each value's largest relative move from ``base`` (``run`` on the
    model's statistics) over SPREAD_SEEDS' perturbed statistics and,
    apart, perturbed Kuu; and the perturbed fits' iteration and evaluation
    counts."""
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
        r = run(model, perturbed(model.stats, seed), p0, Xte, yte)
        with kuu_perturbed(seed):
            r_kuu = run(model, model.stats, p0, Xte, yte)
        for kind, got in (("stats", r), ("kuu", r_kuu)):
            counts.append((got["fit"]["iters"], got["fit"]["evals"]))
            add_move(by_kind[kind], got)
    return {"seeds": list(SPREAD_SEEDS), **by_kind, "iters_evals": counts}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=500_000)
    ap.add_argument("--n-test", type=int, default=100_000)
    ap.add_argument("--spread", action="store_true")
    args = ap.parse_args()
    out = {"n": args.n, "n_test": args.n_test, "d": D, "m_per_dim": M_PER_DIM}

    X, y = probe_data(args.n, 0)
    Xte, yte = probe_data(args.n_test, 1)
    bases = [B3Spline(0.0, 1.0, M_PER_DIM)] * D
    kernels = [Matern32(lengthscales=0.2)] * D

    t0 = time.perf_counter()
    model = GPRAdditive((jnp.asarray(X), jnp.asarray(y)), kernels, bases, noise_variance=0.1)
    jax.block_until_ready(model.stats.kufkfu)
    out["stats_s"] = time.perf_counter() - t0
    s = model.stats
    out["stats"] = {"kuf_y": stat_summary(s.kuf_y), "kufkfu": stat_summary(s.kufkfu),
                    "yty": float(s.yty), "n": float(s.n)}

    p0 = model.init_params()
    t0 = time.perf_counter()
    base = run(model, model.stats, p0, Xte, yte)
    out |= base
    out["run_s"] = time.perf_counter() - t0
    out["loss0_probe_way"] = probe_loss0(model, p0)
    out["loss0_rel_vs_probe"] = abs(out["loss0_probe_way"] - PROBE_LOSS0) / PROBE_LOSS0
    if args.spread:
        t0 = time.perf_counter()
        out["spread"] = spread(model, p0, Xte, yte, base)
        out["spread_s"] = time.perf_counter() - t0
    print(json.dumps(out))
    if args.n == 500_000 and not out["loss0_rel_vs_probe"] <= PROBE_TOL:
        raise SystemExit(f"loss0 {out['loss0_probe_way']!r} is not ADDITIVE_PROBE.json's "
                         f"{PROBE_LOSS0!r}")


if __name__ == "__main__":
    main()
