"""Reference values of the large-regression protocol at full width, from
the JAX package on a CPU in float64.

The PyTorch port's ``chip_smoke.py`` phase 6p drives the torch leg's
``run_split`` (experiments/large_regression/synthetic_1m_torch.py) on the
GPU and holds it to these numbers.  The shape is the protocol's defaults:
``make_data(10⁶, 0)`` (experiments/large_regression/synthetic_1m.py), the
95/5 split (the first 5·10⁴ points held out), ``BSplineBasis(0, 1, 1000,
3)``, ``Matern52(lengthscales=0.05)``, noise 1.0 (κ(Kuu) ≈ 7.8e9), the
banded ops on the exact recursions (``set_impl("scan")``).  With the
phase's cut counts it prints:

- GPR1D: the loss and its raw-parameter gradient at init,
  ``fit_lbfgs(max_iters=10, restarts=0, curv_rtol=10.0)`` (loss,
  iterations, evaluations, parameters), NLPD and MSE on the held-out
  points at the fitted parameters;
- Adam (``fit_adam_minibatch``'s loop, Matérn-5/2, lr 1e-2): 20 steps at
  batch 4096 on ``RandomState(2)`` indices, the step-1 and step-20 losses;
- SVGP (``fit_svgp``'s loop from ``init_params()``, C seeded at C*, lr
  1e-3): 20 steps at batch 100 on ``RandomState(3)`` indices, the step-1
  and step-20 losses;
- VFF (``GPRVFF``, 100 frequencies, m = 201): the loss and gradient at
  init, ``fit_lbfgs(max_iters=10)``, NLPD and MSE.

The JAX loops draw their own minibatches with ``jax.random``; here the
same loops run on the numpy index streams the phase hands the port.

``--spread`` also measures how far float64 rounding alone leaves each value
undetermined, from SPREAD_SEEDS: the same quantities with the Kuu band (or
VFF's dense Kuu) multiplied entrywise by (1 + 1e-15 ε) wherever the JAX
package builds it, and, apart, with Kuf·y and KufKfu so multiplied
(KufKfu's ε symmetric); apart, with every banded Cholesky factor the JAX
package computes multiplied by (1 + 1e-16 ε), one rounding of L; and
apart, with only the adjoint of each such Cholesky taken through a factor
one rounding away (its input times (1 + 1e-16 ε) in the backward pass):
the rounding another implementation's backward sweeps leave.  Adam's and
SVGP's two losses under the first, third and fourth, and Adam's also with
each step's minibatch Kuf·y and KufKfu perturbed.  It prints each value's largest relative move under each, and the
perturbed fits' iteration and evaluation counts: ``chip_smoke.py``'s bars
are 10× that where it exceeds GPRKron's.

Run from the repository root (a few GB of memory, about 30 s on a CPU;
with ``--spread`` about 4 minutes):

    python tools/large_regression_anchors.py [--spread]

Prints one JSON object.
"""

from __future__ import annotations

import argparse
import contextlib
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
import optax  # noqa: E402

import asvgp_tpu.models.gpr1d as jgpr1d  # noqa: E402
import asvgp_tpu.models.svgp as jsvgp  # noqa: E402
import asvgp_tpu.models.vff as jvff  # noqa: E402
from asvgp_tpu.banded import ops as jops  # noqa: E402
from asvgp_tpu.basis import BSplineBasis  # noqa: E402
from asvgp_tpu.features.fourier import FourierBasis1D  # noqa: E402
from asvgp_tpu.features.spline_features import make_kuu  # noqa: E402
from asvgp_tpu.models import GPR1D, Matern52  # noqa: E402
from asvgp_tpu.models.gpr1d import (  # noqa: E402
    collapsed_elbo_banded,
    params_to_kernel,
    params_to_likelihood,
)
from asvgp_tpu import banded as jbanded  # noqa: E402
from asvgp_tpu.models.parameters import positive  # noqa: E402
from asvgp_tpu.models.svgp import SVGP1D  # noqa: E402
from asvgp_tpu.models.vff import GPRVFF  # noqa: E402
from asvgp_tpu.stats.sufficient import SufficientStats, _stats_local, compute_stats  # noqa: E402
from asvgp_tpu.train import fit_lbfgs, mse, nlpd  # noqa: E402
from asvgp_tpu.utils import exec_cache as _ec  # noqa: E402

N, M, ORDER, ELL, SEED = 1_000_000, 1000, 3, 0.05, 0
FIT_ITERS = 10
ADAM = {"steps": 20, "batch": 4096, "lr": 1e-2, "index_seed": 2}
SVGP = {"steps": 20, "batch": 100, "lr": 1e-3, "index_seed": 3}
VFF_FREQUENCIES = 100
SPREAD_SEEDS = (0, 1, 2)


def make_data(n, seed):
    """The protocol's generator (synthetic_1m.py ``make_data``)."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(0.002, 0.998, n)
    f = np.sin(7 * x) + 0.5 * np.sin(23 * x) * np.exp(-x)
    return x, f + 0.3 * rng.randn(n)


def index_stream(seed, steps, batch, n):
    """(steps, batch) minibatch indices drawn with numpy from ``seed``, as
    chip_smoke.py ``index_stream``."""
    return np.random.RandomState(seed).randint(0, n, size=(steps, batch))


def _leaves(tree):
    return [float(v) for v in jax.tree.leaves(tree)]


def adam_losses(basis, xtr, ytr, p0, idx, seed=None):
    """fit_adam_minibatch's loop (asvgp_tpu/train/adam.py) on given
    indices: the loss of every step.  With a ``seed``, each step's Kuf·y
    and KufKfu are multiplied entrywise by (1 + 1e-15 ε), one ε from
    RandomState(seed) for all steps."""
    x, yf = jnp.asarray(xtr), jnp.asarray(ytr)
    n_total = x.shape[0]
    opt = optax.adam(ADAM["lr"])
    eps_y = eps_b = 0.0
    if seed is not None:
        rng = np.random.RandomState(seed)
        eps_y = 1e-15 * jnp.asarray(rng.randn(M))
        eps_b = 1e-15 * jnp.asarray(rng.randn(ORDER + 1, M))

    def loss_fn(p, xb, yb):
        stats = _stats_local(basis, xb, yb)
        scale = jnp.asarray(n_total, x.dtype) / stats.n
        stats = SufficientStats(kuf_y=stats.kuf_y * scale * (1.0 + eps_y),
                                kufkfu_band=stats.kufkfu_band * scale * (1.0 + eps_b),
                                yty=stats.yty * scale, n=stats.n * scale)
        kernel, lik = params_to_kernel(p, 5), params_to_likelihood(p)
        return -collapsed_elbo_banded(stats, make_kuu(kernel, basis), lik.variance,
                                      stats.n * kernel.variance)

    @jax.jit
    def step(p, state, i):
        loss, grads = jax.value_and_grad(loss_fn)(p, x[i], yf[i])
        updates, state = opt.update(grads, state, p)
        return optax.apply_updates(p, updates), state, loss

    p, state, losses = p0, opt.init(p0), []
    for i in idx:
        p, state, loss = step(p, state, jnp.asarray(i))
        losses.append(float(loss))
    return losses


def svgp_losses(basis, xtr, ytr, idx):
    """fit_svgp's loop (asvgp_tpu/models/svgp.py) from ``init_params()`` on
    given indices, C seeded at C* as fit_svgp seeds it: every step's loss."""
    model = SVGP1D(Matern52(lengthscales=ELL), basis, num_data=len(xtr))
    x, yf = jnp.asarray(xtr), jnp.asarray(ytr)
    p0 = model.init_params()
    # fit_svgp's seeding of C = 0 at C* = chol(KufKfu + 1e-10 max diag) / σ
    band = compute_stats(basis, x, yf).kufkfu_band
    band = band.at[0].add(1e-10 * jnp.max(band[0]))
    c0 = jbanded.cholesky_band(band) / jnp.sqrt(positive(p0["likelihood"]["raw_variance"]))
    p0 = {**p0, "q_prec_corr": c0[: p0["q_prec_corr"].shape[0]]}
    opt = optax.adam(SVGP["lr"])

    @jax.jit
    def step(p, state, i):
        loss, grads = jax.value_and_grad(model.training_loss)(p, x[i], yf[i])
        updates, state = opt.update(grads, state, p)
        return optax.apply_updates(p, updates), state, loss

    p, state, losses = p0, opt.init(p0), []
    for i in idx:
        p, state, loss = step(p, state, jnp.asarray(i))
        losses.append(float(loss))
    return losses


def fresh(model):
    """A new function for the model's loss, so that its trace reads the
    statistics and Kuu as they are now (a jitted method's trace is kept)."""
    return lambda p: model.training_loss(p)


def gpr_values(model, xte, yte) -> dict:
    p0 = model.init_params()
    loss, grad = jax.jit(jax.value_and_grad(fresh(model)))(p0)
    info = {}
    params, fit_loss, iters = fit_lbfgs(jax.jit(fresh(model)), p0, max_iters=FIT_ITERS,
                                        restarts=0, curv_rtol=10.0, info=info)
    _ec._MEMO.clear()  # the posterior's compiled factorization, kept by its tag
    ld = model.predict_log_density(params, (xte, yte))
    mean, _ = model.predict_f(params, xte)
    return {"loss": float(loss), "grad": _leaves(grad),  # (ℓ, σ², noise)
            "fit": {"loss": float(fit_loss), "iters": int(iters),
                    "evals": int(info["ls_evals"]), "params": _leaves(params)},
            "nlpd": float(nlpd(ld)), "mse": float(mse(yte, mean))}


def vff_values(vff, xte, yte) -> dict:
    p0 = vff.init_params()
    loss, grad = jax.jit(jax.value_and_grad(fresh(vff)))(p0)
    info = {}
    params, fit_loss, iters = fit_lbfgs(jax.jit(fresh(vff)), p0, max_iters=FIT_ITERS,
                                        info=info)
    vff.__dict__.pop("_predict_jit", None)  # its trace holds the statistics
    ld = vff.predict_log_density(params, (xte, yte))
    mean, _ = vff.predict_f(params, xte)
    return {"loss": float(loss), "grad": _leaves(grad),
            "fit": {"loss": float(fit_loss), "iters": int(iters),
                    "evals": int(info["ls_evals"]), "params": _leaves(params)},
            "nlpd": float(nlpd(ld)), "mse": float(mse(yte, mean))}


@contextlib.contextmanager
def kuu_perturbed(seed):
    """Kuu times (1 + 1e-15 ε) wherever the JAX package builds it for these
    runs (``make_kuu`` in models/gpr1d.py and models/svgp.py and in the Adam
    loss here, ``make_kuu_vff`` in models/vff.py), one ε from
    RandomState(seed) for the band and one for VFF's dense Kuu."""
    rng = np.random.RandomState(seed)
    eps_band = jnp.asarray(rng.randn(ORDER + 1, M))
    mv = 2 * VFF_FREQUENCIES + 1
    e = rng.randn(mv, mv)
    eps_dense = jnp.asarray((e + e.T) / np.sqrt(2.0))
    here = sys.modules[__name__]
    plain_band, plain_dense = make_kuu, jvff.make_kuu_vff

    def band(k, b):
        return plain_band(k, b) * (1.0 + 1e-15 * eps_band)

    jgpr1d.make_kuu = jsvgp.make_kuu = here.make_kuu = band
    jvff.make_kuu_vff = lambda k, b: plain_dense(k, b) * (1.0 + 1e-15 * eps_dense)
    try:
        yield
    finally:
        jgpr1d.make_kuu = jsvgp.make_kuu = here.make_kuu = plain_band
        jvff.make_kuu_vff = plain_dense


@contextlib.contextmanager
def factor_perturbed(seed):
    """Every banded Cholesky factor the JAX package computes for these runs
    (``cholesky_band`` of banded/ops.py, which its pair form and the
    collapsed core call, and the package's export, which SVGP calls) times
    (1 + 1e-16 ε): one rounding of L, the size of what another float64
    order of operations leaves in it; one ε a call from RandomState(seed)."""
    rng = np.random.RandomState(seed)
    plain = jops.cholesky_band

    def factor(a_band):
        eps = jnp.asarray(rng.randn(*a_band.shape))
        return plain(a_band) * (1.0 + 1e-16 * eps)

    jops.cholesky_band = jbanded.cholesky_band = factor
    try:
        yield
    finally:
        jops.cholesky_band = jbanded.cholesky_band = plain


@contextlib.contextmanager
def adjoint_perturbed(seed):
    """Every banded Cholesky the JAX package differentiates for these runs
    (as ``factor_perturbed`` finds them) with its adjoint taken at the input
    times (1 + 1e-16 ε): the values as they were, the backward pass through
    a factor one rounding away, as another order of operations in the
    forward sweep leaves it; one ε a call from RandomState(seed)."""
    rng = np.random.RandomState(seed)
    plain = jops.cholesky_band

    @jax.custom_vjp
    def factor(a_band):
        return plain(a_band)

    def fwd(a_band):
        return plain(a_band), a_band

    def bwd(a_band, g):
        eps = jnp.asarray(rng.randn(*a_band.shape))
        _, vjp = jax.vjp(plain, a_band * (1.0 + 1e-16 * eps))
        return vjp(g)

    factor.defvjp(fwd, bwd)
    jops.cholesky_band = jbanded.cholesky_band = factor
    try:
        yield
    finally:
        jops.cholesky_band = jbanded.cholesky_band = plain


def stats_perturbed(model, vff, seed):
    """The two models' Kuf·y and KufKfu times (1 + 1e-15 ε), KufKfu's ε
    symmetric; restores them on exit."""
    rng = np.random.RandomState(seed)
    s = model.stats
    saved = (s, vff.kuf_y, vff.kufkfu)
    ky = np.asarray(s.kuf_y)
    kb = np.asarray(s.kufkfu_band)  # a lower band: its entries are each one pair's
    model.stats = SufficientStats(
        kuf_y=jnp.asarray(ky * (1.0 + 1e-15 * rng.randn(*ky.shape))),
        kufkfu_band=jnp.asarray(kb * (1.0 + 1e-15 * rng.randn(*kb.shape))),
        yty=s.yty, n=s.n)
    vy, vk = np.asarray(vff.kuf_y), np.asarray(vff.kufkfu)
    e = rng.randn(*vk.shape)
    vff.kuf_y = jnp.asarray(vy * (1.0 + 1e-15 * rng.randn(*vy.shape)))
    vff.kufkfu = jnp.asarray(vk * (1.0 + 1e-15 * (e + e.T) / np.sqrt(2.0)))
    return saved


def moves(base, got, out):
    """The largest relative move of each scalar and gradient component."""
    def scalars(r):
        return {"loss": r["loss"], "fit": r["fit"]["loss"], "nlpd": r["nlpd"], "mse": r["mse"]}

    for key, v in scalars(got).items():
        b = scalars(base)[key]
        out[key] = max(out.get(key, 0.0), abs(v - b) / abs(b))
    out["grad"] = [max(m, abs(g - b) / abs(b)) for m, g, b in
                   zip(out.get("grad", [0.0] * len(base["grad"])), got["grad"], base["grad"])]
    out.setdefault("iters_evals", []).append((got["fit"]["iters"], got["fit"]["evals"]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--spread", action="store_true")
    args = ap.parse_args()
    os.environ.pop("ASVGP_EXEC_CACHE_DIR", None)  # no executable from disk
    jops.set_impl("scan")
    x, y = make_data(N, SEED)
    n_test = N // 20
    xtr, ytr, xte, yte = x[n_test:], y[n_test:], x[:n_test], y[:n_test]
    basis = BSplineBasis(0.0, 1.0, M, ORDER)
    out = {"n": N, "n_test": n_test, "m": M, "ell": ELL}

    t0 = time.perf_counter()
    model = GPR1D((xtr, ytr), Matern52(lengthscales=ELL), basis)
    out["gpr1d"] = gpr_values(model, xte, yte)
    out["gpr1d_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    idx = index_stream(ADAM["index_seed"], ADAM["steps"], ADAM["batch"], len(xtr))
    losses = adam_losses(basis, xtr, ytr, model.init_params(), idx)
    out["adam"] = {**ADAM, "loss_1": losses[0], "loss_20": losses[-1], "losses": losses}
    idx = index_stream(SVGP["index_seed"], SVGP["steps"], SVGP["batch"], len(xtr))
    losses = svgp_losses(basis, xtr, ytr, idx)
    out["svgp"] = {**SVGP, "loss_1": losses[0], "loss_20": losses[-1], "losses": losses}
    out["minibatch_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    vff = GPRVFF((xtr, ytr), Matern52(lengthscales=ELL), FourierBasis1D(0.0, 1.0, VFF_FREQUENCIES))
    out["vff"] = vff_values(vff, xte, yte)
    out["vff_s"] = time.perf_counter() - t0

    if args.spread:
        minibatch = (
            ("adam", lambda i: adam_losses(basis, xtr, ytr, model.init_params(), i),
             index_stream(ADAM["index_seed"], ADAM["steps"], ADAM["batch"], len(xtr))),
            ("svgp", lambda i: svgp_losses(basis, xtr, ytr, i),
             index_stream(SVGP["index_seed"], SVGP["steps"], SVGP["batch"], len(xtr))))
        t0 = time.perf_counter()
        spread = {"seeds": list(SPREAD_SEEDS)}
        for kind in ("kuu", "stats", "factor", "adjoint"):
            for name in ("gpr1d", "vff"):
                spread[f"{name}_{kind}"] = {}
            for seed in SPREAD_SEEDS:
                if kind in ("factor", "adjoint"):
                    ctx = factor_perturbed if kind == "factor" else adjoint_perturbed
                    with ctx(seed):
                        got = {"gpr1d": gpr_values(model, xte, yte),
                               "vff": vff_values(vff, xte, yte)}
                        for name, fn, idx in minibatch:
                            losses = fn(idx)
                            sp = spread.setdefault(f"{name}_{kind}",
                                                   {"loss_1": 0.0, "loss_20": 0.0})
                            for key, v in (("loss_1", losses[0]), ("loss_20", losses[-1])):
                                sp[key] = max(sp[key], abs(v - out[name][key]) / abs(out[name][key]))
                elif kind == "kuu":
                    with kuu_perturbed(seed):
                        got = {"gpr1d": gpr_values(model, xte, yte),
                               "vff": vff_values(vff, xte, yte)}
                        for name, fn, idx in minibatch:
                            losses = fn(idx)
                            sp = spread.setdefault(f"{name}_kuu", {"loss_1": 0.0, "loss_20": 0.0})
                            for key, v in (("loss_1", losses[0]), ("loss_20", losses[-1])):
                                sp[key] = max(sp[key], abs(v - out[name][key]) / abs(out[name][key]))
                else:
                    saved = stats_perturbed(model, vff, seed)
                    got = {"gpr1d": gpr_values(model, xte, yte),
                           "vff": vff_values(vff, xte, yte)}
                    model.stats, vff.kuf_y, vff.kufkfu = saved
                    losses = adam_losses(basis, xtr, ytr, model.init_params(), minibatch[0][2],
                                         seed=seed)
                    sp = spread.setdefault("adam_stats", {"loss_1": 0.0, "loss_20": 0.0})
                    for key, v in (("loss_1", losses[0]), ("loss_20", losses[-1])):
                        sp[key] = max(sp[key], abs(v - out["adam"][key]) / abs(out["adam"][key]))
                for name in ("gpr1d", "vff"):
                    moves(out[name], got[name], spread[f"{name}_{kind}"])
        out["spread"] = spread
        out["spread_s"] = time.perf_counter() - t0
    print(json.dumps(out))


if __name__ == "__main__":
    main()
