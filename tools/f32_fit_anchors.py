"""Float32 fit anchors: the JAX package's ``fit_lbfgs`` and minibatch Adam
on its float32 model, and how far one float32 rounding of their inputs
moves them.

The PyTorch port fits a float32 ``GPR1D`` with ``fit_lbfgs`` and runs
``fit_adam_minibatch(..., dtype=torch.float32)``; ``chip_smoke.py`` (phase
6t) and ``tests/test_torch_f32_train.py`` hold those runs to these numbers.
Everything runs on a CPU with ``set_impl("scan")``, the float32 runs under
``jax.enable_x64(False)`` as the JAX package runs its float32 route:

- ``snelson``: GPR1D on the Snelson data, B3 on [-3.5, 10.5], m = 100,
  Matérn-3/2, noise 1 (the JAX script's defaults), statistics in float64
  cast once to float32, ``fit_lbfgs`` with up to ``--snelson-iters``
  iterations (default 500): loss, parameters (ℓ, σ², noise, raw),
  iterations, evaluations, grad_norm, converged;
- ``north_star``: bench.py's data and shape (``bench_data(n, 0)``,
  ``B3Spline(0, 1, m)``, ``Matern32(1.0, 1e-3)``, noise 0.1),
  ``fit_lbfgs(max_iters=10, curv_rtol=10.0)``: the same quantities;
- ``adam``: the loop of ``fit_adam_minibatch`` at the north star's data
  and width, ``--adam-steps`` (20) steps at batch ``--adam-batch`` (4096),
  learning rate 1e-2, on ``RandomState(2)`` indices: the losses at the
  first and the last step and the parameters after the last.

Each run also as the JAX package's float64 run (x64 on), for its loss.

``--spread R`` repeats each float32 run R times with its inputs moved by one
float32 rounding: every entry of the float32 statistics (for Adam: of each
batch's rescaled statistics) and of the initial parameters times
(1 + s·2⁻²⁴), s = ±1 at random from ``RandomState(SPREAD_SEED + r)`` for
repeat r, rounded to float32.  ``spread`` records, for every quantity, the
largest relative move from the unperturbed run, and whether the iteration
and evaluation counts and ``converged`` stayed as they were.

``--port`` runs the same fits with the port's plain versions on the CPU
and records each quantity's distance from the JAX float32 values
(``port_rel``) beside ``10 × spread``.

Run from the repository root (the north star needs a few GB and minutes;
``--n 20000 --m 500 --adam-batch 1024 --adam-steps 5 --snelson-iters 30``
is the tests' cut):

    python tools/f32_fit_anchors.py [--spread 4] [--port] [--runs snelson,north_star,adam]

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
import optax  # noqa: E402

from asvgp_tpu.banded import ops  # noqa: E402
from asvgp_tpu.basis import B3Spline  # noqa: E402
from asvgp_tpu.features.spline_features import make_kuu  # noqa: E402
from asvgp_tpu.models import GPR1D, Matern32  # noqa: E402
from asvgp_tpu.models.gpr1d import (  # noqa: E402
    collapsed_elbo_banded,
    default_params,
    params_to_kernel,
    params_to_likelihood,
)
from asvgp_tpu.stats.sufficient import SufficientStats, _stats_local  # noqa: E402
from asvgp_tpu.train import fit_lbfgs  # noqa: E402

SNELSON_DIR = os.path.join(os.path.dirname(__file__), "..", "data", "snelson")
SPREAD_SEED = 100
ADAM_LR, ADAM_INDEX_SEED = 1e-2, 2
# (ℓ, σ², noise): the raw parameters in this order everywhere
PARAM_PATHS = (("kernel", "raw_lengthscales"), ("kernel", "raw_variance"),
               ("likelihood", "raw_variance"))


def bench_data(n, seed):
    """bench.py's generator: ~700 periods on (0.005, 0.995), noise 0.3."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(0.005, 0.995, n)
    y = np.sin(4400.0 * x) + 0.5 * np.sin(1100.0 * x) + 0.3 * rng.randn(n)
    return x, y


def snelson_data():
    x = np.loadtxt(os.path.join(SNELSON_DIR, "train_inputs")).reshape(-1, 1)
    y = np.loadtxt(os.path.join(SNELSON_DIR, "train_outputs")).reshape(-1, 1)
    return x, y


def index_stream(seed, steps, batch, n):
    """(steps, batch) minibatch indices drawn with numpy from ``seed``, as
    chip_smoke.py ``index_stream``."""
    return np.random.RandomState(seed).randint(0, n, size=(steps, batch))


def raw(params) -> list:
    return [float(np.asarray(params[g][k]).reshape(-1)[0]) for g, k in PARAM_PATHS]


def sign_tree(tree, seed):
    """±1 arrays shaped like the leaves of ``tree`` (a fixed draw per seed)."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda a: rng.choice([-1.0, 1.0], size=np.shape(a)), tree)


def moved(a, s):
    """``a`` (float32) times (1 + s·2⁻²⁴), rounded to float32: ``a`` moved by
    about one rounding.  ``a·2⁻²⁴`` is exact, so the sum rounds once, as
    the product in float64 would; this form also runs under x64 off."""
    a = jnp.asarray(a, jnp.float32)
    return a + jnp.asarray(s, jnp.float32) * (a * jnp.float32(2.0 ** -24))


def f32_tree(tree):
    return jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float32), tree)


def snelson_model(f32: bool):
    x, y = snelson_data()
    return GPR1D((x, y), Matern32(), B3Spline(-3.5, 10.5, 100),
                 dtype=jnp.float32 if f32 else None)


def north_star_model(n, m, f32: bool):
    x, y = bench_data(n, 0)
    return GPR1D((x, y), Matern32(1.0, 1e-3), B3Spline(0.0, 1.0, m), noise_variance=0.1,
                 dtype=jnp.float32 if f32 else None)


def fit(model, f32: bool, seed=None, **kw) -> dict:
    """``fit_lbfgs`` from ``init_params()``; with a ``seed``, the float32
    statistics and the initial parameters moved by one rounding."""
    stats0 = model.stats
    if seed is not None:
        model.stats = jax.tree.map(moved, stats0, sign_tree(stats0, seed))
    try:
        with jax.enable_x64(not f32):
            p0 = f32_tree(model.init_params()) if f32 else model.init_params()
            if seed is not None:
                p0 = jax.tree.map(moved, p0, sign_tree(p0, seed + 10_000))
            info = {}
            # a fresh function, so that the trace reads the statistics as
            # they are now
            params, loss, iters = fit_lbfgs(jax.jit(lambda p: model.training_loss(p)), p0,
                                            info=info, **kw)
            assert params["kernel"]["raw_variance"].dtype == (jnp.float32 if f32 else jnp.float64)
    finally:
        model.stats = stats0
    return {"loss": float(loss), "params": raw(params), "iters": int(iters),
            "evals": int(info["ls_evals"]), "grad_norm": float(info["grad_norm"]),
            "converged": bool(info["converged"])}


def adam(n, m, steps, batch, f32: bool, seed=None) -> dict:
    """fit_adam_minibatch's loop (asvgp_tpu/train/adam.py) on given indices:
    the losses of the first and last step, the final parameters."""
    x, y = bench_data(n, 0)
    basis = B3Spline(0.0, 1.0, m)
    idx = index_stream(ADAM_INDEX_SEED, steps, batch, n)
    dt = jnp.float32 if f32 else jnp.float64
    with jax.enable_x64(not f32):
        xd, yd = jnp.asarray(x, dt), jnp.asarray(y, dt)
        p0 = default_params(Matern32(1.0, 1e-3), 0.1)
        p0 = f32_tree(p0) if f32 else jax.tree.map(jnp.asarray, p0)
        signs = None
        if seed is not None:
            p0 = jax.tree.map(moved, p0, sign_tree(p0, seed + 10_000))
            signs = sign_tree(SufficientStats(kuf_y=np.zeros(m), kufkfu_band=np.zeros((4, m)),
                                              yty=np.zeros(()), n=np.zeros(())), seed)
        opt = optax.adam(ADAM_LR)

        def loss_fn(p, xb, yb):
            stats = _stats_local(basis, xb, yb)
            scale = jnp.asarray(n, dt) / stats.n
            stats = SufficientStats(kuf_y=stats.kuf_y * scale,
                                    kufkfu_band=stats.kufkfu_band * scale,
                                    yty=stats.yty * scale, n=stats.n * scale)
            if signs is not None:
                stats = jax.tree.map(moved, stats, signs)
            kernel, lik = params_to_kernel(p, 3), params_to_likelihood(p)
            return -collapsed_elbo_banded(stats, make_kuu(kernel, basis), lik.variance,
                                          stats.n * kernel.variance)

        @jax.jit
        def step(p, state, i):
            loss, grads = jax.value_and_grad(loss_fn)(p, xd[i], yd[i])
            updates, state = opt.update(grads, state, p)
            return optax.apply_updates(p, updates), state, loss

        p, state, losses = p0, opt.init(p0), []
        for i in idx:
            p, state, loss = step(p, state, jnp.asarray(i))
            losses.append(float(loss))
        assert loss.dtype == dt
    return {"loss_1": losses[0], "loss_last": losses[-1], "losses": losses, "params": raw(p)}


def port_fit(model, **kw) -> dict:
    from asvgp_tpu_torch.train import fit_lbfgs as tfit

    info = {}
    params, loss, iters = tfit(model.training_loss, model.init_params(), info=info, **kw)
    return {"loss": loss, "params": raw({g: {k: v.numpy() for k, v in d.items()}
                                         for g, d in params.items()}),
            "iters": iters, "evals": info["ls_evals"], "grad_norm": info["grad_norm"],
            "converged": info["converged"]}


def port_model(name, args):
    import torch

    from asvgp_tpu_torch.basis import B3Spline as TB3Spline
    from asvgp_tpu_torch.models import GPR1D as TGPR1D
    from asvgp_tpu_torch.models import Matern32 as TMatern32

    if name == "snelson":
        x, y = snelson_data()
        return TGPR1D((x, y), TMatern32(), TB3Spline(-3.5, 10.5, 100), device="cpu",
                      dtype=torch.float32)
    x, y = bench_data(args.n, 0)
    return TGPR1D((x, y), TMatern32(1.0, 1e-3), TB3Spline(0.0, 1.0, args.m),
                  noise_variance=0.1, device="cpu", dtype=torch.float32)


def port_adam(args) -> dict:
    import torch

    from asvgp_tpu_torch.basis import B3Spline as TB3Spline
    from asvgp_tpu_torch.models import Matern32 as TMatern32
    from asvgp_tpu_torch.models.gpr1d import default_params as tdefault
    from asvgp_tpu_torch.train import fit_adam_minibatch

    x, y = bench_data(args.n, 0)
    idx = index_stream(ADAM_INDEX_SEED, args.adam_steps, args.adam_batch, args.n)
    params, losses = fit_adam_minibatch(
        TB3Spline(0.0, 1.0, args.m), 3, x, y, tdefault(TMatern32(1.0, 1e-3), 0.1),
        batch_size=args.adam_batch, steps=args.adam_steps, learning_rate=ADAM_LR,
        indices=idx, device="cpu", dtype=torch.float32)
    losses = losses.tolist()
    return {"loss_1": losses[0], "loss_last": losses[-1], "losses": losses,
            "params": raw({g: {k: v.numpy() for k, v in d.items()} for g, d in params.items()})}


def rel(a, b):
    return abs(a - b) / abs(b)


def moves(runs, base) -> dict:
    """The largest relative move of each quantity over ``runs`` from
    ``base``; for the fits whether the counts and ``converged`` held."""
    out = {}
    for key in ("loss", "loss_1", "loss_last", "grad_norm"):
        if key in base:
            out[key] = max(rel(r[key], base[key]) for r in runs)
    out["params"] = [max(rel(r["params"][i], base["params"][i]) for r in runs)
                     for i in range(len(PARAM_PATHS))]
    for key in ("iters", "evals", "converged"):
        if key in base:
            out[f"{key}_fixed"] = all(r[key] == base[key] for r in runs)
            out[f"{key}_seen"] = sorted({r[key] for r in runs} | {base[key]})
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", default="snelson,north_star,adam")
    ap.add_argument("--spread", type=int, default=4)
    ap.add_argument("--port", action="store_true",
                    help="also run the port's float32 fits on the CPU and report their distances")
    ap.add_argument("--no-f64", action="store_true", help="skip the float64 runs")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--m", type=int, default=10_000)
    ap.add_argument("--snelson-iters", type=int, default=500)
    ap.add_argument("--north-star-iters", type=int, default=10)
    ap.add_argument("--adam-steps", type=int, default=20)
    ap.add_argument("--adam-batch", type=int, default=4096)
    args = ap.parse_args()
    ops.set_impl("scan")
    runs = args.runs.split(",")
    out = {"args": vars(args)}
    t_all = time.perf_counter()
    for name in runs:
        t0 = time.perf_counter()
        if name == "adam":
            def one(f32, seed=None):
                return adam(args.n, args.m, args.adam_steps, args.adam_batch, f32, seed)
        else:
            kw = ({"max_iters": args.snelson_iters} if name == "snelson"
                  else {"max_iters": args.north_star_iters, "curv_rtol": 10.0})
            model = snelson_model(True) if name == "snelson" else \
                north_star_model(args.n, args.m, True)

            def one(f32, seed=None, model=model, kw=kw, name=name):
                if f32:
                    return fit(model, True, seed, **kw)
                f64 = snelson_model(False) if name == "snelson" else \
                    north_star_model(args.n, args.m, False)
                return fit(f64, False, **kw)
        res = {"f32": one(True)}
        if not args.no_f64:
            res["f64"] = one(False)
            key = "loss" if "loss" in res["f32"] else "loss_last"
            res["f32_vs_f64"] = rel(res["f32"][key], res["f64"][key])
        if args.spread:
            repeats = [one(True, SPREAD_SEED + r) for r in range(args.spread)]
            res["repeats"] = repeats
            res["spread"] = moves(repeats, res["f32"])
        if args.port:
            t1 = time.perf_counter()
            res["port"] = port_adam(args) if name == "adam" else \
                port_fit(port_model(name, args), **kw)
            res["port_seconds"] = time.perf_counter() - t1
            res["port_rel"] = moves([res["port"]], res["f32"])
        res["seconds"] = time.perf_counter() - t0
        out[name] = res
        print(json.dumps({name: res}), file=sys.stderr, flush=True)
    out["seconds"] = time.perf_counter() - t_all
    print(json.dumps(out))


if __name__ == "__main__":
    main()
