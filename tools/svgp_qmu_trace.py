"""Where the port's ``fit_svgp`` and the JAX package's SVGP loop part, step
by step, at the north star.

The north star's SVGP run, as ``chip_smoke.py`` drives it: bench.py's data
(``bench_data(10**6, 0)``), ``B3Spline(0, 1, 10_000)``, ``Matern32(1.0,
1e-3)``, noise 0.1, batch 100, learning rate 1e-3, 20 Adam steps on the
indices ``RandomState(3).randint(0, N, (20, 100))``, from ``init_params()``
with the C* seeding.  Both sides run on a CPU in float64:

  * the port's ``fit_svgp`` (the plain versions of K9–K12), its parameters
    and gradients read after every Adam step through a step hook;
  * the JAX package's SVGP1D on the scan route (``set_impl("scan")``), the
    seeding of ``asvgp_tpu.models.svgp.fit_svgp`` and its step (one
    ``jax.value_and_grad`` of ``training_loss``, ``optax.adam``) on the same
    indices.

For every step it reports the loss, each parameter leaf and each gradient
leaf as the largest difference relative to the largest JAX value, and for
``q_mu`` the entries that part most: their index, both values, both
gradients, whether any batch so far touched that feature (the spline
windows of the points drawn), and the smallest |gradient| there.  The
first step where a leaf parts by more than 1e-12 is named.

Run from the repository root (a few GB of memory, several minutes):

    python tools/svgp_qmu_trace.py [--steps 20] [--m 10000] [--n 1000000]

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

from asvgp_tpu.banded import ops as jops  # noqa: E402
from asvgp_tpu.basis import B3Spline as JB3Spline  # noqa: E402
from asvgp_tpu.models import Matern32 as JMatern32  # noqa: E402
from asvgp_tpu.models.parameters import positive as jpositive  # noqa: E402
from asvgp_tpu.models.svgp import SVGP1D as JSVGP1D  # noqa: E402
from asvgp_tpu.stats.sufficient import compute_stats as jcompute_stats  # noqa: E402

BATCH, LR, INDEX_SEED = 100, 1e-3, 3
TOP = 5


def bench_data(n, seed):
    """bench.py's generator: ~700 periods on (0.005, 0.995), noise 0.3."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(0.005, 0.995, n)
    y = np.sin(4400.0 * x) + 0.5 * np.sin(1100.0 * x) + 0.3 * rng.randn(n)
    return x, y


def leaves(tree, prefix=()):
    """(path, array) of every leaf of a params tree, keys in sorted order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from leaves(tree[key], prefix + (key,))
    else:
        yield "/".join(prefix), np.asarray(tree, dtype=np.float64)


def jax_trace(x, y, m, idx):
    """The JAX package's seeding and Adam loop on ``idx``: per step (loss,
    params, grads), params and grads as {path: array}."""
    jops.set_impl("scan")
    model = JSVGP1D(JMatern32(1.0, 1e-3), JB3Spline(0.0, 1.0, m), noise_variance=0.1,
                    num_data=x.shape[0])
    params = model.init_params()
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    # asvgp_tpu/models/svgp.py fit_svgp's seeding: C* = chol(KufKfu + 1e-10
    # max diag)/σ at the initial noise, padded to the correction's bandwidth
    stats = jax.jit(lambda a, b: jcompute_stats(model.basis, a, b))(xj, yj)
    sigma0 = jnp.sqrt(jpositive(params["likelihood"]["raw_variance"]))
    band = stats.kufkfu_band
    band = band.at[0].add(1e-10 * jnp.max(band[0]))
    c0 = jops.cholesky_band(band) / sigma0
    kq, ko = params["q_prec_corr"].shape[0] - 1, c0.shape[0] - 1
    if kq > ko:
        c0 = jnp.concatenate([c0, jnp.zeros((kq - ko, c0.shape[1]), c0.dtype)], axis=0)
    params = {**params, "q_prec_corr": c0[: kq + 1]}
    opt = optax.adam(LR)
    state = opt.init(params)
    value_and_grad = jax.jit(jax.value_and_grad(model.training_loss))
    out = []
    for step_idx in idx:
        loss, grads = value_and_grad(params, xj[step_idx], yj[step_idx])
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        out.append((float(loss), dict(leaves(params)), dict(leaves(grads))))
    return out


def port_trace(x, y, m, idx):
    """The port's ``fit_svgp`` on ``idx`` on the CPU: per step (loss, params,
    grads), read by a hook after every optimizer step."""
    import torch
    from torch.optim.optimizer import register_optimizer_step_post_hook

    from asvgp_tpu_torch.basis import B3Spline
    from asvgp_tpu_torch.models import SVGP1D, Matern32, fit_svgp
    from asvgp_tpu_torch.train.lbfgs import _unflatten

    model = SVGP1D(Matern32(1.0, 1e-3), B3Spline(0.0, 1.0, m), noise_variance=0.1,
                   num_data=x.shape[0], device="cpu")
    template = model.init_params()
    seen = []

    def hook(opt, args, kwargs):
        ps = opt.param_groups[0]["params"]
        seen.append((dict(leaves(_unflatten(template, (p.detach().clone() for p in ps)))),
                     dict(leaves(_unflatten(template, (p.grad.detach().clone() for p in ps))))))

    handle = register_optimizer_step_post_hook(hook)
    try:
        _, losses = fit_svgp(model, x, y, template, batch_size=BATCH, steps=idx.shape[0],
                             learning_rate=LR, device="cpu", indices=idx)
    finally:
        handle.remove()
    return [(float(loss), p, g) for loss, (p, g) in zip(losses.tolist(), seen)]


def touched_features(x, m, idx_so_far):
    """Features whose spline window holds a point drawn so far."""
    import torch

    from asvgp_tpu_torch.basis import B3Spline
    from asvgp_tpu_torch.features.spline_features import make_kuf

    basis = B3Spline(0.0, 1.0, m)
    vals, start = make_kuf(basis, torch.as_tensor(x[np.unique(idx_so_far)]))
    width = vals.shape[-1]
    cols = start.numpy()[:, None] + np.arange(width)[None, :]
    mask = np.zeros(m, bool)
    mask[cols[(cols >= 0) & (cols < m)]] = True
    return mask


def rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--m", type=int, default=10_000)
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()
    x, y = bench_data(args.n, 0)
    idx = np.random.RandomState(INDEX_SEED).randint(0, args.n, size=(args.steps, BATCH))
    t0 = time.perf_counter()
    ref = jax_trace(x, y, args.m, idx)
    t1 = time.perf_counter()
    got = port_trace(x, y, args.m, idx)
    t2 = time.perf_counter()

    steps, first_part = [], {}
    for s, ((loss_g, p_g, g_g), (loss_r, p_r, g_r)) in enumerate(zip(got, ref), start=1):
        row = {"step": s, "loss": loss_g, "loss_jax": loss_r,
               "loss_rel": abs(loss_g - loss_r) / abs(loss_r),
               "param_rel": {k: rel(p_g[k], p_r[k]) for k in p_r},
               "grad_rel": {k: rel(g_g[k], g_r[k]) for k in g_r}}
        for k, v in row["param_rel"].items():
            if v > 1e-12 and k not in first_part:
                first_part[k] = s
        diff = np.abs(p_g["q_mu"] - p_r["q_mu"])
        touched = touched_features(x, args.m, idx[:s])
        row["q_mu_touched_features"] = int(touched.sum())
        row["q_mu_top"] = [
            {"i": int(i), "port": float(p_g["q_mu"][i]), "jax": float(p_r["q_mu"][i]),
             "abs_diff": float(diff[i]), "grad_port": float(g_g["q_mu"][i]),
             "grad_jax": float(g_r["q_mu"][i]), "touched": bool(touched[i])}
            for i in np.argsort(diff)[::-1][:TOP]]
        untouched = ~touched
        row["q_mu_max_abs_diff"] = {"touched": float(diff[touched].max(initial=0.0)),
                                    "untouched": float(diff[untouched].max(initial=0.0))}
        row["q_mu_grad_abs_max"] = {
            "touched": float(np.abs(g_r["q_mu"][touched]).max(initial=0.0)),
            "untouched": float(np.abs(g_r["q_mu"][untouched]).max(initial=0.0))}
        row["q_mu_grad_abs_diff_max"] = {
            "touched": float(np.abs(g_g["q_mu"] - g_r["q_mu"])[touched].max(initial=0.0)),
            "untouched": float(np.abs(g_g["q_mu"] - g_r["q_mu"])[untouched].max(initial=0.0))}
        steps.append(row)
    print(json.dumps({"n": args.n, "m": args.m, "batch": BATCH, "lr": LR,
                      "index_seed": INDEX_SEED, "jax_seconds": t1 - t0,
                      "port_seconds": t2 - t1, "first_step_parted_1e-12": first_part,
                      "steps": steps}))


if __name__ == "__main__":
    main()
