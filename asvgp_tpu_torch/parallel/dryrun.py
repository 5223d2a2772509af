"""A dry run of data-parallel training: two steps of each model family on a
group of ranks.

The counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``,
with its shapes and seeds: the 1-D model (16 points a rank, B3 with m =
16), GPRKron and GPRAdditive at D = 2 (32 points a rank, B3 with m = 10 in
each dimension), each for two full-batch data-parallel Adam steps from the
initial parameters, with finite losses.  ``dryrun_multirank(n)`` runs it
on n NCCL ranks, one card each; ``dryrun_multirank(n, backend="gloo")`` on
n ranks on the CPU (the JAX function's n virtual devices).  Each rank also
reports whether ``jax`` was imported in its process.
"""

from __future__ import annotations

import math
import sys

import numpy as np

from asvgp_tpu_torch.parallel.dp import (
    make_dp_train_step,
    make_dp_train_step_additive,
    make_dp_train_step_kron,
    shard_data,
)
from asvgp_tpu_torch.parallel.launch import run_ranks
from asvgp_tpu_torch.train.adam import Adam


def synthetic_1d(n: int, seed: int = 0):
    """``__graft_entry__._synthetic``: x uniform on (0.02, 0.98), y = sin(8x)
    plus noise 0.1."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(0.02, 0.98, n)
    return x, np.sin(8.0 * x) + 0.1 * rng.randn(n)


def synthetic_2d(n: int, seed: int = 1):
    """The JAX dry run's 2-D data: X uniform on (0.05, 0.95)², y = sin(5x₁)
    cos(4x₂) plus noise 0.1."""
    rng = np.random.RandomState(seed)
    X = rng.uniform(0.05, 0.95, (n, 2))
    return X, np.sin(5 * X[:, 0]) * np.cos(4 * X[:, 1]) + 0.1 * rng.randn(n)


def dryrun_rank(rank: int, world: int, group, device) -> dict:
    """Two data-parallel steps of each family on this rank's shard; returns
    the losses of each step and whether this process imported ``jax``."""
    from asvgp_tpu_torch.basis import B3Spline
    from asvgp_tpu_torch.models import GPRAdditive, GPRKron, Matern32
    from asvgp_tpu_torch.models.gpr1d import default_params

    losses = {}
    n = 16 * world
    xs, ys = shard_data(*synthetic_1d(n), rank, world, device)
    step, opt = make_dp_train_step(B3Spline(0.0, 1.0, 16), 3, group,
                                   optimizer=Adam(1e-2), num_data_total=n)
    params = default_params(Matern32())
    state = opt.init(params)
    losses["gpr1d"] = []
    for _ in range(2):
        params, state, loss = step(params, state, xs, ys)
        losses["gpr1d"].append(float(loss))

    n2 = 32 * world
    X2, y2 = synthetic_2d(n2)
    bases = [B3Spline(0.0, 1.0, 10), B3Spline(0.0, 1.0, 10)]
    xs2, ys2 = shard_data(X2, y2, rank, world, device)
    for name, model_cls, make in (("kron", GPRKron, make_dp_train_step_kron),
                                  ("additive", GPRAdditive, make_dp_train_step_additive)):
        # the initial parameters as the model gives them (built on this
        # rank's shard: init_params does not read the data)
        model = model_cls((xs2.cpu().numpy(), ys2.cpu().numpy()), [Matern32()] * 2, bases,
                          noise_variance=0.1, device=device)
        step, opt = make(bases, model.nu2s, group, optimizer=Adam(1e-2), num_data_total=n2)
        params = model.init_params()
        state = opt.init(params)
        losses[name] = []
        for _ in range(2):
            params, state, loss = step(params, state, xs2, ys2)
            losses[name].append(float(loss))
    return {"losses": losses, "jax_imported": "jax" in sys.modules}


def dryrun_multirank(n_ranks: int, *, backend: str = "nccl", timeout: float = 300.0) -> dict:
    """``dryrun_rank`` on ``n_ranks`` ranks: NCCL on the first ``n_ranks``
    CUDA devices, or ``backend="gloo"`` on the CPU.  Raises unless every loss of
    every rank is finite and the ranks agree; returns rank 0's losses and
    each rank's ``jax_imported``."""
    out = run_ranks(dryrun_rank, n_ranks, backend=backend, timeout=timeout)
    for r in out:
        bad = {k: v for k, v in r["losses"].items() if not all(map(math.isfinite, v))}
        if bad:
            raise AssertionError(f"non-finite data-parallel losses: {bad}")
        if r["losses"] != out[0]["losses"]:
            raise AssertionError(f"the ranks' losses differ: {[o['losses'] for o in out]}")
    return {"ok": True, "losses": out[0]["losses"],
            "jax_imported": [r["jax_imported"] for r in out]}


def _numpy(tree):
    """A statistics dataclass or a params pytree as numpy arrays (float64)."""
    import dataclasses

    if dataclasses.is_dataclass(tree):
        return {f.name: getattr(tree, f.name).detach().cpu().numpy()
                for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy(v) for v in tree]
    return tree.detach().cpu().numpy()


def parity_rank(rank: int, world: int, group, device, cases: dict) -> dict:
    """The data-parallel paths on this rank, for a test that holds them to
    the unsharded build and to the JAX package.  ``cases`` (built by the
    caller, the same on every rank):

    - ``stats``: name -> (family, bases, X, y): ``pad_for_sharding`` to the
      world size, this rank's rows of (X, y, w), the weighted sharded build
      of the family ("gpr1d", "kron", "kron_nd", "additive");
    - ``steps``: name -> (family, bases, nu2s, X, y, params, n_steps):
      ``n_steps`` full-batch data-parallel Adam steps from ``params``;
    - ``fit``: (kernel, basis, X, y, max_iters): a GPR1D built with
      ``group`` on this rank's shard, and on rank 0 its ``fit_lbfgs``.

    On rank 0 also a group of one rank: the sharded statistics of each
    ``stats`` case unpadded and its steps, each against the same build or
    step without the ``all_reduce`` (``*_bit_equal``).  Every result comes
    back as numpy; ``dryrun`` is ``dryrun_rank``'s."""
    import torch
    import torch.distributed as dist

    from asvgp_tpu_torch.models import GPR1D
    from asvgp_tpu_torch.stats import (
        compute_additive_stats,
        compute_additive_stats_sharded,
        compute_kron_stats,
        compute_kron_stats_nd,
        compute_kron_stats_nd_sharded,
        compute_kron_stats_sharded,
        compute_stats,
        compute_stats_sharded_masked,
        pad_for_sharding,
    )
    from asvgp_tpu_torch.train import fit_lbfgs

    sharded = {"gpr1d": lambda b, x, y, g, w: compute_stats_sharded_masked(b, x, y, w, g),
               "kron": compute_kron_stats_sharded, "kron_nd": compute_kron_stats_nd_sharded,
               "additive": compute_additive_stats_sharded}
    local = {"gpr1d": compute_stats, "kron": compute_kron_stats,
             "kron_nd": compute_kron_stats_nd, "additive": compute_additive_stats}
    makers = {"gpr1d": make_dp_train_step, "kron": make_dp_train_step_kron,
              "additive": make_dp_train_step_additive}
    one = dist.new_group([0])  # every rank takes part in making it
    out = {"stats": {}, "steps": {}, "one": {}, "jax_imported": None}

    for name, (family, bases, X, y) in cases["stats"].items():
        xp, yp, w = pad_for_sharding(X, y, world)
        per = xp.shape[0] // world
        rows = slice(rank * per, (rank + 1) * per)
        stats = sharded[family](bases, xp[rows].to(device), yp[rows].to(device), group,
                                w[rows].to(device))
        out["stats"][name] = _numpy(stats)
        if rank == 0:
            xt, yt = torch.as_tensor(X).to(device), torch.as_tensor(y).reshape(-1).to(device)
            got = sharded[family](bases, xt, yt, one, None)
            want = local[family](bases, xt, yt)
            out["one"][f"stats_{name}"] = all(
                torch.equal(getattr(got, f), getattr(want, f)) for f in vars(want))

    for name, (family, bases, nu2s, X, y, params, n_steps) in cases["steps"].items():
        xs, ys = shard_data(X, y, rank, world, device)
        step, opt = makers[family](bases, nu2s, group, num_data_total=int(xs.shape[0]) * world)
        p, state, losses = params, opt.init(params), []
        for _ in range(n_steps):
            p, state, loss = step(p, state, xs, ys)
            losses.append(float(loss))
        out["steps"][name] = {"losses": losses, "params": _numpy(p)}
        if rank == 0:
            x1, y1 = shard_data(X, y, 0, 1, device)
            step1, opt1 = makers[family](bases, nu2s, one, num_data_total=int(x1.shape[0]))
            plain, _ = makers[family](bases, nu2s, None, num_data_total=int(x1.shape[0]))
            s1, s0 = opt1.init(params), opt1.init(params)
            _, _, l1 = step1(params, s1, x1, y1)
            _, _, l0 = plain(params, s0, x1, y1)
            out["one"][f"step_{name}"] = bool(torch.equal(l1, l0))

    kernel, basis, X, y, max_iters = cases["fit"]
    xs, ys = shard_data(X, y, rank, world)
    model = GPR1D((xs.numpy(), ys.numpy()), kernel, basis, device=device, group=group)
    out["fit"] = {"stats": _numpy(model.stats)}
    if rank == 0:  # the fit needs no collective: every rank would repeat it
        info = {}
        _, loss, iters = fit_lbfgs(model.training_loss, model.params(), max_iters=max_iters,
                                   info=info)
        out["fit"].update(loss=loss, iters=iters, evals=info["ls_evals"])
    out["dryrun"] = dryrun_rank(rank, world, group, device)
    out["jax_imported"] = "jax" in sys.modules
    return out

