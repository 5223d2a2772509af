"""Data-parallel training over a ``torch.distributed`` process group.

PyTorch counterpart of ``asvgp_tpu/parallel/dp.py``.  The sufficient
statistics of every model family are sums over data points, so the
parallelism is data parallelism: each rank holds its own shard of (X, y)
(``shard_data``), builds the partial statistics of its shard, and one
``all_reduce`` (SUM) over the group adds them (the ``*_sharded`` functions
of ``stats/``); the collapsed ELBO, its gradient and the optimizer step
then run replicated on every rank, on the tiny statistics.  The JAX
package's mesh and ``psum`` become a process group and an ``all_reduce``:
one process per rank, rank r on ``cuda:r`` over NCCL, or on the CPU over
gloo when the caller asks for it (``parallel.launch.run_ranks``).  The
group is always passed explicitly.
"""

from __future__ import annotations

import torch

from asvgp_tpu_torch.models.additive import additive_collapsed_elbo
from asvgp_tpu_torch.models.kron import kron_collapsed_elbo
from asvgp_tpu_torch.stats.additive import compute_additive_stats
from asvgp_tpu_torch.stats.kron import compute_kron_stats
from asvgp_tpu_torch.stats.kron_nd import compute_kron_stats_nd
from asvgp_tpu_torch.stats.sufficient import all_reduce_stats, compute_stats, rescale_stats
from asvgp_tpu_torch.train.adam import Adam, collapsed_loss
from asvgp_tpu_torch.train.lbfgs import _leaves, _unflatten, tree_map


def shard_data(X, y, rank: int, world: int, device=None):
    """This rank's rows of (X, y): the ``rank``-th of ``world`` equal
    contiguous blocks along the leading axis, as the JAX mesh's data axis
    partitions them.  X (n,) or (n, 1) comes back as (n / world,), X (n, D)
    with D ≥ 2 as (n / world, D); y flat.  N must divide by ``world``
    (pad first with ``stats.pad_for_sharding`` otherwise)."""
    x = torch.as_tensor(X)
    if x.ndim != 2 or x.shape[1] == 1:
        x = x.reshape(-1)
    yf = torch.as_tensor(y).reshape(-1)
    n = x.shape[0]
    if yf.shape[0] != n:
        raise ValueError("X and y must have the same number of points")
    if n % world:
        raise ValueError(f"{n} points do not divide into {world} shards: pad them with "
                         "stats.pad_for_sharding and build the masked statistics")
    per = n // world
    x, yf = x[rank * per:(rank + 1) * per], yf[rank * per:(rank + 1) * per]
    return (x, yf) if device is None else (x.to(device), yf.to(device))


def place(tree, device: torch.device):
    """Every tensor and array leaf of a pytree on ``device`` (numpy arrays
    become tensors; Python numbers stay as they are).  Each leaf is placed
    and then checked on its own, not judged by the first one."""
    def put(leaf):
        if isinstance(leaf, (bool, int, float)):
            return leaf
        return torch.as_tensor(leaf).to(device)

    out = tree_map(put, tree)
    stray = {str(t.device) for t in _leaves(out)
             if isinstance(t, torch.Tensor) and t.device != device}
    if stray:
        raise RuntimeError(f"leaves left on {sorted(stray)}, not on {device}")
    return out


def _make_step(stats_fn, loss_fn, group, optimizer, num_data_total):
    opt = optimizer if optimizer is not None else Adam(1e-2)

    def step(params, opt_state, x, y):
        device = x.device
        params = place(params, device)
        opt_state = place(opt_state, device)
        stats = stats_fn(x, y)
        if group is not None:
            stats = all_reduce_stats(stats, group)
        if num_data_total is not None:
            stats = rescale_stats(stats, num_data_total)
        leaves = [p.detach().requires_grad_() for p in _leaves(params)]
        with torch.enable_grad():
            loss = loss_fn(_unflatten(params, iter(leaves)), stats)
            grads = torch.autograd.grad(loss, leaves)
        updates, opt_state = opt.update(_unflatten(params, iter(grads)), opt_state)
        params = opt.apply(_unflatten(params, (p.detach() for p in leaves)), updates)
        return params, opt_state, loss.detach()

    return step, opt


def make_dp_train_step(basis, nu2: int, group, *, optimizer=None, num_data_total=None):
    """A data-parallel training step of the 1-D model.

    Returns ``(step, opt)``: ``step(params, opt_state, x_local, y_local) ->
    (params, opt_state, loss)`` builds this rank's statistics, sums them over
    ``group`` (one ``all_reduce``) and takes one optimizer step on the
    negative collapsed ELBO, on the device of ``x_local``; ``opt.init(params)``
    gives the first ``opt_state``.  The optimizer defaults to Adam with
    optax's defaults (lr 1e-2, β 0.9 / 0.999, ε 1e-8).  With
    ``num_data_total`` the statistics are rescaled by N_total / n, the
    stochastic (minibatch) bound.  ``group=None`` is the same step on this
    process's data alone, without the ``all_reduce``.  On a CUDA device the
    loss runs K1 + K2 and its gradient K7 + K8."""
    return _make_step(lambda x, y: compute_stats(basis, x, y),
                      lambda p, s: collapsed_loss(basis, nu2, p, s),
                      group, optimizer, num_data_total)


def make_dp_train_step_kron(bases, nu2s, group, *, optimizer=None, num_data_total=None):
    """``make_dp_train_step`` for GPRKron at any D ≥ 2 (the statistics of
    stats/kron.py at D = 2, of stats/kron_nd.py beyond, as the JAX package
    dispatches them): the block-banded ELBO runs replicated."""
    build = compute_kron_stats if len(bases) == 2 else compute_kron_stats_nd
    return _make_step(lambda x, y: build(bases, x, y),
                      lambda p, s: -kron_collapsed_elbo(bases, nu2s, p, s),
                      group, optimizer, num_data_total)


def make_dp_train_step_additive(bases, nu2s, group, *, optimizer=None, num_data_total=None):
    """``make_dp_train_step`` for GPRAdditive."""
    return _make_step(lambda x, y: compute_additive_stats(bases, x, y),
                      lambda p, s: -additive_collapsed_elbo(bases, nu2s, p, s),
                      group, optimizer, num_data_total)
