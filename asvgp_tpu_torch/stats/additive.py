"""Sufficient statistics of the additive (sum-of-1-D-kernels) model.

PyTorch counterpart of ``asvgp_tpu/stats/additive.py`` (single device).
The (d, e) cross blocks of Kuf·Kufᵀ are dense (a point couples arbitrary
cell pairs across dimensions), so the full (M, M) matrix is stored, M =
Σ m_d.  It is assembled scatter-free as in the JAX package: each block
sorts the points by their joint (cell_d, cell_e) pair, and each of its
(k_d+1)(k_e+1) per-point products is summed per joint cell by a prefix sum
and the cell boundaries, then added into the block at its shift.  The sort
is stable and the prefix sums are the fixed-order ones of
stats/sufficient.py, so a second build on the GPU gives the same bits
(``index_add_`` with float64 atomics would not).
"""

from __future__ import annotations

import dataclasses

import torch

from asvgp_tpu_torch.stats.sufficient import (
    _prefix_sums,
    _stats_sorted,
    _totals,
    all_reduce_stats,
)


@dataclasses.dataclass
class AdditiveStats:
    kuf_y: torch.Tensor   # (M,)
    kufkfu: torch.Tensor  # (M, M) dense
    yty: torch.Tensor
    n: torch.Tensor


def _cell_sums(values: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """Per-cell sums of the rows of ``values`` (p, n), sorted by cell, given
    the cell boundaries (n_cells + 1,): (p, n_cells)."""
    c = _prefix_sums(values)
    return c[:, bounds[1:]] - c[:, bounds[:-1]]


def _cross_block(v_d, c_d, nc_d: int, m_d: int, v_e, c_e, nc_e: int, m_e: int) -> torch.Tensor:
    """Dense (m_d, m_e) block: Σ_i v_d[i, s] v_e[i, t] at (c_d+s, c_e+t)."""
    kd, ke = v_d.shape[1], v_e.shape[1]
    joint = c_d * nc_e + c_e
    order = torch.argsort(joint, stable=True)
    v_d, v_e, joint_s = v_d[order], v_e[order], joint[order]
    bounds = torch.searchsorted(
        joint_s, torch.arange(nc_d * nc_e + 1, dtype=joint_s.dtype, device=joint_s.device))
    products = torch.stack([v_d[:, s] * v_e[:, t] for s in range(kd) for t in range(ke)])
    sums = _cell_sums(products, bounds).reshape(kd, ke, nc_d, nc_e)
    out = v_d.new_zeros((m_d, m_e))
    for s in range(kd):
        for t in range(ke):
            out[s:s + nc_d, t:t + nc_e] += sums[s, t]
    return out


def compute_additive_stats(bases, X: torch.Tensor, y: torch.Tensor, w=None) -> AdditiveStats:
    """Sufficient statistics of (X (n, D), y) on their device, in their
    dtype: Kuf·y per dimension by the 1-D sorted path, and the dense
    KufKfu block by block (the upper blocks built, the lower ones their
    transposes).  ``w`` (n,) optionally weights the points (0/1), carried by
    every dimension's basis weights as in the JAX package."""
    D = len(bases)
    yf = y.reshape(-1)
    evals = [b.evaluate_basis(X[:, d], dx=0) for d, b in enumerate(bases)]
    if w is not None:
        evals = [(v * w[:, None], c) for v, c in evals]
    yty, n = _totals(yf, w)

    kuf_y = torch.cat([_stats_sorted(bases[d].m, *evals[d], yf)[0] for d in range(D)])

    offs = [0]
    for b in bases:
        offs.append(offs[-1] + b.m)
    kk = yf.new_zeros((offs[-1], offs[-1]))
    for d in range(D):
        v_d, c_d = evals[d]
        for e in range(d, D):
            v_e, c_e = evals[e]
            blk = _cross_block(v_d, c_d, bases[d].n_cells, bases[d].m,
                               v_e, c_e, bases[e].n_cells, bases[e].m)
            kk[offs[d]:offs[d + 1], offs[e]:offs[e + 1]] += blk
            if e != d:
                kk[offs[e]:offs[e + 1], offs[d]:offs[d + 1]] += blk.T
    return AdditiveStats(kuf_y=kuf_y, kufkfu=kk, yty=yty, n=n)


def compute_additive_stats_sharded(bases, X, y, group, w=None) -> AdditiveStats:
    """Data-parallel statistics: (X, y) (and the weights ``w``) are this
    rank's shard, summed over ``group`` by one ``all_reduce``."""
    return all_reduce_stats(compute_additive_stats(bases, X, y, w), group)
