"""Kronecker (tensor-product) sufficient statistics of the 2-D model.

PyTorch counterpart of ``asvgp_tpu/stats/kron.py`` (single device).  The
joint Kuf column of a point is the outer product of its per-dimension
spline weights, so Kuf·y is a (k₁+1)(k₂+1)-entry windowed sum per point
and KufKfu is banded in both dimensions.  It is stored as the multiband

  T[p, o₂+k₂, q₁, q₂] = Σ_points w₁[s₁] w₁[s₁+p] w₂[s₂] w₂[s₂+o₂]
      over s₁, s₂ with q₁ = c₁+s₁, q₂ = c₂+s₂
  (p = i₁−j₁ in 0..k₁; o₂ = i₂−j₂ in −k₂..k₂)

of shape (k₁+1, 2k₂+1, m₁, m₂).  The build sorts the points once by joint
mesh cell; every series is a product of two per-dimension pair products
(unordered pairs: 15 × 15 = 225 series at order 4), summed per cell by
prefix sums and cell boundaries in blocks of about 128 series, so that a
block at N = 2·10⁶ is about 2 GB of float64.  The prefix sums are the
fixed-order ones of stats/sufficient.py, so a second build on the GPU
gives the same bits.
"""

from __future__ import annotations

import dataclasses

import torch

from asvgp_tpu_torch.stats.sufficient import _prefix_sums, _totals, all_reduce_stats


@dataclasses.dataclass
class KronStats:
    kuf_y: torch.Tensor   # (m1*m2,)
    t_band: torch.Tensor  # (k1+1, 2*k2+1, m1, m2) multiband of Kuf Kufᵀ
    yty: torch.Tensor
    n: torch.Tensor


def _pairs(k: int):
    """Unordered index pairs (a, b), a <= b, over 0..k."""
    return [(a, b) for a in range(k + 1) for b in range(a, k + 1)]


def compute_kron_stats(bases, X: torch.Tensor, y: torch.Tensor, w=None) -> KronStats:
    """Sufficient statistics of (X (n, 2), y) on their device, in their
    dtype: the batched pair-product build of the JAX package
    (stats/kron.py:53-143).  ``w`` (n,) optionally weights the points (0/1),
    folded into dimension 1's basis weights as the JAX package folds it."""
    b1, b2 = bases
    k1, k2 = b1.order, b2.order
    m1, m2 = b1.m, b2.m
    nc1, nc2 = b1.n_cells, b2.n_cells
    yf = y.reshape(-1)
    n = yf.shape[0]

    v1, c1 = b1.evaluate_basis(X[:, 0], dx=0)
    v2, c2 = b2.evaluate_basis(X[:, 1], dx=0)
    if w is not None:
        v1 = v1 * w[:, None]
    yty, n_t = _totals(yf, w)

    # sort once by joint cell
    joint = c1 * nc2 + c2
    order = torch.argsort(joint, stable=True)
    v1, v2, ys, joint_s = v1[order], v2[order], yf[order], joint[order]
    ncells = nc1 * nc2
    bounds = torch.searchsorted(
        joint_s, torch.arange(ncells + 1, dtype=joint_s.dtype, device=joint_s.device))

    pairs1, pairs2 = _pairs(k1), _pairs(k2)
    p1idx = {p: i for i, p in enumerate(pairs1)}
    p2idx = {p: i for i, p in enumerate(pairs2)}
    np1, np2 = len(pairs1), len(pairs2)

    p1 = torch.stack([v1[:, a] * v1[:, b] for a, b in pairs1], dim=0)  # (np1, n)
    p2 = torch.stack([v2[:, a] * v2[:, b] for a, b in pairs2], dim=0)  # (np2, n)
    y1 = v1.T * ys  # (k1+1, n)

    def cell_block(rows):
        """(c, n) series -> (c, nc1, nc2) per-cell sums."""
        c = _prefix_sums(rows)
        return (c[:, bounds[1:]] - c[:, bounds[:-1]]).reshape(rows.shape[0], nc1, nc2)

    g = max(1, 128 // np2)
    grid = torch.cat([
        cell_block((p1[i0:i0 + g, None, :] * p2[None, :, :]).reshape(-1, n))
        for i0 in range(0, np1, g)
    ])  # (np1*np2, nc1, nc2), series i*np2 + j
    gy = cell_block((y1[:, None, :] * v2.T[None, :, :]).reshape(-1, n))  # s1*(k2+1) + s2

    kuf_y = v1.new_zeros((m1, m2))
    for s1 in range(k1 + 1):
        for s2 in range(k2 + 1):
            kuf_y[s1:s1 + nc1, s2:s2 + nc2] += gy[s1 * (k2 + 1) + s2]

    t_band = v1.new_zeros((k1 + 1, 2 * k2 + 1, m1, m2))
    for p in range(k1 + 1):
        for o2 in range(-k2, k2 + 1):
            acc = t_band[p, o2 + k2]
            for s1 in range(k1 + 1 - p):
                i = p1idx[(s1, s1 + p)]
                for s2 in range(max(0, -o2), min(k2, k2 - o2) + 1):
                    j = p2idx[(min(s2, s2 + o2), max(s2, s2 + o2))]
                    acc[s1:s1 + nc1, s2:s2 + nc2] += grid[i * np2 + j]
    return KronStats(kuf_y=kuf_y.reshape(-1), t_band=t_band, yty=yty, n=n_t)


def compute_kron_stats_sharded(bases, X, y, group, w=None) -> KronStats:
    """Data-parallel statistics: (X, y) (and the weights ``w``) are this
    rank's shard, summed over ``group`` by one ``all_reduce``."""
    return all_reduce_stats(compute_kron_stats(bases, X, y, w), group)


def t_band_trace_against_kron(t_band, s1_band, s2_band):
    """trace(Kuu⁻¹ · KufKfu) with Kuu⁻¹ = S₁ ⊗ S₂ given the per-factor
    Takahashi bands, elementwise (stats/kron.py:165-191)."""
    k1 = t_band.shape[0] - 1
    k2 = (t_band.shape[1] - 1) // 2
    m2 = t_band.shape[3]

    def shift2(row, s):
        # out[q] = row[q + s], zero fill
        if s == 0:
            return row
        if s > 0:
            return torch.cat([row[s:], row.new_zeros(s)])
        return torch.cat([row.new_zeros(-s), row[: m2 + s]])

    total = t_band.new_zeros(())
    for p in range(k1 + 1):
        mult = 1.0 if p == 0 else 2.0
        for o2 in range(-k2, k2 + 1):
            # S₂ at [|o₂|, q₂ + min(o₂, 0)]
            s2_row = shift2(s2_band[abs(o2)], min(o2, 0))
            total = total + mult * torch.sum(
                t_band[p, o2 + k2] * s1_band[p][:, None] * s2_row[None, :])
    return total


def t_band_to_blocks(t_band, kuu1_band, kuu2_dense, sigma2):
    """The block-banded P = Kuu₁ ⊗ Kuu₂ + KufKfu/σ² as (k₁+1, m₁, m₂, m₂)
    blocks in banded/block.py's storage (block row i₁, block bandwidth k₁),
    blocks past the end zero (stats/kron.py:194-222)."""
    k1 = t_band.shape[0] - 1
    k2 = (t_band.shape[1] - 1) // 2
    m1, m2 = t_band.shape[2], t_band.shape[3]
    blocks = torch.einsum("pj,ab->pjab", kuu1_band, kuu2_dense)
    # T/σ² on the (j₂+o₂, j₂) diagonals of each block, through the 0/1
    # placement mask M[o₂+k₂, a, b] = [a − b = o₂]
    idx = torch.arange(m2, device=t_band.device)
    offsets = torch.arange(-k2, k2 + 1, device=t_band.device)
    diag_mask = ((idx[:, None] - idx[None, :])[None] == offsets[:, None, None]).to(t_band.dtype)
    blocks = blocks + torch.einsum("oab,pojb->pjab", diag_mask, t_band) / sigma2
    rows = torch.arange(m1, device=t_band.device)[None, :] + torch.arange(
        k1 + 1, device=t_band.device)[:, None]
    return blocks * (rows < m1).to(t_band.dtype)[:, :, None, None]
