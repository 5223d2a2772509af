"""Kronecker (tensor-product) sufficient statistics at any D ≥ 2.

PyTorch counterpart of ``asvgp_tpu/stats/kron_nd.py`` (single device).  It
generalises stats/kron.py, the D = 2 path, to D input dimensions; the
statistics stay multibanded and P stays block-banded along dimension 1,
with the trailing D−1 dimensions flattened row-major into dense blocks:

  T[p, o₂+k₂, …, o_D+k_D, j₁, …, j_D] = Σ_points Π_d w_d[s_d] w_d[s_d + o_d]
      (p = o₁ in 0..k₁, the block-lower offset; o_d in −k_d..k_d, d ≥ 2)

  P = Kuu₁ ⊗ (Kuu₂ ⊗ … ⊗ Kuu_D) + T/σ²
      block-banded, block bandwidth k₁, dense blocks of side M₂ = Π_{d≥2} m_d.

The build sorts the points once by joint mesh cell (row-major over the
per-dimension cells).  Every series is a product of one unordered pair
product per dimension (Π_d (k_d+1)(k_d+2)/2 of them: 1000 at D = 3 and
order 3) and is summed per cell by ``stats/sufficient.py``'s fixed-order
prefix sums, so a second build on the GPU gives the same bits.  The
(N, Π_d n_pairs_d) matrix of all series is never formed: the series are
made and summed in blocks of ``_BLOCK`` at a time, 1 GB of float64 a block
at N = 10⁶.  The block Takahashi band used for prediction holds
(k₁+1)·m₁·M₂² entries, so D = 3 is practical up to m_d ≈ 20-30.
"""

from __future__ import annotations

import string
from itertools import product

import torch

from asvgp_tpu_torch.stats.kron import KronStats, _pairs
from asvgp_tpu_torch.stats.sufficient import _prefix_sums, _totals, all_reduce_stats

# series made and summed per cell at a time
_BLOCK = 128


def _radix_digits(cols: torch.Tensor, radices) -> list:
    """The row-major mixed-radix digits of the column indices ``cols``, the
    first radix the most significant."""
    digits = []
    for r in reversed(radices):
        digits.append(cols % r)
        cols = cols // r
    return digits[::-1]


def _series_sums(factors, cell_sums) -> torch.Tensor:
    """Per-cell sums of every product series of ``factors`` ((r_d, n) each):
    series c = (i_1, …, i_D) in row-major order over the r_d is
    factors[0][i_1] · (factors[1][i_2] · … · factors[D-1][i_D]), formed and
    summed ``_BLOCK`` series at a time.  Returns (Π r_d, *cells)."""
    radices = [f.shape[0] for f in factors]
    total = 1
    for r in radices:
        total *= r
    device = factors[0].device
    out = []
    for lo in range(0, total, _BLOCK):
        digits = _radix_digits(torch.arange(lo, min(lo + _BLOCK, total), device=device), radices)
        rows = factors[-1][digits[-1]]
        for d in range(len(factors) - 2, -1, -1):
            rows = factors[d][digits[d]] * rows
        out.append(cell_sums(rows))
    return torch.cat(out)


def compute_kron_stats_nd(bases, X: torch.Tensor, y: torch.Tensor, w=None) -> KronStats:
    """Sufficient statistics of (X (n, D), y) on their device, in their
    dtype: the JAX package's generic-D build (stats/kron_nd.py:39-162);
    ``w`` (n,) optionally weights the points (0/1), folded into dimension
    1's basis weights as there.
    ``kuf_y`` is flattened row-major over (m₁, …, m_D); ``t_band`` has
    shape (k₁+1, 2k₂+1, …, 2k_D+1, m₁, …, m_D)."""
    D = len(bases)
    ks = [b.order for b in bases]
    ms = [b.m for b in bases]
    ncs = [b.n_cells for b in bases]
    yf = y.reshape(-1)
    vs, cs = [], []
    for d, b in enumerate(bases):
        v, c = b.evaluate_basis(X[:, d], dx=0)
        vs.append(v)
        cs.append(c)
    if w is not None:
        vs[0] = vs[0] * w[:, None]
    yty, n_t = _totals(yf, w)

    # sort once by joint cell, row-major over the per-dimension cells
    joint = cs[0]
    for d in range(1, D):
        joint = joint * ncs[d] + cs[d]
    order = torch.argsort(joint, stable=True)
    vs = [v[order] for v in vs]
    ys = yf[order]
    joint_s = joint[order]
    ncells = 1
    for nc in ncs:
        ncells *= nc
    bounds = torch.searchsorted(
        joint_s, torch.arange(ncells + 1, dtype=joint_s.dtype, device=joint_s.device))

    def cell_sums(rows):
        """(c, n) series → (c, *ncs) per-cell sums."""
        c = _prefix_sums(rows)
        return (c[:, bounds[1:]] - c[:, bounds[:-1]]).reshape((rows.shape[0], *ncs))

    pairs_d = [_pairs(k) for k in ks]
    pidx_d = [{p: i for i, p in enumerate(ps)} for ps in pairs_d]
    nps = [len(ps) for ps in pairs_d]
    # per dimension: its pair products (n_pairs_d, n) and its weights (k_d+1, n)
    pair_rows = [torch.stack([vs[d][:, a] * vs[d][:, b] for a, b in pairs_d[d]])
                 for d in range(D)]
    grid = _series_sums(pair_rows, cell_sums)  # (Π nps, *ncs)
    gy = _series_sums([vs[0].T * ys] + [v.T for v in vs[1:]], cell_sums)  # (Π (k+1), *ncs)

    def col_of(digits, radices):
        col = 0
        for dig, r in zip(digits, radices):
            col = col * r + dig
        return col

    # ---- Kuf·y -------------------------------------------------------------
    kuf_y = vs[0].new_zeros(tuple(ms))
    for s in product(*[range(k + 1) for k in ks]):
        sl = tuple(slice(s[d], s[d] + ncs[d]) for d in range(D))
        kuf_y[sl] += gy[col_of(s, [k + 1 for k in ks])]

    # ---- multiband of Kuf·Kufᵀ ----------------------------------------------
    t_band = vs[0].new_zeros((ks[0] + 1, *(2 * k + 1 for k in ks[1:]), *ms))
    for p in range(ks[0] + 1):
        for o in product(*[range(-k, k + 1) for k in ks[1:]]):
            acc = t_band[(p, *(o[d] + ks[d + 1] for d in range(D - 1)))]
            s_ranges = [range(ks[0] + 1 - p)] + [
                range(max(0, -o[d]), min(ks[d + 1], ks[d + 1] - o[d]) + 1) for d in range(D - 1)]
            for s in product(*s_ranges):
                pi = [pidx_d[0][(s[0], s[0] + p)]]
                for d in range(1, D):
                    a, b = s[d], s[d] + o[d - 1]
                    pi.append(pidx_d[d][(min(a, b), max(a, b))])
                sl = tuple(slice(s[d], s[d] + ncs[d]) for d in range(D))
                acc[sl] += grid[col_of(pi, nps)]
    return KronStats(kuf_y=kuf_y.reshape(-1), t_band=t_band, yty=yty, n=n_t)


def compute_kron_stats_nd_sharded(bases, X, y, group, w=None) -> KronStats:
    """Data-parallel statistics: (X, y) (and the weights ``w``) are this
    rank's shard, summed over ``group`` by one ``all_reduce``."""
    return all_reduce_stats(compute_kron_stats_nd(bases, X, y, w), group)


def _shift_row(row: torch.Tensor, s: int) -> torch.Tensor:
    """out[q] = row[q + s], zero fill."""
    if s == 0:
        return row
    if s > 0:
        return torch.cat([row[s:], row.new_zeros(s)])
    return torch.cat([row.new_zeros(-s), row[: row.shape[0] + s]])


def t_band_trace_against_kron_nd(t_band, s_bands):
    """trace(Kuu⁻¹ · KufKfu) with Kuu⁻¹ = ⊗_d S_d given the per-factor
    Takahashi bands, elementwise (stats/kron_nd.py:189-209)."""
    D = len(s_bands)
    k1 = t_band.shape[0] - 1
    t_ks = [(t_band.shape[1 + i] - 1) // 2 for i in range(D - 1)]
    total = t_band.new_zeros(())
    for p in range(k1 + 1):
        mult = 1.0 if p == 0 else 2.0
        for o in product(*[range(-k, k + 1) for k in t_ks]):
            weight = s_bands[0][p]
            for d in range(1, D):
                # S_d at [|o_d|, q_d + min(o_d, 0)]
                row = _shift_row(s_bands[d][abs(o[d - 1])], min(o[d - 1], 0))
                weight = weight[..., None] * row
            idx = (p, *(o[i] + t_ks[i] for i in range(D - 1)))
            total = total + mult * torch.sum(t_band[idx] * weight)
    return total


def t_band_to_blocks_nd(t_band, kuu1_band, kuu_trailing_dense, sigma2):
    """The block-banded P = Kuu₁ ⊗ (⊗_{d≥2} Kuu_d) + KufKfu/σ² as
    (k₁+1, m₁, M₂, M₂) blocks in banded/block.py's storage (block row i₁,
    block bandwidth k₁), blocks past the end zero
    (stats/kron_nd.py:212-264).  ``kuu_trailing_dense`` is the dense
    (M₂, M₂) Kronecker product of the trailing factors, row-major over
    dimensions 2..D as the blocks are."""
    D = t_band.ndim // 2
    k1 = t_band.shape[0] - 1
    t_ks = [(t_band.shape[1 + i] - 1) // 2 for i in range(D - 1)]
    ms = list(t_band.shape[-D:])
    m1 = ms[0]
    m2_total = 1
    for m in ms[1:]:
        m2_total *= m
    dev, dtype = t_band.device, t_band.dtype

    blocks = torch.einsum("pj,ab->pjab", kuu1_band, kuu_trailing_dense)
    # T/σ² on the multiband diagonals of each block, through one 0/1
    # placement mask per trailing dimension, M_d[o_d+k_d, a_d, b_d] = [a_d − b_d = o_d]
    masks = []
    for d in range(1, D):
        idx = torch.arange(ms[d], device=dev)
        offsets = torch.arange(-t_ks[d - 1], t_ks[d - 1] + 1, device=dev)
        masks.append(((idx[:, None] - idx[None, :])[None] == offsets[:, None, None]).to(dtype))
    # t[p, o₂..o_D, j, b₂..b_D] · Π_d M_d[o_d, a_d, b_d] → tblocks[p, j, a₂..a_D, b₂..b_D]
    letters = iter(string.ascii_lowercase)
    o_l = [next(letters) for _ in range(D - 1)]
    a_l = [next(letters) for _ in range(D - 1)]
    b_l = [next(letters) for _ in range(D - 1)]
    t_sub = "P" + "".join(o_l) + "J" + "".join(b_l)
    mask_subs = [o_l[i] + a_l[i] + b_l[i] for i in range(D - 1)]
    out_sub = "PJ" + "".join(a_l) + "".join(b_l)
    tblocks = torch.einsum(f"{t_sub}," + ",".join(mask_subs) + f"->{out_sub}", t_band, *masks)
    blocks = blocks + tblocks.reshape(k1 + 1, m1, m2_total, m2_total) / sigma2
    rows = torch.arange(m1, device=dev)[None, :] + torch.arange(k1 + 1, device=dev)[:, None]
    return blocks * (rows < m1).to(dtype)[:, :, None, None]
