"""Sufficient statistics: Kuf·y, banded Kuf·Kufᵀ, yᵀy — on the data's device.

PyTorch counterpart of ``asvgp_tpu/stats/sufficient.py``.  Every statistic
is a sum over data points, so data parallelism needs only a sum: each rank
of a ``torch.distributed`` group builds the statistics of its own shard
and one ``all_reduce`` adds them (``compute_stats_sharded``; the other
families' sharded builds use the same ``all_reduce_stats``).
Kuf is never materialized: each data point contributes its (order+1)
contiguous basis weights.  The statistics are assembled in the sorted,
scatter-free form of the JAX package: sort the points by mesh cell once,
then every statistic is a length-N prefix sum of per-point products and
(n_cells,) boundary differences.  The prefix sums run in a fixed order
(rows of ``_SCAN_ROW`` points, then the row totals), so the same data give
the same statistics, bit for bit, on every run on the GPU too: neither
``index_add_`` with float64 atomics nor a 1-D ``torch.cumsum`` on CUDA (a
single-pass scan whose order of summation varies between runs) does.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class SufficientStats:
    """The collapsed-ELBO sufficient statistics."""

    kuf_y: torch.Tensor        # (m,)
    kufkfu_band: torch.Tensor  # (order+1, m), lower band of Kuf Kuf^T
    yty: torch.Tensor          # scalar
    n: torch.Tensor            # scalar (float) number of points


_SCAN_ROW = 1024


def _prefix_sums(values):
    """[0, v_0, v_0 + v_1, ...] along the last axis of ``values`` (p, n), in
    a fixed order of summation: each row of ``_SCAN_ROW`` values is scanned
    on its own, then the row totals.  Torch scans a tensor of two or more
    rows along its last dimension row by row; only a single-row scan takes
    the one-pass path whose order varies between runs."""
    p, n = values.shape
    rows = max(2, -(-n // _SCAN_ROW))
    padded = values.new_zeros((p, rows * _SCAN_ROW))
    padded[:, :n] = values
    within = padded.view(p, rows, _SCAN_ROW).cumsum(2)
    totals = within[:, :, -1]
    totals = torch.stack([totals, torch.zeros_like(totals)]).cumsum(2)[0]
    zero = values.new_zeros((p, 1))
    before = torch.cat([zero, totals[:, :-1]], dim=1)
    return torch.cat([zero, (within + before[:, :, None]).reshape(p, -1)[:, :n]], dim=1)


def _stats_sorted(m: int, vals, start, yf) -> tuple:
    """Scatter-free Kuf·y and banded Kuf·Kufᵀ of a basis of ``m`` functions:
    every per-point product is summed per cell by one prefix sum and the
    cell boundaries."""
    kp1 = vals.shape[1]
    n_cells = m - kp1 + 1
    order = torch.argsort(start, stable=True)
    vals_s = vals[order]
    y_s = yf[order]
    start_s = start[order]
    bounds = torch.searchsorted(
        start_s, torch.arange(n_cells + 1, dtype=start.dtype, device=start.device)
    )
    # one row per product: w_s·y for s = 0..k, then w_s·w_{s+j} by (j, s)
    pairs = [(j, s) for j in range(kp1) for s in range(kp1 - j)]
    products = [vals_s[:, s] * y_s for s in range(kp1)]
    products += [vals_s[:, s] * vals_s[:, s + j] for j, s in pairs]
    c = _prefix_sums(torch.stack(products))
    per_cell = c[:, bounds[1:]] - c[:, bounds[:-1]]  # (rows, n_cells)

    # the sum of cell c for basis function offset s lands at position c + s
    kuf_y = vals.new_zeros(m)
    for s in range(kp1):
        kuf_y[s:s + n_cells] += per_cell[s]
    band = vals.new_zeros((kp1, m))
    for row, (j, s) in enumerate(pairs, start=kp1):
        band[j, s:s + n_cells] += per_cell[row]
    return kuf_y, band


def _totals(yf, w):
    """yᵀy and n of the points (y flat), weighted by ``w`` when given."""
    if w is None:
        return (torch.sum(torch.square(yf)),
                torch.tensor(float(yf.shape[0]), dtype=yf.dtype, device=yf.device))
    return torch.sum(w * torch.square(yf)), torch.sum(w)


def compute_stats(basis, X: torch.Tensor, y: torch.Tensor, w=None) -> SufficientStats:
    """Sufficient statistics of (X, y) on their device, in their dtype.

    ``w`` (n,) optionally weights the points (0/1: padded points carry 0),
    as the JAX package's ``_stats_local``: the basis weights carry it, so
    Kuf·y is w-weighted and the band w²-weighted; yᵀy and n are Σ w·y² and
    Σ w."""
    yf = y.reshape(-1)
    vals, start = basis.evaluate_basis(X, dx=0)
    if w is not None:
        vals = vals * w[:, None]
    yty, n = _totals(yf, w)
    kuf_y, band = _stats_sorted(basis.m, vals, start, yf)
    return SufficientStats(kuf_y=kuf_y, kufkfu_band=band, yty=yty, n=n)


def all_reduce_stats(stats, group):
    """The sum of a statistics dataclass over the ranks of ``group``: its
    fields packed into one buffer, one ``all_reduce`` (SUM), unpacked.
    Every rank gets the same sum."""
    import torch.distributed as dist

    if group is None:
        raise ValueError("the sharded statistics need a process group")
    fields = [f.name for f in dataclasses.fields(stats)]
    parts = [getattr(stats, f) for f in fields]
    flat = torch.cat([p.reshape(-1) for p in parts])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    out, lo = {}, 0
    for f, p in zip(fields, parts):
        out[f] = flat[lo:lo + p.numel()].view(p.shape)
        lo += p.numel()
    return type(stats)(**out)


def rescale_stats(stats, n_total):
    """The statistics of a batch scaled by N_total / n (every field, n
    included): the stochastic collapsed bound's statistics."""
    scale = torch.as_tensor(float(n_total), dtype=stats.n.dtype, device=stats.n.device) / stats.n
    return type(stats)(**{f.name: getattr(stats, f.name) * scale
                          for f in dataclasses.fields(stats)})


def compute_stats_sharded(basis, X, y, group) -> SufficientStats:
    """Data-parallel statistics: (X, y) is this rank's shard (see
    ``parallel.shard_data``); its statistics are summed over ``group`` by
    one ``all_reduce``.  A group of one rank gives ``compute_stats``'s bits."""
    return all_reduce_stats(compute_stats(basis, X, y), group)


def pad_for_sharding(X, y, num_shards: int):
    """Pad (X, y) to a multiple of ``num_shards`` points; returns (X, y, w).

    The padded points repeat X[0] with y = 0 and weight 0, so they stay
    inside the basis' domain and add nothing to the weighted statistics
    (``compute_stats_sharded_masked``).  X is (n,) / (n, 1), flattened, or
    (n, D), padded by rows."""
    x = torch.as_tensor(X)
    if x.ndim != 2 or x.shape[1] == 1:
        x = x.reshape(-1)
    yf = torch.as_tensor(y).reshape(-1)
    n = x.shape[0]
    rem = (-n) % num_shards
    w = x.new_ones(n + rem)
    if rem:
        x = torch.cat([x, x[:1].expand(rem, *x.shape[1:])])
        yf = torch.cat([yf, yf.new_zeros(rem)])
        w[n:] = 0.0
    return x, yf, w


def compute_stats_sharded_masked(basis, X, y, w, group) -> SufficientStats:
    """``compute_stats_sharded`` with the 0/1 weights ``w`` of this rank's
    shard (the padded points of ``pad_for_sharding`` carry 0)."""
    return all_reduce_stats(compute_stats(basis, X, y, w), group)


def kuf_matvec(vals, start, y, m: int) -> torch.Tensor:
    """Kuf·y (m,) from the structured-sparse Kuf (``vals`` (n, k+1),
    ``start`` (n,), as ``make_kuf`` gives them), by the sorted prefix sums
    of ``compute_stats``: the same bits on every run, on the GPU too."""
    return _stats_sorted(m, vals, start, y.reshape(-1))[0]


def kufkfu_band(vals, start, m: int) -> torch.Tensor:
    """The lower band (k+1, m) of Kuf·Kufᵀ from the structured-sparse Kuf,
    by the same sorted prefix sums."""
    return _stats_sorted(m, vals, start, vals.new_zeros(vals.shape[0]))[1]
