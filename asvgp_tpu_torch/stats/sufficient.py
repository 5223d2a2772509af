"""Sufficient statistics: Kuf·y, banded Kuf·Kufᵀ, yᵀy — on the data's device.

PyTorch counterpart of ``asvgp_tpu/stats/sufficient.py`` (single device).
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


def _stats_sorted(basis, vals, start, yf) -> tuple:
    """Scatter-free Kuf·y and banded Kuf·Kufᵀ: every per-point product is
    summed per cell by one prefix sum and the cell boundaries."""
    kp1 = vals.shape[1]
    m = basis.m
    n_cells = basis.n_cells
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


def compute_stats(basis, X: torch.Tensor, y: torch.Tensor) -> SufficientStats:
    """Sufficient statistics of (X, y) on their device, in their dtype."""
    yf = y.reshape(-1)
    vals, start = basis.evaluate_basis(X, dx=0)
    yty = torch.sum(torch.square(yf))
    n = torch.tensor(float(yf.shape[0]), dtype=yf.dtype, device=yf.device)
    kuf_y, band = _stats_sorted(basis, vals, start, yf)
    return SufficientStats(kuf_y=kuf_y, kufkfu_band=band, yty=yty, n=n)
