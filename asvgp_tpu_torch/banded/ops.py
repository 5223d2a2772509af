"""Core banded linear-algebra ops: plain-PyTorch twins of the recursions.

PyTorch counterpart of ``asvgp_tpu/banded/ops.py`` (its float64 ``lax.scan``
path).  The sequential recursions (Cholesky, triangular solves, Takahashi)
are Python loops over the m columns carrying a k-column window; each step is
a few small tensor ops vectorised over the (k+1) window.  They are the plain
versions that the hand-written GPU sweeps (banded/core.py) are held
against, and what runs for tensors on the CPU.  They build no in-place
state, so autograd can differentiate them on the CPU.

``collapsed_core`` and ``banded_posterior`` route through
``core.factor_takahashi_solve``: the two GPU sweeps on a CUDA tensor, these
twins on a CPU tensor.
"""

from __future__ import annotations

import torch

from asvgp_tpu_torch.banded.layout import shift_cols


def _col_mask(i: int, k: int, m: int, like: torch.Tensor) -> torch.Tensor:
    """Mask (k+1,) of valid band rows for column i: row j valid iff i + j < m."""
    return (i + torch.arange(k + 1, device=like.device) < m).to(like.dtype)


def cholesky_band(a_band: torch.Tensor) -> torch.Tensor:
    """Banded Cholesky: lower band of L with A = L L^T.

    Args:
      a_band: (k+1, m) lower band of a symmetric positive-definite matrix.
    Returns:
      (k+1, m) lower band of L, right-padding slots zeroed.
    """
    k = a_band.shape[0] - 1
    m = a_band.shape[1]
    if k == 0:
        return torch.sqrt(a_band)
    w = k + 1
    # window: win[(p-1)*w + r] = L[i-p+r, i-p] (band entry r of column i-p),
    # with one zero slot at the end for the entries beyond the band
    idx = torch.tensor(
        [[(p - 1) * w + p + j if p + j <= k else k * w for j in range(w)]
         for p in range(1, k + 1)],
        device=a_band.device,
    ).reshape(-1)
    zero = a_band.new_zeros(1)
    win = a_band.new_zeros(k * w + 1)
    cols = []
    for i, a_col in enumerate(a_band.T.unbind(0)):
        # S[p-1, j] = L[i+j, i-p]; column 0 is g_p = L[i, i-p]
        S = win.index_select(0, idx).view(k, w)
        r = a_col - S[:, 0] @ S
        l0 = torch.sqrt(r[:1])
        col = torch.cat([l0, r[1:] / l0])
        if i + k >= m:
            col = col * _col_mask(i, k, m, col)
        cols.append(col)
        win = torch.cat([col, win[:(k - 1) * w], zero])
    return torch.stack(cols, dim=1)


def cholesky_band_pair(a_band: torch.Tensor, b_band: torch.Tensor):
    """Factor two independent banded SPD matrices."""
    return cholesky_band(a_band), cholesky_band(b_band)


def log_det_from_cholesky(l_band: torch.Tensor) -> torch.Tensor:
    """log|A| = 2 sum_i log L[i, i] given the banded Cholesky factor."""
    return 2.0 * torch.sum(torch.log(l_band[0]))


def solve_lower_band(l_band: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L x = b for banded lower-triangular L (forward substitution).

    Args:
      l_band: (k+1, m) lower band of L.
      b: (m,) or (m, r) right-hand side.
    Returns:
      x with the same shape as b.
    """
    k = l_band.shape[0] - 1
    vec = b.ndim == 1
    b2 = b[:, None] if vec else b
    if k == 0:
        x = b2 / l_band[0][:, None]
        return x[:, 0] if vec else x
    # G[p-1, i] = L[i, i-p] = l_band[p, i-p]
    G = torch.stack([shift_cols(l_band[p], -p) for p in range(1, k + 1)], dim=0)
    X = b2.new_zeros((k, b2.shape[1]))  # X[p-1] = x[i-p]
    xs = []
    for g, l0, b_row in zip(G.T.unbind(0), l_band[0].unbind(0), b2.unbind(0)):
        xi = (b_row - g @ X) / l0
        xs.append(xi)
        X = torch.cat([xi[None], X[:-1]], dim=0)
    x = torch.stack(xs, dim=0)
    return x[:, 0] if vec else x


def solve_upper_band_transpose(l_band: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L^T x = b for banded lower-triangular L (backward substitution)."""
    k = l_band.shape[0] - 1
    vec = b.ndim == 1
    b2 = b[:, None] if vec else b
    if k == 0:
        x = b2 / l_band[0][:, None]
        return x[:, 0] if vec else x
    X = b2.new_zeros((k, b2.shape[1]))  # X[p-1] = x[i+p]
    xs = []
    for l_col, b_row in zip(reversed(l_band.T.unbind(0)), reversed(b2.unbind(0))):
        xi = (b_row - l_col[1:] @ X) / l_col[0]
        xs.append(xi)
        X = torch.cat([xi[None], X[:-1]], dim=0)
    xs.reverse()
    x = torch.stack(xs, dim=0)
    return x[:, 0] if vec else x


def cholesky_solve_band(l_band: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b given the banded Cholesky factor L of A."""
    return solve_upper_band_transpose(l_band, solve_lower_band(l_band, b))


def takahashi_inverse_band(l_band: torch.Tensor) -> torch.Tensor:
    """Band of A^{-1} from the banded Cholesky factor L (Takahashi recursion).

    Computes the entries of S = A^{-1} on the band |i - j| <= k exactly
    (the sparse-inverse-subset recursion is exact on the sparsity pattern of
    L^T + L).

    Args:
      l_band: (k+1, m) lower band of L (right-padding must be zero, as
        produced by :func:`cholesky_band`).
    Returns:
      (k+1, m) lower band of A^{-1}.
    """
    k = l_band.shape[0] - 1
    m = l_band.shape[1]
    if k == 0:
        return 1.0 / (l_band * l_band)
    w = k + 1
    # window: cs[(p-1)*w + r] = S_band[r, j+p] (zeros beyond the end);
    # M[q-1, p-1] = S[j+max(p,q), j+min(p,q)] = S_band[|q-p|, j+min(p,q)]
    idx = torch.tensor(
        [[(min(p, q) - 1) * w + abs(q - p) for p in range(1, k + 1)]
         for q in range(1, k + 1)],
        device=l_band.device,
    ).reshape(-1)
    cs = l_band.new_zeros(k * w)
    cols = []
    l_cols = l_band.T.unbind(0)
    for j in range(m - 1, -1, -1):
        l_col = l_cols[j]
        d = 1.0 / l_col[:1]
        wv = l_col[1:]  # wv[p-1] = L[j+p, j]
        M = cs.index_select(0, idx).view(k, k)
        s = -d * (M @ wv)  # off-diagonal S[j+q, j], q = 1..k
        sjj = d * d - d * (wv @ s)
        col = torch.cat([sjj, s])
        if j + k >= m:
            col = col * _col_mask(j, k, m, col)
        cols.append(col)
        cs = torch.cat([col, cs[:(k - 1) * w]])
    cols.reverse()
    return torch.stack(cols, dim=1)


def band_frobenius(a_band: torch.Tensor, b_band: torch.Tensor) -> torch.Tensor:
    """trace(A @ B) for symmetric A, B given as lower bands:
    tr(AB) = sum_i a0_i b0_i + 2 sum_{j>=1,i} aj_i bj_i."""
    kw = min(a_band.shape[0], b_band.shape[0])
    a = a_band[:kw]
    b = b_band[:kw]
    return torch.sum(a[0] * b[0]) + 2.0 * torch.sum(a[1:] * b[1:])


def collapsed_core(kuu_band, p_band, b, big_band):
    """(log|Kuu|, log|P|, bᵀP⁻¹b, tr(Kuu⁻¹ B)), value only, from the two
    banded sweeps of ``core.factor_takahashi_solve``."""
    from asvgp_tpu_torch.banded import core

    return core.collapsed_core(kuu_band, p_band, b, big_band)


def banded_posterior(kuu_band, p_band, b):
    """(band of Kuu⁻¹, band of P⁻¹, P⁻¹ b) — the prediction-time posterior
    quantities, from the same two sweeps."""
    from asvgp_tpu_torch.banded import core

    _, _, s_kuu, s_p, _, u, _ = core.factor_takahashi_solve(kuu_band, p_band, b)
    return s_kuu, s_p, u
