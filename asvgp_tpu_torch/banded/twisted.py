"""Twisted (two-ended) banded factorization: the float64 oracle.

PyTorch counterpart of ``asvgp_tpu/banded/twisted.py``.  The matrix is
factored forward from the top AND backward from the bottom at once (the
"burn at both ends" split), meeting at a k×k middle block; each stream is
half as long as the single-ended sweep.  Block picture (left block size h,
middle k, right g = m - h - k; P13 = 0 because the bandwidth is k):

    P = [[P11, P12,   0],        S22 = P22 − L21 L21ᵀ − J L21' L21'ᵀ J
         [P21, P22, P23],
         [  0, P32, P33]]

with L11 the Cholesky of the leading block and L21 its in-band spill into
the middle (the forward stream), and primed quantities from the backward
stream, which is the forward factorization of the index-reversed matrix
JPJ.  Then, exactly:

    log|P|  = log|P11| + log|P33| + log|S22|
    bᵀP⁻¹b  = ‖L11⁻¹b1‖² + ‖L33'⁻¹b3'‖² + b2ᶜᵀ S22⁻¹ b2ᶜ,
              b2ᶜ = b2 − L21 y1ᵗᵃⁱˡ − J L21' y3ᵗᵃⁱˡ
    band(P⁻¹): the dense Z22 = S22⁻¹ seeds a Takahashi recursion running
              outward on each side; left (cols < h), dense middle and right
              (rows ≥ h+k) tile the band exactly.
    P⁻¹b:     back-substitution outward on both sides seeded with
              x2 = S22⁻¹ b2ᶜ.

This module is the reference the twisted sweeps (banded/twist.py and
csrc/banded_tan.cu) are held to; it runs the plain recursions of
banded/ops.py and ``torch.linalg`` for the k×k middle.
"""

from __future__ import annotations

import torch

from asvgp_tpu_torch.banded.layout import shift_cols


def flip_band(band: torch.Tensor) -> torch.Tensor:
    """Lower band of the index-reversed matrix JAJ (an involution).

    band'[r, j] = A'[j+r, j] = A[m-1-j, m-1-j-r] = band[r, m-1-r-j].
    """
    k = band.shape[0] - 1
    return torch.stack([shift_cols(band[r].flip(0), r) for r in range(k + 1)], dim=0)


def _lower_tail_dense(tail_cols: torch.Tensor) -> torch.Tensor:
    """Dense k×k spill block L21 from the last k factor columns.

    tail_cols: (..., k+1, k) = factor columns h-k..h-1 (rows within band).
    Returns L21 with L21[a, t] = L[h+a, h-k+t] = tail_cols[k+a-t, t], zero
    where the offset k+a-t exceeds the bandwidth (a > t).
    """
    k = tail_cols.shape[-1]
    a = torch.arange(k, device=tail_cols.device)[:, None]
    t = torch.arange(k, device=tail_cols.device)[None, :]
    r = k + a - t
    valid = r <= k
    dense = tail_cols[..., r.clamp(0, k), t.expand(k, k)]
    return torch.where(valid, dense, torch.zeros_like(dense))


def _middle_dense(band: torch.Tensor, h: int) -> torch.Tensor:
    """Dense k×k middle block P[h:h+k, h:h+k] from the lower band(s)
    (..., k+1, m)."""
    k = band.shape[-2] - 1
    a = torch.arange(k, device=band.device)[:, None]
    b = torch.arange(k, device=band.device)[None, :]
    return band[..., (a - b).abs(), h + torch.minimum(a, b)]


def _solve_upper_seeded(l_band: torch.Tensor, y: torch.Tensor,
                        x_seed: torch.Tensor) -> torch.Tensor:
    """Back-substitution Lᵀx = y over columns h-1..0 of the factor, seeded
    with the known x[h..h+k-1] (x_seed).  ``l_band`` is the (k+1, h) slice
    of the untapered factor: its columns near h carry rows that reach into
    the middle block, and they are used."""
    X = x_seed
    xs = []
    for l_col, y_i in zip(reversed(l_band.T.unbind(0)), reversed(y.unbind(0))):
        xi = (y_i - l_col[1:] @ X) / l_col[0]
        xs.append(xi)
        X = torch.cat([xi[None], X[:-1]])
    xs.reverse()
    return torch.stack(xs)


def _takahashi_seeded(l_band: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Takahashi band recursion over columns h-1..0, seeded with the dense
    middle inverse: seed (k, k+1) with seed[p-1, r] = Z[h-1+p+r, h-1+p]
    (entries with p+r > k are never read; pass zeros).  No end-of-matrix
    masking: columns near h spill into the middle rows."""
    from asvgp_tpu_torch.banded.ops import takahashi_inverse_band_plain

    return takahashi_inverse_band_plain(l_band, seed=seed)


def _seed_from_mid(z_mid: torch.Tensor) -> torch.Tensor:
    """(k, k+1) Takahashi seed window from the dense middle inverse:
    seed[p-1, r] = Z22[p-1+r, p-1] where in range, else 0."""
    k = z_mid.shape[-1]
    p = torch.arange(k, device=z_mid.device)[:, None]
    r = torch.arange(k + 1, device=z_mid.device)[None, :]
    valid = p + r <= k - 1
    seed = z_mid[..., (p + r).clamp(0, k - 1), p.expand(k, k + 1)]
    return torch.where(valid, seed, torch.zeros_like(seed))


def split_point(m: int, k: int) -> int:
    """Left-block size h: both streams within one column of equal length."""
    return (m - k + 1) // 2


def twisted_pieces(band: torch.Tensor, h: int):
    """Both Cholesky streams and the middle Schur complement of one SPD band.

    Returns (l_left, l_right_flipped, s_mid, fb): the extended forward
    factor over columns 0..h+k-1, the same for the reversed matrix (g+k
    columns), the k×k dense middle Schur complement and the flipped band.
    """
    from asvgp_tpu_torch.banded.ops import cholesky_band_plain

    k = band.shape[0] - 1
    m = band.shape[1]
    g = m - h - k
    if not (k >= 1 and h >= k and g >= k):
        raise ValueError(f"twisted split needs h,g >= k >= 1; got m={m}, k={k}, h={h}, g={g}")
    fb = flip_band(band)
    l_left = cholesky_band_plain(band[:, : h + k])
    l_right = cholesky_band_plain(fb[:, : g + k])
    l21_f = _lower_tail_dense(l_left[:, h - k: h])
    l21_r = _lower_tail_dense(l_right[:, g - k: g])
    c_f = l21_f @ l21_f.T
    c_r = (l21_r @ l21_r.T).flip(0, 1)
    s_mid = _middle_dense(band, h) - c_f - c_r
    return l_left, l_right, s_mid, fb


def _mid_inverse(s_mid: torch.Tensor):
    """(log|S|, S⁻¹, chol(S)) of the k×k middle block."""
    m_chol = torch.linalg.cholesky(s_mid)
    ld = 2.0 * torch.sum(torch.log(torch.diagonal(m_chol)))
    eye = torch.eye(s_mid.shape[0], dtype=s_mid.dtype, device=s_mid.device)
    return ld, torch.cholesky_solve(eye, m_chol), m_chol


def twisted_inverse_band(band: torch.Tensor, h: int | None = None):
    """(log|A|, band of A⁻¹) via the twisted factorization.  Exact."""
    k = band.shape[0] - 1
    m = band.shape[1]
    if h is None:
        h = split_point(m, k)
    g = m - h - k
    l_left, l_right, s_mid, _ = twisted_pieces(band, h)
    ld_mid, z_mid, _ = _mid_inverse(s_mid)
    ld = (
        2.0 * torch.sum(torch.log(l_left[0, :h]))
        + 2.0 * torch.sum(torch.log(l_right[0, :g]))
        + ld_mid
    )
    zl = _takahashi_seeded(l_left[:, :h], _seed_from_mid(z_mid))
    zr = _takahashi_seeded(l_right[:, :g], _seed_from_mid(z_mid.flip(0, 1)))
    return ld, _assemble_band(zl, zr, z_mid, m)


def _assemble_band(zl, zr, z_mid, m):
    """Tile the inverse band from (left cols, flipped right cols, middle)."""
    k = zl.shape[0] - 1
    h = zl.shape[1]
    g = zr.shape[1]
    # nonzero exactly where the row index is >= h+k
    zr_full = flip_band(torch.cat([zr, zr.new_zeros((k + 1, m - g))], dim=1))
    # dense middle entries: rows AND cols inside the middle block
    mid_patch = _seed_from_mid(z_mid).T  # (k+1, k): [r, t] = Z[t+r, t]
    rest = zr_full[:, h:]
    rest = torch.cat([rest[:, :k] + mid_patch, rest[:, k:]], dim=1)
    return torch.cat([zl, rest], dim=1)


def twisted_solve_core(band: torch.Tensor, b: torch.Tensor, h: int | None = None):
    """(log|A|, bᵀA⁻¹b, A⁻¹b, band of A⁻¹) in twisted form.  Exact."""
    from asvgp_tpu_torch.banded.ops import solve_lower_band_plain

    k = band.shape[0] - 1
    m = band.shape[1]
    if h is None:
        h = split_point(m, k)
    g = m - h - k
    l_left, l_right, s_mid, _ = twisted_pieces(band, h)
    l21_f = _lower_tail_dense(l_left[:, h - k: h])
    l21_r = _lower_tail_dense(l_right[:, g - k: g])

    bf = b.flip(0)
    y1 = solve_lower_band_plain(l_left[:, :h], b[:h])
    y3 = solve_lower_band_plain(l_right[:, :g], bf[:g])
    b2c = b[h: h + k] - l21_f @ y1[h - k:] - (l21_r @ y3[g - k:]).flip(0)

    ld_mid, z_mid, m_chol = _mid_inverse(s_mid)
    ld = (
        2.0 * torch.sum(torch.log(l_left[0, :h]))
        + 2.0 * torch.sum(torch.log(l_right[0, :g]))
        + ld_mid
    )
    x2 = torch.cholesky_solve(b2c[:, None], m_chol)[:, 0]
    quad = torch.sum(y1 * y1) + torch.sum(y3 * y3) + torch.sum(b2c * x2)

    x1 = _solve_upper_seeded(l_left[:, :h], y1, x2)
    x3 = _solve_upper_seeded(l_right[:, :g], y3, x2.flip(0))
    u = torch.cat([x1, x2, x3.flip(0)])

    zl = _takahashi_seeded(l_left[:, :h], _seed_from_mid(z_mid))
    zr = _takahashi_seeded(l_right[:, :g], _seed_from_mid(z_mid.flip(0, 1)))
    return ld, quad, u, _assemble_band(zl, zr, z_mid, m)


def twisted_collapsed_core(kuu_band, p_band, b, big_band, h: int | None = None):
    """The collapsed-ELBO scalars (log|Kuu|, log|P|, bᵀP⁻¹b, tr(Kuu⁻¹B))
    plus the gradient bands (S_Kuu, S_P, u), in twisted form: the float64
    oracle of the twisted sweeps."""
    from asvgp_tpu_torch.banded.ops import band_frobenius

    ld_kuu, s_kuu = twisted_inverse_band(kuu_band, h)
    ld_p, quad, u, s_p = twisted_solve_core(p_band, b, h)
    trace = band_frobenius(s_kuu, big_band)
    return (ld_kuu, ld_p, quad, trace), (s_kuu, s_p, u)
