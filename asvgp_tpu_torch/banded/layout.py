"""Band storage layout helpers (PyTorch counterpart of asvgp_tpu/banded/layout.py).

Lower band (k+1, m): ``band[j, i] = M[i + j, i]``, right padding zero.
General (l, u) band (l+u+1, m): ``band[r, i] = M[i + r - u, i]``.
"""

from __future__ import annotations

import torch


def _validity_mask(l: int, u: int, m: int, like: torch.Tensor) -> torch.Tensor:
    """Mask of in-range band slots for a general (l, u) band of an m×m matrix."""
    r = torch.arange(l + u + 1, device=like.device)[:, None]
    i = torch.arange(m, device=like.device)[None, :]
    row = i + r - u
    return ((row >= 0) & (row < m)).to(like.dtype)


def mask_band(band: torch.Tensor, l: int, u: int) -> torch.Tensor:
    """Zero the out-of-range slots of a general (l, u) band."""
    return band * _validity_mask(l, u, band.shape[1], band)


def mask_lower_band(band: torch.Tensor) -> torch.Tensor:
    """Zero the out-of-range (right-padding) slots of a lower band."""
    return mask_band(band, band.shape[0] - 1, 0)


def band_to_dense(band: torch.Tensor, l: int, u: int) -> torch.Tensor:
    """Expand a general (l, u) band of shape (l+u+1, m) to dense (m, m)."""
    m = band.shape[1]
    dense = band.new_zeros((m, m))
    for r in range(l + u + 1):
        off = r - u  # band[r, i] -> M[i + off, i]
        lo, hi = max(0, -off), min(m, m - off)
        i = torch.arange(lo, hi, device=band.device)
        dense[i + off, i] = band[r, lo:hi]
    return dense


def lower_band_to_dense(band: torch.Tensor) -> torch.Tensor:
    """Expand a lower band (k+1, m) to the dense lower-triangular (m, m) matrix."""
    return band_to_dense(band, band.shape[0] - 1, 0)


def shift_cols(v: torch.Tensor, s: int) -> torch.Tensor:
    """out[i] = v[i + s] with zero fill, along the last axis (static s)."""
    if s == 0:
        return v
    m = v.shape[-1]
    pad = v.new_zeros(v.shape[:-1] + (abs(s),))
    if s > 0:
        return torch.cat([v[..., s:], pad], dim=-1)
    return torch.cat([pad, v[..., :m + s]], dim=-1)


def transpose_lower_band(band: torch.Tensor) -> torch.Tensor:
    """General-band storage (l=0, u=k) of Mᵀ from the lower band of M."""
    k = band.shape[0] - 1
    return torch.stack([shift_cols(band[k - r], r - k) for r in range(k + 1)], dim=0)


def symmetrise_lower_band(band: torch.Tensor) -> torch.Tensor:
    """Lower band (k+1, m) of symmetric M -> full general band (2k+1, m) of M."""
    upper = transpose_lower_band(band)  # (k+1, m), row k = main diag
    return torch.cat([upper[:-1], band], dim=0)


def dense_to_band(dense: torch.Tensor, l: int, u: int) -> torch.Tensor:
    """Extract a general (l, u) band, shape (l+u+1, m), from dense (m, m):
    ``band[r, i] = M[i + r - u, i]``, out-of-range slots zero."""
    m = dense.shape[0]
    rows = []
    for r in range(l + u + 1):
        off = r - u
        diag = torch.diagonal(dense, offset=-off)  # M[i + off, i]
        pad = dense.new_zeros((m - diag.shape[0],))
        rows.append(torch.cat([pad, diag]) if off < 0 else torch.cat([diag, pad]))
    return torch.stack(rows)


def dense_to_lower_band(dense: torch.Tensor, k: int) -> torch.Tensor:
    """Extract the lower band (k+1, m) of a dense (m, m) matrix."""
    return dense_to_band(dense, k, 0)


def lower_band_of_symmetric(band_full: torch.Tensor, l: int, u: int) -> torch.Tensor:
    """Extract the lower band (rows u..u+l) from a general band of a symmetric M."""
    return band_full[u:u + l + 1]
