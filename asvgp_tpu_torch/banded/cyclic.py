"""Block cyclic reduction: log-depth banded algebra.

PyTorch counterpart of ``asvgp_tpu/banded/cyclic.py``.  A symmetric band of
bandwidth k is block-tridiagonal with k×k blocks, and block cyclic
reduction (odd-even elimination) factors it in ⌈log₂(m/k)⌉ levels instead
of m dependent column steps: each level eliminates the odd-position blocks
of the ones left, in one batched k×k elimination over all of them, and the
Schur complements form a block-tridiagonal matrix of half the size.  The
back substitution walks the levels in reverse.

Blocks are held as ``(nb, k, k)`` tensors and every level is a handful of
batched library calls on them (``torch.linalg.cholesky_ex``,
``torch.linalg.solve_triangular``, ``@``): none of them syncs with the
host, and the shapes halve each level.  The block count is padded to a
power of two with identity blocks, which the reduction leaves alone
(log-det contribution 0, no Schur updates).  Everything is plain autograd:

  cr_logdet(band)           log|A|
  cr_solve(band, b)         A⁻¹ b
  cr_logdet_solve(band, b)  both, from one reduction
  cr_inverse_band(band)     band(A⁻¹), the Takahashi selected inverse, as
                            ∂log|A|/∂band = (2 − δ_{row 0}) ∘ band(A⁻¹)
  cr_trace(band, B)         tr(A⁻¹B) = ⟨∇log|A|, B⟩; its gradient in the
                            band is a second derivative, taken by double
                            backward through the reduction

On a band that is not positive definite every function gives NaN, as the
JAX package's does (a failed block Cholesky is NaN, not an error).
"""

from __future__ import annotations

import math

import torch

from asvgp_tpu_torch.banded.tan import band_weights


def _chol(blocks: torch.Tensor) -> torch.Tensor:
    """Batched Cholesky of (nb, k, k) blocks; NaN where a block is not
    positive definite (``cholesky_ex`` reports it on the device, no sync)."""
    l, info = torch.linalg.cholesky_ex(blocks)
    return torch.where((info == 0)[:, None, None], l, math.nan)


def _chol_solve(l: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """(L Lᵀ)⁻¹ rhs for batched factors L (nb, k, k), rhs (nb, k, r)."""
    y = torch.linalg.solve_triangular(l, rhs, upper=False)
    return torch.linalg.solve_triangular(l.mT, y, upper=True)


def _logdet(l: torch.Tensor) -> torch.Tensor:
    return 2.0 * torch.sum(torch.log(torch.diagonal(l, dim1=-2, dim2=-1)))


def _shift(x: torch.Tensor) -> torch.Tensor:
    """x[t] → slot t + 1 along the block axis, zero in slot 0."""
    return torch.cat([torch.zeros_like(x[:1]), x[:-1]])


def _pairs(x: torch.Tensor):
    """(even-position, odd-position) blocks of x along its first axis (of
    even length)."""
    return x.view(x.shape[0] // 2, 2, *x.shape[1:]).unbind(1)


def _band_to_blocktri(band: torch.Tensor):
    """(k+1, m) lower band → (D, E), each (nb, k, k), nb a power of two:
    D[t] = A[block t, block t] and E[t] = A[block t, block t − 1] (E[0] = 0),
    with A[tk + a, tk + b] = band[|a − b|, tk + min(a, b)] and identity
    blocks past the end."""
    k1, m = band.shape
    k = max(k1 - 1, 1)
    nb = 1 << (-(-m // k) - 1).bit_length()
    n = nb * k
    pad = band.new_zeros((k1, n - m))
    if n > m:
        pad = torch.cat([torch.ones_like(pad[:1]), pad[1:]])
    # one zero slot after the padded band for the entries outside it
    flat = torch.cat([torch.cat([band, pad], dim=1).reshape(-1), band.new_zeros(1)])
    zero_slot = k1 * n
    dev = band.device
    t = torch.arange(nb, device=dev)[:, None, None]
    a = torch.arange(k, device=dev)[None, :, None]
    b = torch.arange(k, device=dev)[None, None, :]
    d = (a - b).abs()
    d_idx = torch.where(d <= k1 - 1, d * n + t * k + torch.minimum(a, b), zero_slot)
    # E[t, a, b] = A[tk + a, (t−1)k + b] = band[k + a − b, (t−1)k + b]
    e = k + a - b
    e_idx = torch.where((e <= k1 - 1) & (t >= 1), e * n + (t - 1) * k + b, zero_slot)
    D = flat.index_select(0, d_idx.reshape(-1)).view(nb, k, k)
    E = flat.index_select(0, e_idx.reshape(-1)).view(nb, k, k)
    return D, E, k, n


def _level(D, E, r):
    """One odd-even elimination level: the blocks at odd positions go, and
    the Schur complements on the even ones are returned at half the size,
    with what the back substitution needs of the odd ones."""
    k = D.shape[-1]
    De, Do = _pairs(D)
    Ee, Eo = _pairs(E)                     # Eo[t] = A[2t+1, 2t]
    Er = torch.cat([Ee[1:], torch.zeros_like(Ee[:1])])   # A[2t+2, 2t+1]
    lo = _chol(Do)
    ld = _logdet(lo)
    re, ro = (None, None) if r is None else _pairs(r)
    cols = [Eo, Er.mT] if r is None else [Eo, Er.mT, ro[..., None]]
    sol = _chol_solve(lo, torch.cat(cols, dim=-1))
    X, Y = sol[..., :k], sol[..., k:2 * k]     # D_o⁻¹ A[2t+1, 2t], D_o⁻¹ A[2t+1, 2t+2]
    D2 = De - Eo.mT @ X - _shift(Er @ Y)
    E2 = _shift(-(Er @ X))                     # A'[2t+2, 2t]
    if r is None:
        return (D2, E2, None), ld, None
    z = sol[..., 2 * k:]
    r2 = re - (Eo.mT @ z)[..., 0] - _shift((Er @ z)[..., 0])
    return (D2, E2, r2), ld, (lo, Eo, Er, ro)


def _cr_sweep(band: torch.Tensor, b: torch.Tensor | None = None):
    """The whole reduction → (log|A|, A⁻¹b or None)."""
    D, E, k, n = _band_to_blocktri(band)
    r = None
    if b is not None:
        r = torch.cat([b, b.new_zeros(n - b.shape[0])]).view(-1, k)
    total = band.new_zeros(())
    stack = []
    while D.shape[0] > 1:
        (D, E, r), ld, saved = _level(D, E, r)
        total = total + ld
        stack.append(saved)
    l_root = _chol(D)
    total = total + _logdet(l_root)
    if b is None:
        return total, None
    x = _chol_solve(l_root, r[..., None])[..., 0]
    for lo, Eo, Er, ro in reversed(stack):
        xr = torch.cat([x[1:], torch.zeros_like(x[:1])])
        # x_o = D_o⁻¹ (r_o − A[2t+1, 2t] x_{2t} − A[2t+1, 2t+2] x_{2t+2})
        rhs = ro - (Eo @ x[..., None])[..., 0] - (Er.mT @ xr[..., None])[..., 0]
        xo = _chol_solve(lo, rhs[..., None])[..., 0]
        x = torch.stack([x, xo], dim=1).reshape(-1, k)
    return total, x.reshape(-1)[: b.shape[0]]


def cr_logdet(band: torch.Tensor) -> torch.Tensor:
    """log|A| for a symmetric positive-definite lower band (k+1, m)."""
    return _cr_sweep(band)[0]


def cr_solve(band: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A⁻¹ b for a symmetric positive-definite lower band; b is (m,)."""
    return _cr_sweep(band, b)[1]


def cr_logdet_solve(band: torch.Tensor, b: torch.Tensor):
    """(log|A|, A⁻¹ b) from one reduction."""
    return _cr_sweep(band, b)


def _logdet_grad(band: torch.Tensor, b: torch.Tensor | None = None):
    """(log|A|, ∇_band log|A|, A⁻¹b or None) from one reduction.  Where the
    caller's graph reaches ``band`` the gradient is taken with
    ``create_graph`` (so it can be differentiated again), else on a detached
    copy, under ``enable_grad`` so that it works inside ``no_grad`` too."""
    if torch.is_grad_enabled() and band.requires_grad:
        ld, x = _cr_sweep(band, b)
        (g,) = torch.autograd.grad(ld, band, create_graph=True)
        return ld, g, x
    with torch.enable_grad():
        leaf = band.detach().requires_grad_()
        ld, x = _cr_sweep(leaf, b)
        (g,) = torch.autograd.grad(ld, leaf)
    return ld.detach(), g, None if x is None else x.detach()


def cr_inverse_band(band: torch.Tensor) -> torch.Tensor:
    """band(A⁻¹) as ∇ log|A| over the band weights (the Takahashi selected
    inverse); differentiable where the caller's graph reaches ``band``."""
    k, m = band.shape[0] - 1, band.shape[1]
    return _logdet_grad(band)[1] / band_weights(k, m, band)


def cr_trace(band: torch.Tensor, big: torch.Tensor) -> torch.Tensor:
    """tr(A⁻¹ B) = ⟨∇ log|A|, B⟩ for a banded symmetric positive-definite A
    and a banded symmetric B (lower bands of one shape).  Differentiable in
    both: in A by double backward through the reduction."""
    return torch.sum(_logdet_grad(band)[1] * big)


def cr_logdet_trace(band: torch.Tensor, big: torch.Tensor):
    """(log|A|, tr(A⁻¹B)) from one reduction: ``cr_logdet`` and
    ``cr_trace`` together, as the collapsed core needs them."""
    ld, g, _ = _logdet_grad(band)
    return ld, torch.sum(g * big)


def cr_inverse_band_solve(band: torch.Tensor, b: torch.Tensor):
    """(band(A⁻¹), A⁻¹b) from one reduction, not differentiated: the
    posterior's S_P and u."""
    k, m = band.shape[0] - 1, band.shape[1]
    with torch.no_grad():
        _, g, x = _logdet_grad(band, b)
        return g / band_weights(k, m, band), x
