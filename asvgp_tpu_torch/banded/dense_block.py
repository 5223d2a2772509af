"""The dense-block Cholesky ⊗ inverse kernel, K16.

PyTorch counterpart of ``asvgp_tpu/banded/pallas_ds_block.py``.
``chol_inv_dense(m)`` returns (L, L⁻¹) for one (B, B) symmetric
positive-definite block or a batch (nb, B, B) of them, both exactly
lower-triangular (the strict upper triangle is 0.0); only the lower
triangle of ``m`` is read.  On a CUDA tensor it launches the hand-written
kernel (csrc/block_chol_inv.cu, one CTA per block) or raises; on a CPU
tensor it runs ``chol_inv_dense_plain``, the same right-looking column
sweep in float64 torch ops (``block_ds._fused_sweep_ds`` without the
double-single split): pivot 1/√d, scale the column, rank-1 Schur update,
and the row of the inverse from the same pivot.

It is the diagonal-block step of the block-banded Cholesky
(banded/block.py), as K16 is of ``block_ds.panel_chol_ds``.  The JAX
package sends blocks wider than its 128-lane tile elsewhere; the kernel
here takes every B, with a global-memory workspace where shared memory
does not fit.
"""

from __future__ import annotations

import numpy as np
import torch

from asvgp_tpu_torch.banded import _build, core


def _check(m: torch.Tensor) -> int:
    if m.ndim not in (2, 3) or m.shape[-1] != m.shape[-2] or m.shape[-1] < 1:
        raise ValueError(f"chol_inv_dense takes (B, B) or (nb, B, B) blocks, got {tuple(m.shape)}")
    return m.shape[-1]


def _sqrt_rn(d: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root, as the kernel takes it.  Torch's
    CPU kernel goes through SLEEF's vectorized sqrt, within an ulp but not
    always the nearest double (about 1 % of random inputs differ), and at
    κ = 1e10 an ulp in a pivot moves L⁻¹ by 1e-8; numpy's is correctly
    rounded, as is CUDA's."""
    if d.device.type == "cpu":
        return torch.as_tensor(np.sqrt(d.detach().numpy()), dtype=d.dtype)
    return torch.sqrt(d)


def chol_inv_dense_plain(m: torch.Tensor):
    """Plain version of K16: (L, L⁻¹) of the SPD block(s) ``m``, from a
    float64 column sweep over the lower triangle, on any device."""
    B = _check(m)
    core._count_plain(m)
    s = m.clone()
    l_out = torch.zeros_like(m)
    t = torch.eye(B, dtype=m.dtype, device=m.device).expand_as(m).clone()
    for c in range(B):
        d = s[..., c, c]
        rs = 1.0 / _sqrt_rn(d)
        col = s[..., c:, c] * rs[..., None]  # L[c:, c]; L[c, c] = d·rs
        l_out[..., c:, c] = col
        t[..., c, : c + 1] *= rs[..., None]
        if c + 1 < B:
            below = col[..., 1:]  # L[r, c] for r > c
            s[..., c + 1:, c + 1:] -= below[..., :, None] * below[..., None, :]
            t[..., c + 1:, : c + 1] -= below[..., :, None] * t[..., c, None, : c + 1]
    return l_out, t


def chol_inv_dense(m: torch.Tensor):
    """K16 on a CUDA tensor, its plain version on a CPU tensor: (L, L⁻¹)
    with ``m = L Lᵀ`` for one (B, B) block or each of a batch (nb, B, B),
    float64, both outputs exactly lower-triangular."""
    B = _check(m)
    if m.device.type == "cpu":
        return chol_inv_dense_plain(m)
    dev = m.device
    if dev.type != "cuda":
        raise ValueError(f"chol_inv_dense runs on 'cpu' or 'cuda' tensors, got {dev}")
    if m.dtype != torch.float64:
        raise TypeError(f"the CUDA kernel takes float64 blocks, got {m.dtype}")
    if not m.is_contiguous():
        raise ValueError("the CUDA kernel takes contiguous blocks")
    if torch.is_grad_enabled() and m.requires_grad:
        raise NotImplementedError(
            "chol_inv_dense on the GPU is not differentiable by itself: differentiate "
            "through banded.block.cholesky_block_banded, or call it under torch.no_grad()"
        )
    nb = 1 if m.ndim == 2 else m.shape[0]
    l_out = torch.empty_like(m)
    t = torch.empty_like(m)
    ws_per_block = _build.load().asvgp_chol_inv_dense_workspace(B)
    ws = m.new_empty(nb * ws_per_block) if ws_per_block > 0 else None
    core._launch("chol_inv_dense", "asvgp_chol_inv_dense", dev, B, nb, m.data_ptr(),
                 l_out.data_ptr(), t.data_ptr(), None if ws is None else ws.data_ptr())
    return l_out, t
