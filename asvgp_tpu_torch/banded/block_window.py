"""The window quadratic form of GPRKron's predictive variance, K24.

``block_window_quad(sp, v1, c1, v_t, r_t)`` returns, for each of n test
points, kusᵀ P⁻¹ kus from the block band of P⁻¹ alone:

  Σ_{d=0..k₁} mult_d Σ_{s=0..k₁−d} v1[i, s+d] v1[i, s]
      · Σ_{t,u} v_t[i, t] v_t[i, u] sp[d, c1[i]+s, r_t[i, t], r_t[i, u]]

with mult₀ = 1 and mult_{d>0} = 2 (a block above the diagonal is the
transpose of one below).  ``sp`` is the (k₁+1, m₁, M₂, M₂) block-lower
storage of P⁻¹'s band (``block.takahashi_inverse_block_banded``), ``v1``
(n, k₁+1) and ``c1`` (n,) the first dimension's basis values and first
cell, ``v_t`` and ``r_t`` (n, T) the flattened trailing window's weights
and indices into M₂ (``models/kron.py``).

On a CUDA tensor it launches the hand-written kernel (csrc/block_window.cu,
one thread a point, nothing written but the output) or raises; on a CPU
tensor it runs ``block_window_quad_plain``, a gather and an einsum a block
pair.  The kernel has no backward: on the card it refuses operands that
require grad, where the CPU's plain version is differentiable.  The JAX package has no kernel here (XLA's gathers,
``asvgp_tpu/models/kron.py:448-465``).
"""

from __future__ import annotations

import torch

from asvgp_tpu_torch.banded import core


def _check(sp, v1, c1, v_t, r_t) -> tuple:
    """(K, T) of consistent shapes, all on one device."""
    if sp.ndim != 4 or sp.shape[2] != sp.shape[3]:
        raise ValueError(f"sp must be (k1+1, m1, M2, M2), got {tuple(sp.shape)}")
    K, n, T = sp.shape[0], v1.shape[0], v_t.shape[-1]
    for name, t, want in (("v1", v1, (n, K)), ("c1", c1, (n,)), ("v_t", v_t, (n, T)),
                          ("r_t", r_t, (n, T))):
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must be {want}, got {tuple(t.shape)}")
    devices = {t.device for t in (sp, v1, c1, v_t, r_t)}
    if len(devices) != 1:
        raise ValueError(f"all operands must lie on one device, got {sorted(map(str, devices))}")
    return K, T


def block_window_quad_plain(sp, v1, c1, v_t, r_t):
    """Plain version of K24 on any device: for each block pair (d, s) one
    (n, T, T) window gathered from ``sp[d]`` and contracted with v_t."""
    K, _ = _check(sp, v1, c1, v_t, r_t)
    core._count_plain(v1)
    quad = torch.zeros_like(v1[:, 0])
    for d in range(K):
        mult = 1.0 if d == 0 else 2.0
        for s in range(K - d):
            win = sp[d][(c1 + s)[:, None, None], r_t[:, :, None], r_t[:, None, :]]
            val = torch.einsum("nt,ntu,nu->n", v_t, win, v_t)
            quad = quad + mult * v1[:, s + d] * v1[:, s] * val
    return quad


def block_window_quad(sp, v1, c1, v_t, r_t):
    """K24 on CUDA tensors, its plain version on CPU tensors: the (n,)
    float64 window quadratic forms kusᵀ P⁻¹ kus."""
    K, T = _check(sp, v1, c1, v_t, r_t)
    dev = sp.device
    if dev.type == "cpu":
        return block_window_quad_plain(sp, v1, c1, v_t, r_t)
    if dev.type != "cuda":
        raise ValueError(f"block_window_quad runs on 'cpu' or 'cuda' tensors, got {dev}")
    if not 1 <= K <= core.MAX_K + 1:
        raise ValueError(f"the CUDA kernel takes k1 in 0..{core.MAX_K}, got k1={K - 1}")
    for t in (sp, v1, v_t):
        if t.dtype != torch.float64:
            raise TypeError(f"the CUDA kernel takes float64 sp, v1 and v_t, got {t.dtype}")
    for t in (c1, r_t):
        if t.dtype != torch.int64:
            raise TypeError(f"the CUDA kernel takes int64 c1 and r_t, got {t.dtype}")
    if not all(t.is_contiguous() for t in (sp, v1, c1, v_t, r_t)):
        raise ValueError("the CUDA kernel takes contiguous tensors")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (sp, v1, v_t)):
        raise NotImplementedError(
            "K24 (block_window_quad, GPRKron's predictive variance on the GPU) has no "
            "backward: predict under torch.no_grad() or from inputs that do not require "
            "grad; on the CPU the prediction is differentiable")
    n = v1.shape[0]
    if n >= 2**31:
        raise ValueError(f"the CUDA kernel takes fewer than 2**31 points, got {n}")
    out = torch.empty(n, dtype=torch.float64, device=dev)
    if n:
        core._launch("block_window_quad", "asvgp_block_window_quad", dev, K, T, n,
                     sp.shape[1], sp.shape[2], sp.data_ptr(), v1.data_ptr(), c1.data_ptr(),
                     v_t.data_ptr(), r_t.data_ptr(), out.data_ptr())
    return out
