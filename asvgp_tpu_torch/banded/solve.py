"""The banded triangular solves L x = b and Lᵀ x = b: K13 and K14 in
float64, K21 and K22 in float32, and their autograd Functions.

PyTorch counterpart of the solves of ``asvgp_tpu/banded/pallas_ds.py``
(``solve_lower_ds``, ``solve_upper_t_ds`` and the custom VJPs
``solve_lower_band_ds``, ``solve_upper_band_transpose_ds``) and of
``pallas_kernels.py`` (``solve_lower_pallas``, ``solve_upper_t_pallas``,
``solve_lower_band_p``, ``solve_upper_band_transpose_p``).  Two wrappers:

  K13 / K21 ``solve_lower``: x = L⁻¹ b;
  K14 / K22 ``solve_upper_t``: x = L⁻ᵀ b;

as hand-written CUDA kernels (csrc/banded_solve.cu: ``solve_lower<K, T>``
and ``solve_upper_t<K, T>``, one chunk kernel walking the rows down or up,
a substitution partitioned into chunks whose incoming windows a scan over
the chunks' affine maps supplies, three launches on the stream with
scratch from here) on CUDA tensors, each dtype under its own launch counter
(``solve_lower`` for float64, ``solve_lower_f32`` for float32, ...), one
count per call, and as their plain versions (the recursions of
banded/ops.py) on CPU tensors.  A CUDA tensor launches the kernel or
raises.  b is (m,) or (m, r): the TPU kernels take one vector and
the JAX package runs a matrix right-hand side through its scan; here the
kernels take r columns, so no public solve runs a plain loop on the card.
Bandwidth k = 0 is a division and runs in torch ops on either device.

``SolveLowerBand`` and ``SolveUpperBandTranspose`` make the solves
differentiable.  Their backward is the closed form of the JAX VJPs: for
x = L⁻¹ b, b̄ = L⁻ᵀ x̄ and L̄_band[p, c] = −b̄_{c+p}·x_c; for x = L⁻ᵀ b,
b̄ = L⁻¹ x̄ and L̄_band[p, c] = −x_{c+p}·b̄_c (summed over the columns of
a matrix right-hand side, zero on the padding slots).  So the backward of
each solve is the other solve's kernel.
"""

from __future__ import annotations

import functools

import torch

from asvgp_tpu_torch.banded import _build, core, ops
from asvgp_tpu_torch.banded.single import BOTH, route


def _check(l_band, b):
    """(k, m) of a (k+1, m) band and a right-hand side (m,) or (m, r) on
    its device."""
    k, m = core._check_shapes((l_band,), ())
    if b.ndim not in (1, 2) or b.shape[0] != m:
        raise ValueError(f"b must be (m,) or (m, r) with m = {m}, got {tuple(b.shape)}")
    if b.device != l_band.device:
        raise ValueError(f"L and b must lie on one device, got {l_band.device} and {b.device}")
    return k, m


def _divide(l_band, b):
    """x = b / diag(L): both solves at bandwidth k = 0."""
    return b / (l_band[0] if b.ndim == 1 else l_band[0][:, None])


@functools.lru_cache(maxsize=64)
def _workspace(k: int, m: int, r: int) -> int:
    """Elements of scratch the chunk maps of a solve need (0 when the rows
    form one chunk), asked of the kernels' library once per shape."""
    return _build.load().asvgp_solve_workspace(k, m, r)


def _solve(name, l_band, b, plain):
    """Check, then the plain version on a CPU tensor or one launch of the
    kernel on a CUDA tensor, with the scratch its chunk maps need."""
    k, m = _check(l_band, b)
    if k == 0:
        return _divide(l_band, b)
    if l_band.device.type == "cpu":
        return plain(l_band, b)
    core._check_cuda(k, (l_band, b), BOTH)
    x = torch.empty_like(b)
    r = 1 if b.ndim == 1 else b.shape[1]
    if r == 0:
        return x
    # empty (and unread) when the rows form one chunk
    ws = l_band.new_empty(_workspace(k, m, r))
    core._launch(*route(name, l_band), l_band.device, k, m, r,
                 l_band.data_ptr(), b.data_ptr(), x.data_ptr(), ws.data_ptr())
    return x


# ---------------------------------------------------------------------------
# K13 / K21: L x = b
# ---------------------------------------------------------------------------


def solve_lower_plain(l_band, b):
    """Plain version of K13 and K21: forward substitution."""
    core._count_plain(l_band)
    return ops.solve_lower_band_plain(l_band, b)


def solve_lower(l_band, b):
    """K13 (float64) or K21 (float32) on CUDA tensors, its plain version on
    CPU tensors: x = L⁻¹ b for a (k+1, m) lower band L and b of shape (m,)
    or (m, r)."""
    return _solve("solve_lower", l_band, b, solve_lower_plain)


# ---------------------------------------------------------------------------
# K14 / K22: Lᵀ x = b
# ---------------------------------------------------------------------------


def solve_upper_t_plain(l_band, b):
    """Plain version of K14 and K22: backward substitution with Lᵀ."""
    core._count_plain(l_band)
    return ops.solve_upper_band_transpose_plain(l_band, b)


def solve_upper_t(l_band, b):
    """K14 (float64) or K22 (float32) on CUDA tensors, its plain version on
    CPU tensors: x = L⁻ᵀ b."""
    return _solve("solve_upper_t", l_band, b, solve_upper_t_plain)


# ---------------------------------------------------------------------------
# the differentiable solves
# ---------------------------------------------------------------------------


def lagged_product_band(u, v, k: int):
    """band[p, c] = Σ_r u[c+p, r]·v[c, r] for p = 0..k (u, v of one shape,
    (m,) or (m, r)); zero where c + p ≥ m."""
    rows = []
    for p in range(k + 1):
        prod = torch.cat([u[p:], u.new_zeros((p,) + tuple(u.shape[1:]))]) * v
        rows.append(prod if prod.ndim == 1 else prod.sum(dim=1))
    return torch.stack(rows)


class SolveLowerBand(torch.autograd.Function):
    """x = L⁻¹ b, differentiable in L and b: K13 (K21 in float32) forward;
    backward b̄ = L⁻ᵀ x̄ by K14 (K22) and L̄_band[p, c] = −b̄_{c+p}·x_c
    (``pallas_ds._sl_ds_b``, ``pallas_kernels._solve_p_bwd``)."""

    @staticmethod
    def forward(ctx, l_band, b):
        l_band = l_band.contiguous()
        x = solve_lower(l_band, b.contiguous())
        ctx.save_for_backward(l_band, x)
        return x

    @staticmethod
    def backward(ctx, x_bar):
        l_band, x = ctx.saved_tensors
        b_bar = solve_upper_t(l_band, x_bar.contiguous())
        l_bar = None
        if ctx.needs_input_grad[0]:
            l_bar = -lagged_product_band(b_bar, x, l_band.shape[0] - 1)
        return l_bar, b_bar if ctx.needs_input_grad[1] else None


class SolveUpperBandTranspose(torch.autograd.Function):
    """x = L⁻ᵀ b, differentiable in L and b: K14 (K22 in float32) forward;
    backward b̄ = L⁻¹ x̄ by K13 (K21) and L̄_band[p, c] = −x_{c+p}·b̄_c
    (``pallas_ds._su_ds_b``, ``pallas_kernels._solve_ut_p_bwd``)."""

    @staticmethod
    def forward(ctx, l_band, b):
        l_band = l_band.contiguous()
        x = solve_upper_t(l_band, b.contiguous())
        ctx.save_for_backward(l_band, x)
        return x

    @staticmethod
    def backward(ctx, x_bar):
        l_band, x = ctx.saved_tensors
        b_bar = solve_lower(l_band, x_bar.contiguous())
        l_bar = None
        if ctx.needs_input_grad[0]:
            l_bar = -lagged_product_band(x, b_bar, l_band.shape[0] - 1)
        return l_bar, b_bar if ctx.needs_input_grad[1] else None
