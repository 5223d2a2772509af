"""Single-matrix banded Cholesky and Takahashi, and their adjoints: K9–K12
in float64 and K17–K20 in float32, and the pair Cholesky K15.

PyTorch counterpart of ``asvgp_tpu/banded/pallas_ds.py`` (its Cholesky and
Takahashi kernels and their custom VJPs) and of the forward pair kernel of
``pallas_ds_pair.py``.  Five wrappers:

  K9  ``chol_fwd``: L = chol(A) from the lower band of A;
  K15 ``chol_fwd_pair``: two of them, of one shape, in one launch;
  K10 ``chol_bwd``: Ā from (L, L̄), the adjoint of K9;
  K11 ``tak_fwd``: the band of A⁻¹ from L (the Takahashi recursion);
  K12 ``tak_bwd``: L̄ from (L, S, S̄), the adjoint of K11, dividing by the
      pivots itself (K7 in banded/core.py is the same recursion fed with
      K1's reciprocal pivots);

as hand-written CUDA kernels (csrc/banded_adjoint.cu ``chol_fwd<K>``,
``chol_bwd<K>``, ``tak_fwd<K>``, ``tak_bwd<K>``; each partitioned into
chunks, three launches with scratch from ``core.schur_workspace`` for the
Cholesky and ``core.carry_workspace`` for the other three, one count per
call) on CUDA tensors, and as their plain versions on CPU tensors: the
recursions of banded/ops.py, forward and explicit reverse-mode.  A CUDA tensor launches the kernel or
raises.  The four wrappers dispatch on the dtype: float64 runs K9–K12,
float32 the same kernels' float instantiation, K17–K20 (the JAX package's
``pallas_kernels.py``: ``_chol_fwd_kernel``, ``_chol_bwd_kernel``,
``_takahashi_fwd_kernel``, ``_takahashi_bwd_kernel``), each counted under
its own name (``chol_fwd_f32``, ...).  K15 is float64 only, as
``pallas_ds_pair`` is.  Bandwidth k = 0 is elementwise and runs in torch ops on either
device, as the JAX wrappers do; the kernels take k = 1..6.

``CholeskyBand`` (K9 forward, K10 backward), ``CholeskyBandPair`` (K15,
and K8 with a batch of two) and ``TakahashiInverseBand`` (K11, K12) are the
autograd Functions behind ``ops.cholesky_band``, ``ops.cholesky_band_pair``
and ``ops.takahashi_inverse_band``.  As in the JAX VJPs, the cotangent of a
band treats each stored entry as an independent variable, and the
right-padding slots get a zero cotangent.
"""

from __future__ import annotations

import torch

from asvgp_tpu_torch.banded import core, ops

LAUNCHES = core.LAUNCHES
# the dtypes of the kernels that have a float32 form (K17-K22)
BOTH = (torch.float64, torch.float32)


def route(name: str, t: torch.Tensor) -> tuple[str, str]:
    """(launch counter, C entry point) of kernel ``name`` for the dtype of
    ``t``: the float64 kernel, or its float32 form under ``name_f32``."""
    if t.dtype == torch.float32:
        return f"{name}_f32", f"asvgp_{name}_f32"
    return name, f"asvgp_{name}"


# ---------------------------------------------------------------------------
# K9: Cholesky
# ---------------------------------------------------------------------------


def chol_fwd_plain(a_band):
    """Plain version of K9."""
    core._count_plain(a_band)
    return ops.cholesky_band_plain(a_band)


def chol_fwd(a_band):
    """K9 (float64) or K17 (float32) on CUDA tensors, its plain version on
    CPU tensors: the lower band of L = chol(A), right-padding slots zeroed."""
    k, m = core._check_shapes((a_band,), ())
    if k == 0:
        return torch.sqrt(a_band)
    if a_band.device.type == "cpu":
        return chol_fwd_plain(a_band)
    core._check_cuda(k, (a_band,), BOTH)
    l_band = torch.empty_like(a_band)
    ws = a_band.new_empty(core.schur_workspace(k, m, 1))
    core._launch(*route("chol_fwd", a_band), a_band.device, k, m, 1,
                 a_band.data_ptr(), l_band.data_ptr(), ws.data_ptr())
    return l_band


# ---------------------------------------------------------------------------
# K15: two Choleskys in one launch
# ---------------------------------------------------------------------------


def chol_fwd_pair_plain(a_band, b_band):
    """Plain version of K15: the two factors, one after the other."""
    core._count_plain(a_band)
    return ops.cholesky_band_plain(a_band), ops.cholesky_band_plain(b_band)


def chol_fwd_pair(a_band, b_band):
    """K15 on CUDA tensors, its plain version on CPU tensors: the lower
    bands of chol(A) and chol(B) for two bands of one shape, from one
    call of K9's kernel with a batch of two
    (``pallas_ds_pair.cholesky_band_pair_fwd_ds``)."""
    k, m = core._check_shapes((a_band, b_band), ())
    if k == 0:
        return torch.sqrt(a_band), torch.sqrt(b_band)
    if a_band.device.type == "cpu":
        return chol_fwd_pair_plain(a_band, b_band)
    core._check_cuda(k, (a_band, b_band))
    a2 = torch.stack([a_band, b_band])
    l2 = torch.empty_like(a2)
    ws = a_band.new_empty(core.schur_workspace(k, m, 2))
    core._launch("chol_fwd_pair", "asvgp_chol_fwd", a_band.device, k, m, 2,
                 a2.data_ptr(), l2.data_ptr(), ws.data_ptr())
    return l2[0], l2[1]


# ---------------------------------------------------------------------------
# K10: Cholesky adjoint
# ---------------------------------------------------------------------------


def chol_bwd_plain(l_band, l_bar):
    """Plain version of K10: the explicit reverse-mode recursion."""
    core._count_plain(l_band)
    return ops.cholesky_band_bwd_plain(l_band, l_bar)


def chol_bwd(l_band, l_bar):
    """K10 (float64) or K18 (float32) on CUDA tensors, its plain version on
    CPU tensors: Ā from L and L̄ (``pallas_ds._chol_ds_b``)."""
    k, m = core._check_shapes((l_band, l_bar), ())
    if k == 0:
        return l_bar / (2.0 * l_band)
    if l_band.device.type == "cpu":
        return chol_bwd_plain(l_band, l_bar)
    core._check_cuda(k, (l_band, l_bar), BOTH)
    a_bar = torch.empty_like(l_band)
    ws = l_band.new_empty(core.carry_workspace(k, m, 1))
    core._launch(*route("chol_bwd", l_band), l_band.device, k, m, 1,
                 l_band.data_ptr(), l_bar.data_ptr(), a_bar.data_ptr(), ws.data_ptr())
    return a_bar


# ---------------------------------------------------------------------------
# K11: Takahashi band of the inverse
# ---------------------------------------------------------------------------


def tak_fwd_plain(l_band):
    """Plain version of K11."""
    core._count_plain(l_band)
    return ops.takahashi_inverse_band_plain(l_band)


def tak_fwd(l_band):
    """K11 (float64) or K19 (float32) on CUDA tensors, its plain version on
    CPU tensors: the band of A⁻¹ from the factor L of A (right padding of L
    must be zero)."""
    k, m = core._check_shapes((l_band,), ())
    if k == 0:
        return 1.0 / (l_band * l_band)
    if l_band.device.type == "cpu":
        return tak_fwd_plain(l_band)
    core._check_cuda(k, (l_band,), BOTH)
    s_band = torch.empty_like(l_band)
    ws = l_band.new_empty(core.carry_workspace(k, m, 1))
    core._launch(*route("tak_fwd", l_band), l_band.device, k, m, 1,
                 l_band.data_ptr(), s_band.data_ptr(), ws.data_ptr())
    return s_band


# ---------------------------------------------------------------------------
# K12: Takahashi adjoint
# ---------------------------------------------------------------------------


def tak_bwd_plain(l_band, s_band, s_bar):
    """Plain version of K12: the explicit reverse-mode recursion."""
    core._count_plain(l_band)
    return ops.takahashi_bwd_plain(l_band, s_band, s_bar)


def tak_bwd(l_band, s_band, s_bar):
    """K12 (float64) or K20 (float32) on CUDA tensors, its plain version on
    CPU tensors: L̄ from L, S = tak_fwd(L) and S̄ (``pallas_ds._tak_ds_b``)."""
    k, m = core._check_shapes((l_band, s_band, s_bar), ())
    if k == 0:
        return -2.0 * s_bar / (l_band ** 3)
    if l_band.device.type == "cpu":
        return tak_bwd_plain(l_band, s_band, s_bar)
    core._check_cuda(k, (l_band, s_band, s_bar), BOTH)
    l_bar = torch.empty_like(l_band)
    ws = l_band.new_empty(core.carry_workspace(k, m, 1))
    core._launch(*route("tak_bwd", l_band), l_band.device, k, m, 1, l_band.data_ptr(),
                 s_band.data_ptr(), s_bar.data_ptr(), None, l_bar.data_ptr(), ws.data_ptr())
    return l_bar


# ---------------------------------------------------------------------------
# the differentiable ops
# ---------------------------------------------------------------------------


class CholeskyBand(torch.autograd.Function):
    """Banded Cholesky L = chol(A): K9 forward, K10 backward
    (``pallas_ds.cholesky_band_ds``); in float32 K17 and K18
    (``pallas_kernels.cholesky_band_p``)."""

    @staticmethod
    def forward(ctx, a_band):
        l_band = chol_fwd(a_band.contiguous())
        ctx.save_for_backward(l_band)
        return l_band

    @staticmethod
    def backward(ctx, l_bar):
        (l_band,) = ctx.saved_tensors
        return chol_bwd(l_band, l_bar.contiguous())


class CholeskyBandPair(torch.autograd.Function):
    """Two banded Choleskys of one shape: K15 forward, K8 (the pair
    Cholesky adjoint, batch of two) backward, as
    ``pallas_ds_pair.cholesky_band_pair_ds`` and its VJP."""

    @staticmethod
    def forward(ctx, a_band, b_band):
        l_a, l_b = chol_fwd_pair(a_band.contiguous(), b_band.contiguous())
        ctx.save_for_backward(l_a, l_b)
        return l_a, l_b

    @staticmethod
    def backward(ctx, bar_a, bar_b):
        l_a, l_b = ctx.saved_tensors
        bars = [torch.zeros_like(l) if g is None else g for g, l in ((bar_a, l_a), (bar_b, l_b))]
        if l_a.shape[0] == 1:  # k = 0: elementwise
            return bars[0] / (2.0 * l_a), bars[1] / (2.0 * l_b)
        a_bar = core.chol_bwd_pair(torch.stack([l_a, l_b]), torch.stack(bars))
        return a_bar[0], a_bar[1]


class TakahashiInverseBand(torch.autograd.Function):
    """Band of A⁻¹ from L: K11 forward, K12 backward
    (``pallas_ds.takahashi_inverse_band_ds``); in float32 K19 and K20
    (``pallas_kernels.takahashi_inverse_band_p``)."""

    @staticmethod
    def forward(ctx, l_band):
        l_band = l_band.contiguous()
        s_band = tak_fwd(l_band)
        ctx.save_for_backward(l_band, s_band)
        return s_band

    @staticmethod
    def backward(ctx, s_bar):
        l_band, s_band = ctx.saved_tensors
        return tak_bwd(l_band, s_band, s_bar.contiguous())
