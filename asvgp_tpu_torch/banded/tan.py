"""Tangent-fused collapsed-core sweeps: value AND gradient in two kernels.

PyTorch counterpart of ``asvgp_tpu/banded/pallas_ds_tan.py``.  Kuu is a
Matérn RKHS Gram band, Kuu(σ², ℓ) = σ⁻²·G(ℓ) (features/spline_features.py
``make_kuu``), so the trace term tr(Kuu⁻¹B) depends on two scalars only:

  ∂trace/∂σ² = trace / σ²                       (closed form)
  ∂trace/∂ℓ  = one directional derivative in T = ∂Kuu/∂ℓ,

and that one direction rides as a forward tangent inside the two sweeps:

  K3 ``chol_pair_solve_tan``: K1 (Cholesky of Kuu and P, lower solve) plus
     the tangent L̇ of chol(Kuu) in the direction T and the tangent of its
     reciprocal pivots;
  K4 ``tak_pair_solve_tan``: K2 (Takahashi bands of Kuu⁻¹ and P⁻¹, upper
     solve) plus the tangent Ṡ of the band of Kuu⁻¹.

Every other gradient of the collapsed core is closed-form in the sweeps'
outputs (w = 2 − δ_{j0} counts the symmetric band twice off the diagonal):

  ∂log|P|/∂P = w∘S_P,  ∂(bᵀP⁻¹b)/∂P = −w∘band(uuᵀ),  ∂/∂b = 2u,
  ∂log|Kuu|/∂θ = ⟨w∘S_Kuu, ∂Kuu/∂θ⟩,  ∂trace/∂B = w∘S_Kuu,

so ``collapsed_core_matern`` is a ``torch.autograd.Function`` whose backward
is elementwise: no adjoint sweep runs in a training step.

The tangent recursions are written out in ``ops.cholesky_band_plain`` and
``ops.takahashi_inverse_band_plain`` (their ``t_band``/``ldot_band`` forms), the
tangent of a reciprocal pivot is i̇v = −iv²·L̇₀.  K3 and K4 are hand-written
CUDA kernels (csrc/banded_tan.cu) on CUDA tensors; on CPU tensors their
plain versions (``*_plain``, composed from those recursions) run.  A CUDA
tensor launches the kernel or raises.  On the card each kernel cuts its
walk over the m columns into chunks run in parallel, Kuu and P one to a
block: K3 is the twisted K5's partition on one stream (the Schur-complement
update of each chunk's first rows walked between chunks, as a dual number
on Kuu, with the lower solve's coupling on P), K4 the twisted K6's (a scan
over the chunks' affine maps) from a zero carry; three launches each,
scratch from ``core.tan_workspace``, a call counts one launch.
"""

from __future__ import annotations

import torch

from asvgp_tpu_torch.banded import core, ops

LAUNCHES = core.LAUNCHES


# ---------------------------------------------------------------------------
# K3: forward sweep with the Kuu tangent
# ---------------------------------------------------------------------------


def chol_pair_solve_tan_plain(kuu_band, tan_band, p_band, b):
    """Plain version of K3: (l_kuu, l_p, iv (2, m), c0, ldot_kuu, ivdot_kuu)."""
    core._count_plain(kuu_band)
    l_kuu, ldot = ops.cholesky_band_plain(kuu_band, tan_band)
    l_p = ops.cholesky_band_plain(p_band)
    iv = torch.stack([1.0 / l_kuu[0], 1.0 / l_p[0]], dim=0)
    c0 = ops.solve_lower_band_plain(l_p, b)
    return l_kuu, l_p, iv, c0, ldot, -iv[0] * iv[0] * ldot[0]


def chol_pair_solve_tan(kuu_band, tan_band, p_band, b):
    """K3 on CUDA tensors, its plain version on CPU tensors.

    K1's outputs (l_kuu, l_p, iv, c0) plus ldot_kuu = ∂_ε chol(Kuu + εT)
    and ivdot_kuu, the tangent of 1/diag(L_Kuu)."""
    k, m = core._check_shapes((kuu_band, tan_band, p_band), (b,))
    if kuu_band.device.type == "cpu":
        return chol_pair_solve_tan_plain(kuu_band, tan_band, p_band, b)
    core._check_cuda(k, (kuu_band, tan_band, p_band, b))
    l_kuu = torch.empty_like(kuu_band)
    l_p = torch.empty_like(p_band)
    iv = kuu_band.new_empty((2, m))
    c0 = kuu_band.new_empty((m,))
    ldot = torch.empty_like(kuu_band)
    ivdot = kuu_band.new_empty((m,))
    ws = kuu_band.new_empty(core.tan_workspace(k, m))
    core._launch("chol_pair_solve_tan", "asvgp_chol_pair_solve_tan", kuu_band.device, k, m,
                 *(t.data_ptr() for t in (kuu_band, tan_band, p_band, b, l_kuu, l_p, iv, c0,
                                          ldot, ivdot, ws)))
    return l_kuu, l_p, iv, c0, ldot, ivdot


# ---------------------------------------------------------------------------
# K4: reverse sweep with the Takahashi tangent
# ---------------------------------------------------------------------------


def tak_pair_solve_tan_plain(l_kuu, l_p, iv, c0, ldot, ivdot):
    """Plain version of K4: (s_kuu, s_p, u, sdot_kuu).  The reciprocal
    pivots and their tangent are implied by the factors and not read."""
    core._count_plain(l_kuu)
    s_kuu, sdot = ops.takahashi_inverse_band_plain(l_kuu, ldot)
    s_p = ops.takahashi_inverse_band_plain(l_p)
    u = ops.solve_upper_band_transpose_plain(l_p, c0)
    return s_kuu, s_p, u, sdot


def tak_pair_solve_tan(l_kuu, l_p, iv, c0, ldot, ivdot):
    """K4 on CUDA tensors, its plain version on CPU tensors.

    Takes K3's outputs; returns (s_kuu, s_p, u, sdot_kuu): the bands of
    Kuu⁻¹ and P⁻¹, u = P⁻¹b and sdot_kuu = ∂_ε band((Kuu + εT)⁻¹)."""
    k, m = core._check_shapes((l_kuu, l_p, ldot), (c0, ivdot))
    if tuple(iv.shape) != (2, m) or iv.device != l_kuu.device:
        raise ValueError(f"iv must be (2, m) = (2, {m}) on {l_kuu.device}")
    if l_kuu.device.type == "cpu":
        return tak_pair_solve_tan_plain(l_kuu, l_p, iv, c0, ldot, ivdot)
    core._check_cuda(k, (l_kuu, l_p, iv, c0, ldot, ivdot))
    s_kuu = torch.empty_like(l_kuu)
    s_p = torch.empty_like(l_p)
    u = c0.new_empty((m,))
    sdot = torch.empty_like(l_kuu)
    ws = l_kuu.new_empty(core.tan_workspace(k, m))
    core._launch("tak_pair_solve_tan", "asvgp_tak_pair_solve_tan", l_kuu.device, k, m,
                 *(t.data_ptr() for t in (l_kuu, l_p, iv, c0, ldot, ivdot, s_kuu, s_p, u, sdot,
                                          ws)))
    return s_kuu, s_p, u, sdot


# ---------------------------------------------------------------------------
# the two sweeps together
# ---------------------------------------------------------------------------


def _assemble(k3_out, k4_out):
    l_kuu, l_p, iv, c0, _, _ = k3_out
    s_kuu, s_p, u, sdot = k4_out
    return l_kuu, l_p, s_kuu, s_p, c0, u, iv[0], sdot


def factor_takahashi_solve_tan(kuu_band, tan_band, p_band, b):
    """K3 + K4: returns (l_kuu, l_p, s_kuu, s_p, c0, u, iv_kuu, sdot_kuu),
    the outputs of ``core.factor_takahashi_solve`` plus
    sdot_kuu = ∂_ε band((Kuu + ε·tan)⁻¹), all float64."""
    k3 = chol_pair_solve_tan(kuu_band, tan_band, p_band, b)
    return _assemble(k3, tak_pair_solve_tan(*k3))


def factor_takahashi_solve_tan_plain(kuu_band, tan_band, p_band, b):
    """The plain version of ``factor_takahashi_solve_tan``, on any device."""
    k3 = chol_pair_solve_tan_plain(kuu_band, tan_band, p_band, b)
    return _assemble(k3, tak_pair_solve_tan_plain(*k3))


def core_sweeps(kuu_band, tan_band, p_band, b):
    """(log|Kuu|, log|P|, bᵀP⁻¹b, S_Kuu, S_P, u, Ṡ_Kuu) from K3 + K4: the
    sweeps of the single-ended ``collapsed_core_matern``."""
    l_kuu, l_p, s_kuu, s_p, c0, u, _, sdot = factor_takahashi_solve_tan(
        kuu_band, tan_band, p_band, b
    )
    return (ops.log_det_from_cholesky(l_kuu), ops.log_det_from_cholesky(l_p),
            torch.sum(torch.square(c0)), s_kuu, s_p, u, sdot)


# ---------------------------------------------------------------------------
# collapsed core with the Matérn two-hyperparameter structure
# ---------------------------------------------------------------------------


def band_weights(k: int, m: int, like: torch.Tensor) -> torch.Tensor:
    """(2 − δ_{j0}) symmetric double-count weights for lower-band storage."""
    w = like.new_full((k + 1, m), 2.0)
    w[0] = 1.0
    return w


def outer_band(u: torch.Tensor, k: int) -> torch.Tensor:
    """O[j, i] = u_{i+j} u_i (lower band of u uᵀ), right-padded."""
    m = u.shape[0]
    rows = [torch.cat([u[j:] * u[: m - j], u.new_zeros(j)]) for j in range(k + 1)]
    return torch.stack(rows, dim=0)


class MaternCore(torch.autograd.Function):
    """(log|Kuu|, log|P|, bᵀP⁻¹b, tr(Kuu⁻¹B)) with Kuu = kuu_fn(var, ell).

    CONTRACT: kuu_fn(var, ell) = var⁻¹·G(ell), true of every Matérn RKHS
    Gram band (``make_kuu``): the variance leg of the trace gradient uses
    ∂tr(Kuu⁻¹B)/∂var = trace/var.  ``sweeps(kuu, tan, p, b)`` returns
    (log|Kuu|, log|P|, bᵀP⁻¹b, S_Kuu, S_P, u, Ṡ_Kuu): K3 + K4
    (``core_sweeps``) or the twisted K5 + middle + K6.  The forward takes
    T = ∂Kuu/∂ℓ by forward mode through ``kuu_fn``; the backward is
    elementwise in the saved bands plus the VJP of ``kuu_fn``.
    """

    @staticmethod
    def forward(ctx, kuu_fn, sweeps, var, ell, p_band, b, big_band):
        kuu, tan = torch.func.jvp(lambda l: kuu_fn(var, l), (ell,), (torch.ones_like(ell),))
        ld_kuu, ld_p, quad, s_kuu, s_p, u, sdot = sweeps(kuu, tan, p_band, b)
        w = band_weights(kuu.shape[0] - 1, kuu.shape[1], kuu)
        trace = torch.sum(w * s_kuu * big_band)
        trace_dot = torch.sum(w * sdot * big_band)
        ctx.kuu_fn = kuu_fn
        ctx.save_for_backward(var, ell, s_kuu, s_p, u, big_band, trace, trace_dot)
        return ld_kuu, ld_p, quad, trace

    @staticmethod
    def backward(ctx, g_ldk, g_ldp, g_quad, g_tr):
        var, ell, s_kuu, s_p, u, big_band, trace, trace_dot = ctx.saved_tensors
        k = s_kuu.shape[0] - 1
        w = band_weights(k, s_kuu.shape[1], s_kuu)
        _, _, need_var, need_ell, need_p, need_b, need_big = ctx.needs_input_grad

        p_bar = g_ldp * (w * s_p) - g_quad * (w * outer_band(u, k)) if need_p else None
        b_bar = (2.0 * g_quad) * u if need_b else None
        big_bar = g_tr * (w * s_kuu) if need_big else None
        var_bar = ell_bar = None
        if need_var or need_ell:
            # log|Kuu| leg: ⟨w∘S_Kuu, ∂Kuu/∂θ⟩ through the elementwise band
            # assembly by reverse mode
            with torch.enable_grad():
                v = var.detach().requires_grad_()
                l = ell.detach().requires_grad_()
                var_bar, ell_bar = torch.autograd.grad(
                    ctx.kuu_fn(v, l), (v, l), g_ldk * (w * s_kuu)
                )
            # trace leg: closed form in var (Kuu ∝ 1/var), fused tangent in ell
            var_bar = var_bar + g_tr * trace / var
            ell_bar = ell_bar + g_tr * trace_dot
        return None, None, var_bar, ell_bar, p_bar, b_bar, big_bar


def collapsed_core_matern(kuu_fn, var, ell, p_band, b, big_band):
    """Single-ended (K3 + K4) ``MaternCore``: differentiable in var, ell,
    p_band, b and big_band."""
    return MaternCore.apply(kuu_fn, core_sweeps, var, ell, p_band, b, big_band)
