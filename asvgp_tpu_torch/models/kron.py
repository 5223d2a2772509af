"""GPRKron — tensor-product B-spline features for D ≥ 2 inputs, in PyTorch.

PyTorch counterpart of ``asvgp_tpu/models/kron.py``.  Everything stays
factorized or banded:

  log|Kuu|   the per-dimension banded Cholesky factors (K9, backward K10)
             and the Kronecker determinant identity
  trace term the per-dimension Takahashi bands (K11, backward K12) against
             the multiband of KufKfu, elementwise
  P          block-banded (block row i₁, block bandwidth k₁, dense blocks
             of side M₂ = Π_{d≥2} m_d, the trailing dimensions flattened
             row-major): the blocked Cholesky of banded/block.py, whose
             diagonal-block step is K16
  predict    the block Takahashi band of P⁻¹ and per-point window gathers,
             O(Π_d (k_d+1)²) per test point

D = 2 takes the statistics of stats/kron.py, D ≥ 3 those of
stats/kron_nd.py.  The data enter through the sufficient statistics,
computed once at construction on the model's device (the CUDA device
unless told otherwise); the hyperparameters and the batched predictions
are models/per_dimension.py's, shared with GPRAdditive.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from asvgp_tpu_torch import banded
from asvgp_tpu_torch.banded import block
from asvgp_tpu_torch.device import resolve_device
from asvgp_tpu_torch.features.spline_features import make_kuf, make_kuu, validate_kernel_basis
from asvgp_tpu_torch.models.gpr1d import window_quadratic_form
from asvgp_tpu_torch.models.parameters import positive
from asvgp_tpu_torch.models.per_dimension import (
    PerDimensionGP,
    PerDimensionPosterior,
    check_domain,
    params_to_kernels,
)
from asvgp_tpu_torch.stats.kron import (
    KronStats,
    compute_kron_stats,
    compute_kron_stats_sharded,
    t_band_to_blocks,
    t_band_trace_against_kron,
)
from asvgp_tpu_torch.stats.kron_nd import (
    compute_kron_stats_nd,
    compute_kron_stats_nd_sharded,
    t_band_to_blocks_nd,
    t_band_trace_against_kron_nd,
)
from asvgp_tpu_torch.utils.profiling import span, to_device

_LOG2PI = math.log(2.0 * math.pi)
_F64 = torch.float64


def _trailing_dense(bases, kuu_bands):
    """The dense Kronecker product of the trailing (d ≥ 2) Kuu factors,
    row-major over dimensions 2..D."""
    dense = None
    for b, kb in zip(bases[1:], kuu_bands[1:]):
        fd = banded.band_to_dense(banded.symmetrise_lower_band(kb), b.order, b.order)
        dense = fd if dense is None else torch.kron(dense, fd)
    return dense


def _p_blocks(bases, kuu_bands, sigma2, t_band):
    """Block-banded P = Kuu₁ ⊗ (⊗_{d≥2} Kuu_d) + KufKfu/σ²."""
    trailing = _trailing_dense(bases, kuu_bands)
    if len(bases) == 2:
        return t_band_to_blocks(t_band, kuu_bands[0], trailing, sigma2)
    return t_band_to_blocks_nd(t_band, kuu_bands[0], trailing, sigma2)


def kron_collapsed_elbo(bases, nu2s, params, stats: KronStats):
    """The collapsed ELBO from the Kronecker sufficient statistics, term by
    term as the JAX package's (and the reference's) bound, with P
    block-banded."""
    kernels = params_to_kernels(params, nu2s)
    sigma2 = positive(params["likelihood"]["raw_variance"])
    ms = [b.m for b in bases]

    kuu_bands = [make_kuu(k, b) for k, b in zip(kernels, bases)]
    l_bands = [banded.cholesky_band(kb) for kb in kuu_bands]
    # log|⊗_d A_d| = Σ_d (Π_{e≠d} m_e) log|A_d|
    log_det_kuu = sum(math.prod(ms) // ms[d] * banded.log_det_from_cholesky(l_bands[d])
                      for d in range(len(bases)))
    s_bands = [banded.takahashi_inverse_band(lb) for lb in l_bands]
    if len(bases) == 2:
        trace_term = t_band_trace_against_kron(stats.t_band, s_bands[0], s_bands[1])
    else:
        trace_term = t_band_trace_against_kron_nd(stats.t_band, s_bands)

    l_p, linv_p = block.cholesky_block_banded(_p_blocks(bases, kuu_bands, sigma2, stats.t_band))
    log_det_p = block.log_det_from_block_cholesky(l_p)
    c = block.solve_lower_block_banded(l_p, stats.kuf_y, linv_p) / sigma2
    kdiag_sum = stats.n * math.prod(k.variance for k in kernels)

    elbo = -0.5 * stats.n * (_LOG2PI + torch.log(sigma2))
    elbo = elbo - 0.5 * log_det_p
    elbo = elbo + 0.5 * log_det_kuu
    elbo = elbo - 0.5 * stats.yty / sigma2
    elbo = elbo + 0.5 * torch.sum(torch.square(c))
    elbo = elbo - 0.5 * kdiag_sum / sigma2
    elbo = elbo + 0.5 * trace_term / sigma2
    return elbo


class PosteriorKron(PerDimensionPosterior):
    """Cached GPRKron posterior: the block factorization is done once at
    construction; each prediction is window gathers, O(Π_d (k_d+1)²) per
    point, on the device of the posterior arrays."""

    def __init__(self, kernels, lik, bases, w_flat, sp, s_bands):
        super().__init__(kernels, lik, bases, w_flat.device)
        self.w_flat = w_flat  # (m1, M2)
        self.sp = sp          # (k1+1, m1, M2, M2) block band of P⁻¹
        self.s_bands = s_bands
        self.kdiag = math.prod(k.variance for k in kernels)

    def _predict_chunk(self, x):
        bases = self.bases
        k1 = bases[0].order
        with span("predict.basis"):
            v1, c1 = make_kuf(bases[0], x[:, 0])
            n = v1.shape[0]
            r1 = c1[:, None] + torch.arange(k1 + 1, device=c1.device)[None, :]
            # kusᵀ Kuu⁻¹ kus = Π_d (per-dimension window quadratic forms); with
            # it the flattened trailing window: indices r_t (n, T) into the
            # row-major Π_{d≥2} m_d axis and weights v_t (n, T), T = Π_{d≥2} (k_d+1)
            q_prod = window_quadratic_form(self.s_bands[0], v1, c1)
            v_t = r_t = None
            for d in range(1, len(bases)):
                vd, cd = make_kuf(bases[d], x[:, d])
                rd = cd[:, None] + torch.arange(bases[d].order + 1, device=cd.device)[None, :]
                q_prod = q_prod * window_quadratic_form(self.s_bands[d], vd, cd)
                if v_t is None:
                    v_t, r_t = vd, rd
                else:
                    r_t = (r_t[:, :, None] * bases[d].m + rd[:, None, :]).reshape(n, -1)
                    v_t = (v_t[:, :, None] * vd[:, None, :]).reshape(n, -1)
        with span("predict.mean"):
            # mean = Σ v1[s1] v_t[t] w[c1+s1, r_t[t]]
            w_win = self.w_flat[r1[:, :, None], r_t[:, None, :]]
            mean = torch.einsum("na,nat,nt->n", v1, w_win, v_t)
        with span("predict.var"):
            # kusᵀ P⁻¹ kus through the windows of the block Takahashi band
            quad_p = torch.zeros_like(mean)
            for d in range(k1 + 1):
                mult = 1.0 if d == 0 else 2.0
                for s1 in range(k1 + 1 - d):
                    win = self.sp[d][(c1 + s1)[:, None, None], r_t[:, :, None], r_t[:, None, :]]
                    val = torch.einsum("nt,ntu,nu->n", v_t, win, v_t)
                    quad_p = quad_p + mult * v1[:, s1 + d] * v1[:, s1] * val
            var = self.kdiag + quad_p - q_prod
        return mean, var


class GPRKron(PerDimensionGP):
    """D-dimensional ASVGP regression (D ≥ 2) with tensor-product B-spline
    inducing features.

    One Matérn kernel and one basis per input dimension; the hyperparameters
    as ``PerDimensionGP`` holds them, and the sufficient statistics float64
    buffers, all on ``device`` (default: the CUDA device, raising without
    one; pass ``device="cpu"`` for the CPU).  With a ``torch.distributed``
    ``group`` (the JAX package's ``mesh``), ``data`` is this rank's shard
    and the statistics are summed over the group's ranks.
    """

    def __init__(self, data, kernels, bases, *, noise_variance=1.0, device=None, group=None):
        super().__init__()
        with span("kron.init", device):
            with span("model.check"):
                X_in, y_in = data
                xv = X_in if isinstance(X_in, np.ndarray) else torch.as_tensor(X_in)
                if xv.ndim != 2 or xv.shape[1] < 2:
                    raise ValueError("GPRKron requires inputs of shape (n, D) with D >= 2")
                D = xv.shape[1]
                if len(kernels) != D or len(bases) != D:
                    raise ValueError("need one kernel and one basis per input dimension")
                check_domain(xv, bases)
                for k, b in zip(kernels, bases):
                    validate_kernel_basis(k, b)
                device = resolve_device(device)
                self.bases = list(bases)
                self.D = D
                self._init_parameters(kernels, noise_variance, device)
                X = to_device(X_in, _F64, device)
                yf = to_device(y_in, _F64, device).reshape(-1)
                if X.shape[0] != yf.shape[0]:
                    raise ValueError("X and y must have the same number of points")
            if group is None:
                build = compute_kron_stats if D == 2 else compute_kron_stats_nd
                stats = build(self.bases, X, yf)
            else:
                build = compute_kron_stats_sharded if D == 2 else compute_kron_stats_nd_sharded
                stats = build(self.bases, X, yf, group)
            self.register_buffer("kuf_y", stats.kuf_y)
            self.register_buffer("t_band", stats.t_band)
            self.register_buffer("yty", stats.yty)
            self.register_buffer("n", stats.n)

    @property
    def stats(self) -> KronStats:
        return KronStats(kuf_y=self.kuf_y, t_band=self.t_band, yty=self.yty, n=self.n)

    @property
    def bandwidth(self) -> int:
        """The joint scalar bandwidth of P under row-major flattening (the
        reference's equal-m special case at asvgp/gpr.py:262); informational:
        the model uses the block-banded form."""
        bw = 0
        for d in range(self.D):
            bw += self.bases[d].order * math.prod(b.m for b in self.bases[d + 1:])
        return bw

    # ---- training objective -----------------------------------------------
    def elbo(self, params=None) -> torch.Tensor:
        """The collapsed ELBO at ``params`` (default: the module's own
        parameters); differentiable on the CPU and on the GPU."""
        return kron_collapsed_elbo(self.bases, self.nu2s, self._params(params), self.stats)

    # ---- prediction -----------------------------------------------------------
    @torch.no_grad()
    def posterior(self, params=None) -> PosteriorKron:
        """Factor once, predict many: the block-banded factor of P, the
        posterior mean weights and the block Takahashi band of P⁻¹."""
        kernels, lik = self._build(params)
        sigma2 = lik.variance
        kuu_bands = [make_kuu(k, b) for k, b in zip(kernels, self.bases)]
        l_bands = [banded.cholesky_band(kb) for kb in kuu_bands]
        s_bands = [banded.takahashi_inverse_band(lb) for lb in l_bands]
        l_p, linv_p = block.cholesky_block_banded(
            _p_blocks(self.bases, kuu_bands, sigma2, self.t_band))
        w = block.cholesky_solve_block_banded(l_p, self.kuf_y, linv_p) / sigma2
        sp = block.takahashi_inverse_block_banded(l_p, linv_p)
        return PosteriorKron(kernels, lik, self.bases, w.reshape(self.bases[0].m, -1), sp,
                             s_bands)
