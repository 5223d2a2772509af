"""GPRAdditive — a sum of 1-D Matérn GPs over D input dimensions, in PyTorch.

PyTorch counterpart of ``asvgp_tpu/models/additive.py``.  The per-dimension
Kuu blocks stay banded; only the coupling matrix P is dense:

  log|Kuu|   the per-dimension banded Cholesky factors (K9, backward K10)
  trace term the per-dimension Takahashi bands (K11, backward K12) against
             the banded diagonal blocks of the dense KufKfu (stats/additive.py)
  P          dense M×M, M = Σ m_d.  For M > 128 it is factored as a
             block-banded matrix of full block bandwidth in 128-wide
             blocks (banded/block.py), whose diagonal-block step is K16;
             for M ≤ 128 by ``torch.linalg.cholesky``, which the JAX
             package also computes outside any Pallas kernel
  predict    (k+1)-windows of the dense P⁻¹ for each pair of dimensions and
             of each dimension's Takahashi band of Kuu_d⁻¹, O(D² k²) per
             test point

The route for P depends on M alone, so the CPU runs the code the card runs
(K16's plain version in place of K16).  The reference's constructor passes
its loop-leaked ``kernel`` to ``super().__init__``; here, as in the JAX
package, every kernel is carried explicitly.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from asvgp_tpu_torch import banded
from asvgp_tpu_torch.banded import block
from asvgp_tpu_torch.features.spline_features import make_kuf, make_kuu, validate_kernel_basis
from asvgp_tpu_torch.models.gpr1d import resolve_device, window_quadratic_form
from asvgp_tpu_torch.models.parameters import positive
from asvgp_tpu_torch.models.per_dimension import (
    PerDimensionGP,
    PerDimensionPosterior,
    check_domain,
    params_to_kernels,
)
from asvgp_tpu_torch.stats.additive import (
    AdditiveStats,
    compute_additive_stats,
    compute_additive_stats_sharded,
)

_LOG2PI = math.log(2.0 * math.pi)
_F64 = torch.float64

# block width of the block route for P, the JAX package's panel width
_BLOCK_B = 128


def _use_block_route(P: torch.Tensor) -> bool:
    """Factor P through the full-bandwidth block route (K16 on its diagonal
    blocks) when it is wider than one block, on every device."""
    return P.shape[0] > _BLOCK_B


def _to_blocks(P: torch.Tensor, rhs: torch.Tensor):
    """Pad the SPD (M, M) matrix to a multiple of _BLOCK_B (identity on the
    padded diagonal: unit pivots add 0 to log|P|; the padded rhs rows are
    zero, so are the padded solution entries) and take its full-bandwidth
    block-lower storage.  Out of place, so that it differentiates."""
    M = P.shape[0]
    n_pad = (-M) % _BLOCK_B
    if n_pad:
        tail = torch.cat([P.new_zeros(M), P.new_ones(n_pad)])
        P = F.pad(P, (0, n_pad, 0, n_pad)) + torch.diag(tail)
        rhs = F.pad(rhs, (0, n_pad))
    nb = P.shape[0] // _BLOCK_B
    return block.dense_to_block_band(P, nb - 1, _BLOCK_B), rhs, M


def _logdet_halfsolve_block(P: torch.Tensor, rhs: torch.Tensor):
    """(log|P|, L⁻¹ rhs) of the dense coupling by the block route,
    differentiable (banded/block.py's autograd Functions)."""
    blocks, rhs_p, M = _to_blocks(P, rhs)
    l_p, linv = block.cholesky_block_banded(blocks)
    log_det = block.log_det_from_block_cholesky(l_p)
    c = block.solve_lower_block_banded(l_p, rhs_p, linv)
    return log_det, c[:M]


def _solve_and_inverse_block(P: torch.Tensor, rhs: torch.Tensor):
    """(P⁻¹ rhs, dense P⁻¹) by the block Cholesky, the solves and the block
    Takahashi recursion (at full bandwidth its band is all of P⁻¹)."""
    blocks, rhs_p, M = _to_blocks(P, rhs)
    l_p, linv = block.cholesky_block_banded(blocks)
    w = block.cholesky_solve_block_banded(l_p, rhs_p, linv)
    pinv = block.block_band_to_dense(block.takahashi_inverse_block_banded(l_p, linv))
    return w[:M], pinv[:M, :M]


def _dense_p(bases, stats: AdditiveStats, kuu_bands, sigma2) -> torch.Tensor:
    """P = KufKfu/σ² + blockdiag(Kuu_1, ..., Kuu_D), dense."""
    kuu_dense = [banded.band_to_dense(banded.symmetrise_lower_band(kb), b.order, b.order)
                 for kb, b in zip(kuu_bands, bases)]
    return stats.kufkfu / sigma2 + torch.block_diag(*kuu_dense)


def additive_collapsed_elbo(bases, nu2s, params, stats: AdditiveStats) -> torch.Tensor:
    """The collapsed ELBO of the additive model from its sufficient
    statistics, term by term as the JAX package's bound: per-dimension
    banded log-determinants and trace terms, dense only for P."""
    kernels = params_to_kernels(params, nu2s)
    sigma2 = positive(params["likelihood"]["raw_variance"])
    kuu_bands = [make_kuu(k, b) for k, b in zip(kernels, bases)]
    l_bands = [banded.cholesky_band(kb) for kb in kuu_bands]
    log_det_kuu = sum(banded.log_det_from_cholesky(lb) for lb in l_bands)

    # trace(Kuu⁻¹ KufKfu): Kuu is block-diagonal, so only the banded
    # diagonal blocks of KufKfu enter, against the Takahashi bands
    trace_term = 0.0
    o = 0
    for b, lb in zip(bases, l_bands):
        blk_band = banded.dense_to_lower_band(stats.kufkfu[o:o + b.m, o:o + b.m], b.order)
        trace_term = trace_term + banded.band_frobenius(banded.takahashi_inverse_band(lb),
                                                        blk_band)
        o += b.m

    P = _dense_p(bases, stats, kuu_bands, sigma2)
    if _use_block_route(P):
        log_det_p, c = _logdet_halfsolve_block(P, stats.kuf_y)
    else:
        L = torch.linalg.cholesky(P)
        log_det_p = 2.0 * torch.sum(torch.log(torch.diagonal(L)))
        c = torch.linalg.solve_triangular(L, stats.kuf_y[:, None], upper=False)[:, 0]
    c = c / sigma2
    total_variance = sum(k.variance for k in kernels)

    elbo = -0.5 * stats.n * (_LOG2PI + torch.log(sigma2))
    elbo = elbo - 0.5 * log_det_p
    elbo = elbo + 0.5 * log_det_kuu
    elbo = elbo - 0.5 * stats.yty / sigma2
    elbo = elbo + 0.5 * torch.sum(torch.square(c))
    elbo = elbo - 0.5 * stats.n * total_variance / sigma2
    elbo = elbo + 0.5 * trace_term / sigma2
    return elbo


class PosteriorAdditive(PerDimensionPosterior):
    """Cached GPRAdditive posterior: P is factored and inverted once at
    construction; each prediction gathers windows of w, of the dense P⁻¹
    and of the per-dimension Takahashi bands, on the device of ``w``."""

    def __init__(self, kernels, lik, bases, w, pinv, s_bands):
        super().__init__(kernels, lik, bases, w.device)
        self.w = w          # (M,) posterior mean weights
        self.pinv = pinv    # (M, M) dense P⁻¹
        self.s_bands = s_bands
        self.offsets = np.cumsum([0] + [b.m for b in bases[:-1]]).tolist()
        self.kdiag = sum(k.variance for k in kernels)

    def _predict_chunk(self, x):
        evals = [make_kuf(b, x[:, d]) for d, b in enumerate(self.bases)]
        mean = x.new_zeros(x.shape[0])
        quad_kuu = torch.zeros_like(mean)
        idxs = []
        for d, (v, c) in enumerate(evals):
            idx = self.offsets[d] + c[:, None] + torch.arange(v.shape[1], device=c.device)
            idxs.append(idx)
            mean = mean + torch.sum(v * self.w[idx], dim=1)
            quad_kuu = quad_kuu + window_quadratic_form(self.s_bands[d], v, c)
        quad_p = torch.zeros_like(mean)
        for (vd, _), idx_d in zip(evals, idxs):
            for (ve, _), idx_e in zip(evals, idxs):
                win = self.pinv[idx_d[:, :, None], idx_e[:, None, :]]
                quad_p = quad_p + torch.einsum("na,nab,nb->n", vd, win, ve)
        return mean, self.kdiag + quad_p - quad_kuu


class GPRAdditive(PerDimensionGP):
    """Additive ASVGP regression: f = Σ_d f_d(x_d), one Matérn kernel and
    one B-spline basis per input dimension.

    The hyperparameters as ``PerDimensionGP`` holds them, and the
    sufficient statistics (``kuf_y`` (M,), the dense ``kufkfu`` (M, M),
    ``yty``, ``n``) float64 buffers, all on ``device`` (default: the CUDA
    device, raising without one; pass ``device="cpu"`` for the CPU).  With a
    ``torch.distributed`` ``group`` (the JAX package's ``mesh``), ``data``
    is this rank's shard and the statistics are summed over the group's
    ranks.
    """

    def __init__(self, data, kernels, bases, *, noise_variance=1.0, device=None, group=None):
        super().__init__()
        X_in, y_in = data
        xv = X_in if isinstance(X_in, np.ndarray) else torch.as_tensor(X_in)
        if xv.ndim != 2 or xv.shape[1] != len(bases) or len(kernels) != len(bases):
            raise ValueError("need X of shape (n, D) with one kernel and one basis per dim")
        check_domain(xv, bases)
        for k, b in zip(kernels, bases):
            validate_kernel_basis(k, b)
        device = resolve_device(device)
        self.bases = list(bases)
        self.D = len(bases)
        self._init_parameters(kernels, noise_variance, device)

        X = torch.as_tensor(X_in, dtype=_F64, device=device)
        yf = torch.as_tensor(y_in, dtype=_F64, device=device).reshape(-1)
        if X.shape[0] != yf.shape[0]:
            raise ValueError("X and y must have the same number of points")
        stats = (compute_additive_stats(self.bases, X, yf) if group is None
                 else compute_additive_stats_sharded(self.bases, X, yf, group))
        for name in ("kuf_y", "kufkfu", "yty", "n"):
            self.register_buffer(name, getattr(stats, name))

    @property
    def stats(self) -> AdditiveStats:
        return AdditiveStats(kuf_y=self.kuf_y, kufkfu=self.kufkfu, yty=self.yty, n=self.n)

    # ---- training objective -----------------------------------------------
    def elbo(self, params=None) -> torch.Tensor:
        """The collapsed ELBO at ``params`` (default: the module's own
        parameters); differentiable on the CPU and on the GPU."""
        return additive_collapsed_elbo(self.bases, self.nu2s, self._params(params), self.stats)

    # ---- prediction -----------------------------------------------------------
    @torch.no_grad()
    def posterior(self, params=None) -> PosteriorAdditive:
        """Factor once, predict many: the posterior mean weights, the dense
        P⁻¹ and the per-dimension Takahashi bands of Kuu_d⁻¹."""
        kernels, lik = self._build(params)
        sigma2 = lik.variance
        kuu_bands = [make_kuu(k, b) for k, b in zip(kernels, self.bases)]
        s_bands = [banded.takahashi_inverse_band(banded.cholesky_band(kb)) for kb in kuu_bands]
        P = _dense_p(self.bases, self.stats, kuu_bands, sigma2)
        if _use_block_route(P):
            w, pinv = _solve_and_inverse_block(P, self.kuf_y)
        else:
            L = torch.linalg.cholesky(P)
            w = torch.cholesky_solve(self.kuf_y[:, None], L)[:, 0]
            pinv = torch.cholesky_inverse(L)
        return PosteriorAdditive(kernels, lik, self.bases, w / sigma2, pinv, s_bands)
