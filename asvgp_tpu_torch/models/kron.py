"""GPRKron — tensor-product B-spline features for 2-D inputs, in PyTorch.

PyTorch counterpart of ``asvgp_tpu/models/kron.py`` at D = 2.  Everything
stays factorized or banded:

  log|Kuu|   the per-dimension banded Cholesky factors (K9, backward K10)
             and the Kronecker determinant identity
  trace term the per-dimension Takahashi bands (K11, backward K12) against
             the multiband of KufKfu (stats/kron.py), elementwise
  P          block-banded (block row i₁, block bandwidth k₁): the blocked
             Cholesky of banded/block.py, whose diagonal-block step is K16
  predict    the block Takahashi band of P⁻¹ and per-point window gathers,
             O((k+1)⁴) per test point

The data enter through the sufficient statistics, computed once at
construction on the model's device (the CUDA device unless told
otherwise).  D ≥ 3 (the JAX package's stats/kron_nd.py) is not ported.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from asvgp_tpu_torch import banded
from asvgp_tpu_torch.banded import block
from asvgp_tpu_torch.features.spline_features import make_kuf, make_kuu, validate_kernel_basis
from asvgp_tpu_torch.models.gpr1d import resolve_device, window_quadratic_form
from asvgp_tpu_torch.models.kernels import Matern
from asvgp_tpu_torch.models.likelihoods import Gaussian
from asvgp_tpu_torch.models.parameters import positive, positive_inverse
from asvgp_tpu_torch.stats.kron import (
    KronStats,
    compute_kron_stats,
    t_band_to_blocks,
    t_band_trace_against_kron,
)

_LOG2PI = math.log(2.0 * math.pi)
_F64 = torch.float64


def kron_params_to_kernels(params, nu2s):
    """The per-dimension Matérn kernels of a params pytree."""
    return [
        Matern(variance=positive(p["raw_variance"]), lengthscales=positive(p["raw_lengthscales"]),
               nu2=nu2)
        for p, nu2 in zip(params["kernels"], nu2s)
    ]


def _p_blocks(bases, kuu_bands, sigma2, t_band):
    """Block-banded P = Kuu₁ ⊗ Kuu₂ + KufKfu/σ²."""
    kuu2_dense = banded.band_to_dense(
        banded.symmetrise_lower_band(kuu_bands[1]), bases[1].order, bases[1].order)
    return t_band_to_blocks(t_band, kuu_bands[0], kuu2_dense, sigma2)


def kron_collapsed_elbo(bases, nu2s, params, stats: KronStats):
    """The collapsed ELBO from the Kronecker sufficient statistics, term by
    term as the JAX package's (and the reference's) bound, with P
    block-banded."""
    kernels = kron_params_to_kernels(params, nu2s)
    sigma2 = positive(params["likelihood"]["raw_variance"])
    ms = [b.m for b in bases]

    kuu_bands = [make_kuu(k, b) for k, b in zip(kernels, bases)]
    l_bands = [banded.cholesky_band(kb) for kb in kuu_bands]
    # log|⊗_d A_d| = Σ_d (Π_{e≠d} m_e) log|A_d|
    log_det_kuu = sum(math.prod(ms) // ms[d] * banded.log_det_from_cholesky(l_bands[d])
                      for d in range(len(bases)))
    s_bands = [banded.takahashi_inverse_band(lb) for lb in l_bands]
    trace_term = t_band_trace_against_kron(stats.t_band, s_bands[0], s_bands[1])

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


class PosteriorKron:
    """Cached GPRKron posterior: the block factorization is done once at
    construction; each prediction is window gathers, O(Π_d (k_d+1)²) per
    point, on the device of the posterior arrays."""

    def __init__(self, kernels, lik, bases, w_flat, sp, s_bands):
        self.kernels = kernels
        self.likelihood = lik
        self.bases = bases
        self.w_flat = w_flat  # (m1, m2)
        self.sp = sp          # (k1+1, m1, m2, m2) block band of P⁻¹
        self.s_bands = s_bands
        self.kdiag = math.prod(k.variance for k in kernels)

    def _predict_chunk(self, x):
        b1, b2 = self.bases
        k1 = b1.order
        v1, c1 = make_kuf(b1, x[:, 0])
        v2, c2 = make_kuf(b2, x[:, 1])
        r1 = c1[:, None] + torch.arange(k1 + 1, device=c1.device)[None, :]
        r2 = c2[:, None] + torch.arange(b2.order + 1, device=c2.device)[None, :]
        # kusᵀ Kuu⁻¹ kus = Π_d (per-dimension window quadratic forms)
        q_prod = (window_quadratic_form(self.s_bands[0], v1, c1)
                  * window_quadratic_form(self.s_bands[1], v2, c2))
        # mean = Σ v1[s1] v2[t] w[c1+s1, c2+t]
        w_win = self.w_flat[r1[:, :, None], r2[:, None, :]]
        mean = torch.einsum("na,nat,nt->n", v1, w_win, v2)
        # kusᵀ P⁻¹ kus through the windows of the block Takahashi band
        quad_p = torch.zeros_like(mean)
        for d in range(k1 + 1):
            mult = 1.0 if d == 0 else 2.0
            for s1 in range(k1 + 1 - d):
                win = self.sp[d][(c1 + s1)[:, None, None], r2[:, :, None], r2[:, None, :]]
                val = torch.einsum("nt,ntu,nu->n", v2, win, v2)
                quad_p = quad_p + mult * v1[:, s1 + d] * v1[:, s1] * val
        return mean, self.kdiag + quad_p - q_prod

    def predict_f(self, Xnew, full_cov: bool = False, batch: int | None = None):
        """Posterior mean and marginal variance at Xnew (n, 2), each (n, 1).

        ``batch`` chunks the test points; the last chunk is padded to the
        batch size with the domain's centre and cut, so no point is
        dropped."""
        if full_cov:
            raise NotImplementedError("full_cov prediction is not implemented")
        x = torch.as_tensor(Xnew, dtype=_F64, device=self.w_flat.device).reshape(-1, 2)
        n = x.shape[0]
        if not batch or n <= batch:
            mean, var = self._predict_chunk(x)
            return mean[:, None], var[:, None]
        n_pad = (-n) % batch
        centre = x.new_tensor([0.5 * (b.a + b.b) for b in self.bases])
        xp = torch.cat([x, centre.expand(n_pad, 2)])
        means, vars_ = [], []
        for lo in range(0, n + n_pad, batch):
            mc, vc = self._predict_chunk(xp[lo:lo + batch])
            means.append(mc)
            vars_.append(vc)
        return torch.cat(means)[:n, None], torch.cat(vars_)[:n, None]

    def predict_y(self, Xnew, batch: int | None = None):
        mean, var = self.predict_f(Xnew, batch=batch)
        return self.likelihood.predict_mean_and_var(mean, var)

    def predict_log_density(self, data, batch: int | None = None):
        Xnew, ynew = data
        mean, var = self.predict_f(Xnew, batch=batch)
        y = torch.as_tensor(ynew, dtype=_F64, device=mean.device).reshape(mean.shape)
        return self.likelihood.predict_log_density(mean, var, y)


class GPRKron(nn.Module):
    """2-D ASVGP regression with tensor-product B-spline inducing features.

    One Matérn kernel and one basis per input dimension.  The unconstrained
    hyperparameters are float64 ``nn.Parameter``s (``raw_variances``,
    ``raw_lengthscales``: one per dimension; ``raw_noise_variance``) and the
    sufficient statistics float64 buffers, all on ``device`` (default: the
    CUDA device, raising without one; pass ``device="cpu"`` for the CPU).

    A params pytree in the JAX package's layout, ``{"kernels":
    [{"raw_lengthscales", "raw_variance"}, ...], "likelihood":
    {"raw_variance"}}``, can stand in for them: ``params()`` returns one,
    ``load_jax_params`` sets them from one, and the objectives and
    predictions take one (``None``: the module's own parameters).
    """

    def __init__(self, data, kernels, bases, *, noise_variance=1.0, device=None):
        super().__init__()
        X_in, y_in = data
        xv = X_in if isinstance(X_in, np.ndarray) else torch.as_tensor(X_in)
        if xv.ndim != 2 or xv.shape[1] < 2:
            raise ValueError("GPRKron requires inputs of shape (n, D) with D >= 2")
        D = xv.shape[1]
        if len(kernels) != D or len(bases) != D:
            raise ValueError("need one kernel and one basis per input dimension")
        # domain check on the host when the caller passed host data
        for d, basis in enumerate(bases):
            lo, hi = float(xv[:, d].min()), float(xv[:, d].max())
            if not (lo > basis.a and hi < basis.b):
                raise ValueError(f"dim {d}: inputs must lie strictly inside "
                                 f"[{basis.a}, {basis.b}], got [{lo}, {hi}]")
        for k, b in zip(kernels, bases):
            validate_kernel_basis(k, b)
        if D != 2:
            raise NotImplementedError(
                f"GPRKron at D = {D}: only D = 2 is ported; the D >= 3 statistics "
                "(stats/kron_nd.py) are open in ROADMAP.md, queue 1 item 12")
        device = resolve_device(device)
        self.bases = list(bases)
        self.nu2s = [k.nu2 for k in kernels]
        self.kernels_init = list(kernels)
        self.noise_variance_init = noise_variance
        self.D = D

        init = self.init_params()

        def param(value):
            return nn.Parameter(torch.as_tensor(value, dtype=_F64, device=device))

        self.raw_variances = nn.ParameterList(
            [param(p["raw_variance"]) for p in init["kernels"]])
        self.raw_lengthscales = nn.ParameterList(
            [param(p["raw_lengthscales"]) for p in init["kernels"]])
        self.raw_noise_variance = param(init["likelihood"]["raw_variance"])

        X = torch.as_tensor(X_in, dtype=_F64, device=device)
        yf = torch.as_tensor(y_in, dtype=_F64, device=device).reshape(-1)
        if X.shape[0] != yf.shape[0]:
            raise ValueError("X and y must have the same number of points")
        stats = compute_kron_stats(self.bases, X, yf)
        self.register_buffer("kuf_y", stats.kuf_y)
        self.register_buffer("t_band", stats.t_band)
        self.register_buffer("yty", stats.yty)
        self.register_buffer("n", stats.n)

    @property
    def stats(self) -> KronStats:
        return KronStats(kuf_y=self.kuf_y, t_band=self.t_band, yty=self.yty, n=self.n)

    # ---- parameters ---------------------------------------------------------
    def init_params(self) -> dict:
        """The initial parameters in the JAX package's layout (numpy)."""

        def inv(value):
            return positive_inverse(torch.as_tensor(value, dtype=_F64).detach().cpu()).numpy()

        return {
            "kernels": [{"raw_variance": inv(k.variance), "raw_lengthscales": inv(k.lengthscales)}
                        for k in self.kernels_init],
            "likelihood": {"raw_variance": inv(self.noise_variance_init)},
        }

    def params(self) -> dict:
        """The current parameters in the JAX package's layout: detached
        float64 copies on the model's device (``fit_lbfgs`` starts there)."""
        own = self._params(None)
        return {
            "kernels": [{name: v.detach().clone() for name, v in p.items()}
                        for p in own["kernels"]],
            "likelihood": {"raw_variance": own["likelihood"]["raw_variance"].detach().clone()},
        }

    def _params(self, params):
        """``params``, or the module's own parameters for ``None``, in the
        JAX package's layout (differentiable into the module)."""
        if params is not None:
            return params
        return {
            "kernels": [{"raw_lengthscales": ell, "raw_variance": var}
                        for var, ell in zip(self.raw_variances, self.raw_lengthscales)],
            "likelihood": {"raw_variance": self.raw_noise_variance},
        }

    def load_jax_params(self, params) -> None:
        """Set the parameters from a params pytree in the JAX package's
        layout, of tensors (any device) or numpy arrays."""
        if len(params["kernels"]) != self.D:
            raise ValueError(f"need {self.D} kernels' parameters, got {len(params['kernels'])}")
        pairs = [(self.raw_noise_variance, params["likelihood"]["raw_variance"])]
        for d, p in enumerate(params["kernels"]):
            pairs += [(self.raw_variances[d], p["raw_variance"]),
                      (self.raw_lengthscales[d], p["raw_lengthscales"])]
        with torch.no_grad():
            for target, value in pairs:
                v = (value.detach() if isinstance(value, torch.Tensor)
                     else torch.as_tensor(np.array(value, dtype=np.float64)))
                if v.numel() != target.numel():
                    raise ValueError(f"parameter of {target.numel()} values given {v.numel()}")
                target.copy_(v.reshape(target.shape))

    def _build(self, params=None):
        p = self._params(params)
        return (kron_params_to_kernels(p, self.nu2s),
                Gaussian(positive(p["likelihood"]["raw_variance"])))

    # ---- training objective -----------------------------------------------
    def elbo(self, params=None) -> torch.Tensor:
        """The collapsed ELBO at ``params`` (default: the module's own
        parameters); differentiable on the CPU and on the GPU."""
        return kron_collapsed_elbo(self.bases, self.nu2s, self._params(params), self.stats)

    def training_loss(self, params=None) -> torch.Tensor:
        return -self.elbo(params)

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

    def predict_f(self, Xnew, full_cov: bool = False, batch: int | None = None, params=None):
        """Posterior mean and marginal variance at Xnew; ``full_cov`` is not
        implemented, matching the reference; ``batch`` chunks the points."""
        if full_cov:
            raise NotImplementedError("full_cov prediction is not implemented")
        return self.posterior(params).predict_f(Xnew, batch=batch)

    def predict_y(self, Xnew, batch: int | None = None, params=None):
        return self.posterior(params).predict_y(Xnew, batch=batch)

    def predict_log_density(self, data, batch: int | None = None, params=None):
        return self.posterior(params).predict_log_density(data, batch=batch)
