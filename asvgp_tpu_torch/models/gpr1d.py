"""GPR1D — the flagship 1-D banded ASVGP regression model, in PyTorch.

PyTorch counterpart of ``asvgp_tpu/models/gpr1d.py`` (its value and
prediction paths).  The collapsed (Titsias/SGPR) ELBO is computed in banded
arithmetic, O(m·k²) per evaluation independent of N; the data enter only
through the sufficient statistics computed once at construction, on the
model's device.

Prediction uses the locality of Kus: each test point touches only a
(k+1)-window of the bands of P⁻¹ and Kuu⁻¹ (both exact via the Takahashi
recursion), so

  mean_i = kus_iᵀ (P⁻¹ Kuf y)/σ²              — one banded solve, O(m k)
  var_i  = σ_f² + kus_iᵀ (P⁻¹ − Kuu⁻¹) kus_i   — banded gathers, O(k²) per pt

On a CUDA device the banded work runs in hand-written sweeps: the ELBO's
gradient in the tangent-fused sweeps of banded/tan.py and banded/twist.py
(``banded.collapsed_core_matern``, with an elementwise backward), its value
alone and the posterior in the two sweeps of banded/core.py.

``GPR1D(..., dtype=torch.float32)`` is the JAX package's float32 model as
it runs with x64 off (its float32 Pallas route, ``ops._use_pallas``): the
statistics are accumulated in float64 and cast once, and the parameters,
Kuu, P, the loss, its gradient, the posterior and the predictions are all
float32.  Its banded work goes through the composed single-matrix ops and
their float32 kernels (K17–K22): two Choleskys, the Takahashi band of
Kuu⁻¹ and the lower solve for the loss, their adjoints for the gradient.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from asvgp_tpu_torch import banded
from asvgp_tpu_torch.basis.splines import BSplineBasis
from asvgp_tpu_torch.features.spline_features import (
    make_kuf,
    make_kuu,
    validate_kernel_basis,
)
from asvgp_tpu_torch.models.kernels import Matern
from asvgp_tpu_torch.models.likelihoods import Gaussian
from asvgp_tpu_torch.models.parameters import positive, positive_inverse
from asvgp_tpu_torch.stats.sufficient import (
    SufficientStats,
    compute_stats,
    compute_stats_sharded,
)

_LOG2PI = math.log(2.0 * math.pi)
_F64 = torch.float64


def default_params(kernel: Matern, noise_variance=1.0) -> dict:
    """Unconstrained initial parameters in the JAX package's layout, as
    numpy float64 (the softplus inverse of the constrained values)."""

    def inv(value):
        return positive_inverse(torch.as_tensor(value, dtype=_F64).detach().cpu()).numpy()

    return {
        "kernel": {
            "raw_variance": inv(kernel.variance),
            "raw_lengthscales": inv(kernel.lengthscales),
        },
        "likelihood": {"raw_variance": inv(noise_variance)},
    }


def collapsed_elbo_banded(stats: SufficientStats, kuu_band, sigma2, kdiag_sum):
    """The collapsed ELBO from banded Kuu and the sufficient statistics,
    term by term as the reference's collapsed bound."""
    p_band = stats.kufkfu_band / sigma2 + kuu_band
    log_det_kuu, log_det_p, quad, trace_term = banded.collapsed_core(
        kuu_band, p_band, stats.kuf_y, stats.kufkfu_band
    )
    elbo = -0.5 * stats.n * (_LOG2PI + torch.log(sigma2))
    elbo = elbo - 0.5 * log_det_p
    elbo = elbo + 0.5 * log_det_kuu
    elbo = elbo - 0.5 * stats.yty / sigma2
    elbo = elbo + 0.5 * quad / (sigma2 * sigma2)
    elbo = elbo - 0.5 * kdiag_sum / sigma2
    elbo = elbo + 0.5 * trace_term / sigma2
    return elbo


def collapsed_elbo_matern(stats: SufficientStats, basis, nu2, var, ell,
                          sigma2, kdiag_sum):
    """As ``collapsed_elbo_banded`` but with the Matérn θ-structure exposed
    to the banded core: its gradient runs the lengthscale direction as a
    forward tangent inside the sweeps, and the whole backward is
    elementwise (``banded.collapsed_core_matern``)."""

    def kuu_fn(v, l):
        return make_kuu(Matern(v, l, nu2=nu2), basis)

    p_band = stats.kufkfu_band / sigma2 + kuu_fn(var, ell)
    log_det_kuu, log_det_p, quad, trace_term = banded.collapsed_core_matern(
        kuu_fn, var, ell, p_band, stats.kuf_y, stats.kufkfu_band
    )
    elbo = -0.5 * stats.n * (_LOG2PI + torch.log(sigma2))
    elbo = elbo - 0.5 * log_det_p
    elbo = elbo + 0.5 * log_det_kuu
    elbo = elbo - 0.5 * stats.yty / sigma2
    elbo = elbo + 0.5 * quad / (sigma2 * sigma2)
    elbo = elbo - 0.5 * kdiag_sum / sigma2
    elbo = elbo + 0.5 * trace_term / sigma2
    return elbo


def window_quadratic_form(band, vals, start):
    """q_i = kus_iᵀ M kus_i where M is symmetric with lower band ``band`` and
    kus_i is supported on rows start_i .. start_i + k.

    q_i = Σ_s v_s² M[0, start+s] + 2 Σ_{j>=1} Σ_s v_s v_{s+j} M[j, start+s].
    ``start`` must keep start + k < m (``evaluate_basis`` clips it so).
    """
    kp1 = vals.shape[1]
    s_idx = start[:, None] + torch.arange(kp1, dtype=start.dtype, device=start.device)[None, :]
    q = torch.sum(torch.square(vals) * band[0][s_idx], dim=1)
    for j in range(1, kp1):
        w = vals[:, : kp1 - j] * vals[:, j:]
        q = q + 2.0 * torch.sum(w * band[j][s_idx[:, : kp1 - j]], dim=1)
    return q


def window_dot(vec, vals, start):
    """d_i = kus_iᵀ vec (windowed sparse dot)."""
    kp1 = vals.shape[1]
    idx = start[:, None] + torch.arange(kp1, dtype=start.dtype, device=start.device)[None, :]
    return torch.sum(vals * vec[idx], dim=1)


class Posterior1D:
    """Cached GPR1D posterior: the banded factorizations are done once at
    construction; every ``predict_f`` afterwards is windowed gathers,
    O(k²) per test point, on the device and in the dtype of ``w``."""

    def __init__(self, kernel, lik, basis, w, diff_band):
        self.kernel = kernel
        self.likelihood = lik
        self.basis = basis
        self.w = w
        self.diff_band = diff_band

    def _predict_chunk(self, x):
        vals, start = make_kuf(self.basis, x)
        mean = window_dot(self.w, vals, start)
        var = self.kernel.variance + window_quadratic_form(self.diff_band, vals, start)
        return mean, var

    def predict_f(self, Xnew, full_cov: bool = False, batch: int | None = None):
        """Posterior mean and marginal variance at Xnew, each (n, 1).

        ``batch`` chunks the test points; the last chunk is padded to the
        batch size with the domain's midpoint and cut, so no point is
        dropped."""
        if full_cov:
            raise NotImplementedError("full_cov prediction is not implemented")
        x = torch.as_tensor(Xnew, dtype=self.w.dtype, device=self.w.device).reshape(-1)
        n = x.shape[0]
        if not batch or n <= batch:
            mean, var = self._predict_chunk(x)
            return mean[:, None], var[:, None]
        n_pad = (-n) % batch
        xp = torch.cat([x, x.new_full((n_pad,), 0.5 * (self.basis.a + self.basis.b))])
        means, vars_ = [], []
        for lo in range(0, n + n_pad, batch):
            mc, vc = self._predict_chunk(xp[lo:lo + batch])
            means.append(mc)
            vars_.append(vc)
        return torch.cat(means)[:n, None], torch.cat(vars_)[:n, None]

    def predict_y(self, Xnew):
        mean, var = self.predict_f(Xnew)
        return self.likelihood.predict_mean_and_var(mean, var)

    def predict_log_density(self, data):
        Xnew, ynew = data
        mean, var = self.predict_f(Xnew)
        y = torch.as_tensor(ynew, dtype=mean.dtype, device=mean.device).reshape(mean.shape)
        return self.likelihood.predict_log_density(mean, var, y)


def resolve_device(device) -> torch.device:
    """A model's device: ``None`` means the current CUDA device, and raises
    when there is none (no silent fall back to the CPU)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "models run on the CUDA device unless told otherwise, and there "
                'is none: pass device="cpu" to run on the CPU'
            )
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


class MaternGaussianModel(nn.Module):
    """The hyperparameters of a Matérn kernel with a Gaussian likelihood, as
    unconstrained ``nn.Parameter``s (``raw_variance``, ``raw_lengthscales``,
    ``raw_noise_variance``) in the model's dtype (float64 unless a model
    says otherwise).

    A params pytree in the JAX package's layout, ``{"kernel":
    {"raw_lengthscales", "raw_variance"}, "likelihood": {"raw_variance"}}``,
    can stand in for them: ``params()`` returns one, ``load_jax_params`` sets
    them from one, and the objectives take one (``None``: the module's own
    parameters).
    """

    def _init_hyperparameters(self, kernel: Matern, noise_variance, device,
                              dtype=_F64) -> None:
        self.nu2 = kernel.nu2
        self.kernel_init = kernel
        self.noise_variance_init = noise_variance
        self.dtype = dtype
        params = default_params(kernel, noise_variance)

        def param(value):
            return nn.Parameter(torch.as_tensor(value, device=device).to(dtype))

        self.raw_variance = param(params["kernel"]["raw_variance"])
        self.raw_lengthscales = param(params["kernel"]["raw_lengthscales"])
        self.raw_noise_variance = param(params["likelihood"]["raw_variance"])

    def init_params(self) -> dict:
        """The initial parameters in the JAX package's layout (numpy, in the
        model's dtype: computed in float64 and cast once, as the JAX
        package's ``init_params`` does)."""
        params = default_params(self.kernel_init, self.noise_variance_init)
        if self.dtype == _F64:
            return params
        return {g: {k: v.astype(np.float32) for k, v in d.items()} for g, d in params.items()}

    def params(self) -> dict:
        """The current parameters in the JAX package's layout: detached
        copies on the model's device, in its dtype (``fit_lbfgs`` starts
        there)."""
        return {
            "kernel": {
                "raw_lengthscales": self.raw_lengthscales.detach().clone(),
                "raw_variance": self.raw_variance.detach().clone(),
            },
            "likelihood": {"raw_variance": self.raw_noise_variance.detach().clone()},
        }

    def load_jax_params(self, params) -> None:
        """Set the parameters from a params pytree in the JAX package's
        layout, of tensors (any device) or numpy arrays, cast to the model's
        dtype."""
        with torch.no_grad():
            for p, value in zip(self._tensors(None), self._tensors(params)):
                if isinstance(value, torch.Tensor):
                    v = value.detach()
                else:
                    v = torch.as_tensor(np.array(value)).to(p.dtype)
                if v.numel() != p.numel():
                    raise ValueError(f"parameter of {p.numel()} values given {v.numel()}")
                p.copy_(v.reshape(p.shape))

    def _raw(self, params):
        """(raw_variance, raw_lengthscales, raw_noise_variance) of
        ``params``, or the module's own parameters for ``None``."""
        if params is None:
            return self.raw_variance, self.raw_lengthscales, self.raw_noise_variance
        return (params["kernel"]["raw_variance"], params["kernel"]["raw_lengthscales"],
                params["likelihood"]["raw_variance"])

    def _tensors(self, params):
        """Every parameter of ``params`` (None: the module's own), in the
        order ``load_jax_params`` pairs them."""
        return self._raw(params)

    def _build(self, params=None):
        raw_var, raw_ell, raw_noise = self._raw(params)
        if self.dtype != _F64 and any(getattr(t, "dtype", None) != self.dtype
                                      for t in (raw_var, raw_ell, raw_noise)):
            # the trainers carry the dtype of the parameters they are given
            # (init_params() of a float32 model is float32); a float32 model
            # takes only its own dtype, so no float64 parameter promotes it
            # to float64 on the way
            raise TypeError(f"a {self.dtype} model takes parameters of its own dtype")
        kernel = Matern(positive(raw_var), positive(raw_ell), nu2=self.nu2)
        return kernel, Gaussian(positive(raw_noise))


class GPR1D(MaternGaussianModel):
    """1-D ASVGP regression with B-spline inducing features.

    The unconstrained hyperparameters are ``nn.Parameter``s and the
    sufficient statistics buffers, all on ``device`` (default: the CUDA
    device; pass ``device="cpu"`` for the CPU) and in ``dtype`` (``None``:
    float64; ``torch.float32``: the float32 model, see the module's
    docstring).  Construction computes the statistics there once, in
    float64, and casts them to ``dtype``.

    ``group`` (a ``torch.distributed`` process group; the JAX package's
    ``mesh``): ``data`` is this rank's shard (``parallel.shard_data``), and
    the statistics are the sum over the group's ranks
    (``compute_stats_sharded``); everything after them is as without it.
    """

    def __init__(self, data, kernel: Matern, basis: BSplineBasis, *,
                 noise_variance=1.0, device=None, dtype=None, group=None):
        super().__init__()
        device = resolve_device(device)
        X_in, y_in = data
        X = torch.as_tensor(X_in, dtype=_F64, device=device)
        y = torch.as_tensor(y_in, dtype=_F64, device=device)
        if X.ndim == 2:
            if X.shape[1] != 1:
                raise ValueError("GPR1D requires 1-D inputs of shape (n,) or (n, 1)")
            X = X[:, 0]
        yf = y.reshape(-1)
        if X.shape[0] != yf.shape[0]:
            raise ValueError("X and y must have the same number of points")
        # domain check (the reference asserts a < X < b) — on the host
        # when the caller passed host data
        xv = X_in if isinstance(X_in, np.ndarray) else X
        xmin, xmax = float(xv.min()), float(xv.max())
        if not (xmin > basis.a and xmax < basis.b):
            raise ValueError(
                f"all inputs must lie strictly inside [{basis.a}, {basis.b}], "
                f"got range [{xmin}, {xmax}]"
            )
        validate_kernel_basis(kernel, basis)
        if dtype not in (None, _F64, torch.float32):
            raise ValueError(f"dtype must be None, torch.float64 or torch.float32, got {dtype}")
        self.basis = basis
        self._init_hyperparameters(kernel, noise_variance, device, dtype or _F64)

        stats = (compute_stats(basis, X, yf) if group is None
                 else compute_stats_sharded(basis, X, yf, group))
        for name in ("kuf_y", "kufkfu_band", "yty", "n"):
            self.register_buffer(name, getattr(stats, name).to(self.dtype))

    @property
    def stats(self) -> SufficientStats:
        return SufficientStats(
            kuf_y=self.kuf_y, kufkfu_band=self.kufkfu_band, yty=self.yty, n=self.n
        )

    # ---- training objective ------------------------------------------------
    def elbo(self, params=None) -> torch.Tensor:
        """The collapsed ELBO at ``params`` (default: the module's own
        parameters); differentiable on the CPU and on the GPU."""
        kernel, lik = self._build(params)
        kdiag_sum = self.n * kernel.variance  # Σ K_diag for Matérn
        return collapsed_elbo_matern(
            self.stats, self.basis, self.nu2,
            kernel.variance, kernel.lengthscales, lik.variance, kdiag_sum,
        )

    def maximum_log_likelihood_objective(self, params=None) -> torch.Tensor:
        return self.elbo(params)

    def training_loss(self, params=None) -> torch.Tensor:
        return -self.elbo(params)

    # ---- prediction ---------------------------------------------------------
    @torch.no_grad()
    def posterior(self) -> Posterior1D:
        """Factor once, predict many: returns a cached posterior object."""
        kernel, lik = self._build()
        kuu = make_kuu(kernel, self.basis)
        sigma2 = lik.variance
        p_band = self.kufkfu_band / sigma2 + kuu
        s_kuu, s_p, u = banded.banded_posterior(kuu, p_band, self.kuf_y)
        return Posterior1D(kernel, lik, self.basis, u / sigma2, s_p - s_kuu)

    def predict_f(self, Xnew, full_cov: bool = False, batch: int | None = None):
        """Posterior mean and marginal variance at Xnew.  ``full_cov`` is not
        implemented, matching the reference; ``batch`` chunks the test
        points and keeps the remainder chunk."""
        if full_cov:
            raise NotImplementedError("full_cov prediction is not implemented")
        return self.posterior().predict_f(Xnew, full_cov=full_cov, batch=batch)

    def predict_y(self, Xnew):
        return self.posterior().predict_y(Xnew)

    def predict_log_density(self, data):
        return self.posterior().predict_log_density(data)
