"""GPRVFF — collapsed-ELBO regression with Variational Fourier Features.

PyTorch counterpart of ``asvgp_tpu/models/vff.py``, the large-regression
protocol's VFF baseline.  The same collapsed (Titsias/SGPR) bound as
GPR1D; only the feature family differs (global Fourier features,
features/fourier.py), and with it the algebra, which is dense:

  statistics  O(N m²)   (ASVGP: O(N k²))
  ELBO step   O(m³)     (ASVGP: O(m k²))

The dense float64 algebra is ``torch.linalg`` (the JAX package routes it
through its Ozaki-sliced ``dsx`` helpers on a TPU, which the card does not
need).  No hand-written kernel is involved.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from asvgp_tpu_torch.device import resolve_device
from asvgp_tpu_torch.features.fourier import FourierBasis1D, make_kuu_vff
from asvgp_tpu_torch.models.gpr1d import MaternGaussianModel
from asvgp_tpu_torch.models.kernels import Matern

_LOG2PI = math.log(2.0 * math.pi)
_F64 = torch.float64


def _vff_stats(fb: FourierBasis1D, x: torch.Tensor, y: torch.Tensor, chunk: int = 8192):
    """(Kuf·y, Kuf·Kufᵀ, yᵀy, n) accumulated over the points in chunks of
    ``chunk``, on their device: no (n, m) feature matrix is kept whole."""
    n = x.shape[0]
    kufy = torch.zeros(fb.m, dtype=x.dtype, device=x.device)
    kk = torch.zeros((fb.m, fb.m), dtype=x.dtype, device=x.device)
    for lo in range(0, n, chunk):
        phi = fb.evaluate(x[lo:lo + chunk])
        kufy = kufy + phi.T @ y[lo:lo + chunk]
        kk = kk + phi.T @ phi
    return kufy, kk, torch.sum(y * y), torch.tensor(float(n), dtype=x.dtype, device=x.device)


class GPRVFF(MaternGaussianModel):
    """1-D VFF regression with the collapsed bound (dense algebra).

    The statistics are float64 buffers on ``device`` (default: the CUDA
    device; pass ``device="cpu"`` for the CPU), computed once at
    construction; the hyperparameters are ``nn.Parameter``s beside them,
    and every objective takes a params pytree in the JAX package's layout
    (``None``: the module's own).
    """

    def __init__(self, data, kernel: Matern, basis: FourierBasis1D, *,
                 noise_variance=1.0, chunk: int = 8192, device=None):
        super().__init__()
        device = resolve_device(device)
        X, y = data
        x = torch.as_tensor(X, dtype=_F64, device=device).reshape(-1)
        yf = torch.as_tensor(y, dtype=_F64, device=device).reshape(-1)
        xv = np.asarray(X) if not isinstance(X, torch.Tensor) else x
        if not (float(xv.min()) > basis.a and float(xv.max()) < basis.b):
            raise ValueError(f"inputs must lie strictly inside [{basis.a}, {basis.b}]")
        self.basis = basis
        self._init_hyperparameters(kernel, noise_variance, device)
        kuf_y, kufkfu, yty, n = _vff_stats(basis, x, yf, chunk)
        for name, value in (("kuf_y", kuf_y), ("kufkfu", kufkfu), ("yty", yty), ("n", n)):
            self.register_buffer(name, value)

    def _build(self, params=None):
        if params is not None:
            # a pytree of numpy values or tensors: tensors as they are
            dev = self.kuf_y.device
            params = {group: {name: torch.as_tensor(v, dtype=_F64, device=dev)
                              for name, v in d.items()} for group, d in params.items()}
        return super()._build(params)

    def _factors(self, params):
        kernel, lik = self._build(params)
        sigma2 = lik.variance
        kuu = make_kuu_vff(kernel, self.basis)
        l_kuu = torch.linalg.cholesky(kuu)
        l_p = torch.linalg.cholesky(kuu + self.kufkfu / sigma2)
        return kernel, sigma2, l_kuu, l_p

    def elbo(self, params=None) -> torch.Tensor:
        kernel, sigma2, l_kuu, l_p = self._factors(params)
        log_det_kuu = 2.0 * torch.sum(torch.log(torch.diagonal(l_kuu)))
        log_det_p = 2.0 * torch.sum(torch.log(torch.diagonal(l_p)))
        c = torch.linalg.solve_triangular(l_p, self.kuf_y[:, None], upper=False)[:, 0] / sigma2
        # trace(Kuu⁻¹ KufKfu) by one dense solve
        trace_term = torch.trace(torch.cholesky_solve(self.kufkfu, l_kuu))
        kdiag_sum = self.n * kernel.variance

        elbo = -0.5 * self.n * (_LOG2PI + torch.log(sigma2))
        elbo = elbo - 0.5 * log_det_p
        elbo = elbo + 0.5 * log_det_kuu
        elbo = elbo - 0.5 * self.yty / sigma2
        elbo = elbo + 0.5 * torch.sum(torch.square(c))
        elbo = elbo - 0.5 * kdiag_sum / sigma2
        elbo = elbo + 0.5 * trace_term / sigma2
        return elbo

    def maximum_log_likelihood_objective(self, params=None) -> torch.Tensor:
        return self.elbo(params)

    def training_loss(self, params=None) -> torch.Tensor:
        return -self.elbo(params)

    @torch.no_grad()
    def predict_f(self, Xnew, full_cov: bool = False, params=None):
        """Posterior mean and marginal variance at Xnew, each (n*, 1);
        ``full_cov`` is not implemented, as in the JAX package."""
        if full_cov:
            raise NotImplementedError("full_cov prediction is not implemented")
        kernel, sigma2, l_kuu, l_p = self._factors(params)
        x = torch.as_tensor(Xnew, dtype=_F64, device=self.kuf_y.device).reshape(-1)
        phi_t = self.basis.evaluate(x).T  # (m, n*)
        c = torch.linalg.solve_triangular(l_p, self.kuf_y[:, None], upper=False)[:, 0] / sigma2
        tmp = torch.linalg.solve_triangular(l_p, phi_t, upper=False)
        mean = tmp.T @ c
        ki = torch.linalg.solve_triangular(l_kuu, phi_t, upper=False)
        var = (kernel.variance + torch.sum(torch.square(tmp), dim=0)
               - torch.sum(torch.square(ki), dim=0))
        return mean[:, None], var[:, None]

    def predict_y(self, Xnew, params=None):
        _, lik = self._build(params)
        mean, var = self.predict_f(Xnew, params=params)
        return lik.predict_mean_and_var(mean, var)

    def predict_log_density(self, data, params=None):
        Xnew, ynew = data
        _, lik = self._build(params)
        mean, var = self.predict_f(Xnew, params=params)
        y = torch.as_tensor(ynew, dtype=mean.dtype, device=mean.device).reshape(mean.shape)
        return lik.predict_log_density(mean, var, y)
