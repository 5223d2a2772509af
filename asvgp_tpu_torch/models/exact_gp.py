"""Exact GP regression (dense): the correctness oracle of the Snelson fit.

PyTorch counterpart of ``asvgp_tpu/models/exact_gp.py`` (the equivalent of
``gpflow.models.GPR``): the ASVGP ELBO must lower-bound and approach this
model's log marginal likelihood.  It is O(n³) dense linear algebra
(``torch.linalg``), meant for a few thousand points; it runs on the CUDA
device unless given CPU tensors or ``device="cpu"``.
"""

from __future__ import annotations

import math

import torch

from asvgp_tpu_torch.models.gpr1d import MaternGaussianModel, resolve_device

_LOG2PI = math.log(2.0 * math.pi)
_F64 = torch.float64


class ExactGPR(MaternGaussianModel):
    """Dense GP regression with a Matérn kernel and Gaussian noise.

    The data become float64 buffers on ``device``, and the hyperparameters
    live beside them.  ``device=None`` means the device of ``X`` when it is a
    tensor, else the CUDA device as for ``GPR1D`` (pass ``device="cpu"`` for
    the CPU)."""

    def __init__(self, data, kernel, *, noise_variance=1.0, device=None):
        super().__init__()
        X, y = data
        if device is None and isinstance(X, torch.Tensor):
            device = X.device
        device = resolve_device(device)
        self.register_buffer("X", torch.as_tensor(X, dtype=_F64, device=device).reshape(-1))
        self.register_buffer("y", torch.as_tensor(y, dtype=_F64, device=device).reshape(-1))
        self._init_hyperparameters(kernel, noise_variance, device)

    def _chol(self, kernel, lik):
        n = self.y.shape[0]
        eye = torch.eye(n, dtype=_F64, device=self.y.device)
        return torch.linalg.cholesky(kernel.K(self.X) + lik.variance * eye)

    def log_marginal_likelihood(self, params=None) -> torch.Tensor:
        kernel, lik = self._build(params)
        L = self._chol(kernel, lik)
        alpha = torch.linalg.solve_triangular(L, self.y[:, None], upper=False)[:, 0]
        return (
            -0.5 * torch.sum(torch.square(alpha))
            - torch.sum(torch.log(torch.diagonal(L)))
            - 0.5 * self.y.shape[0] * _LOG2PI
        )

    def maximum_log_likelihood_objective(self, params=None) -> torch.Tensor:
        return self.log_marginal_likelihood(params)

    def training_loss(self, params=None) -> torch.Tensor:
        return -self.log_marginal_likelihood(params)

    @torch.no_grad()
    def predict_f(self, Xnew, params=None):
        """Posterior mean and marginal variance at Xnew, each (n*, 1)."""
        kernel, lik = self._build(params)
        L = self._chol(kernel, lik)
        x2 = torch.as_tensor(Xnew, dtype=_F64, device=self.y.device).reshape(-1)
        A = torch.linalg.solve_triangular(L, kernel.K(self.X, x2), upper=False)
        mean = A.T @ torch.linalg.solve_triangular(L, self.y[:, None], upper=False)[:, 0]
        var = kernel.K_diag(x2) - torch.sum(torch.square(A), dim=0)
        return mean[:, None], var[:, None]

    @torch.no_grad()
    def predict_log_density(self, data, params=None):
        """The log predictive density of the points (Xnew, ynew), (n*, 1)."""
        Xnew, ynew = data
        _, lik = self._build(params)
        mean, var = self.predict_f(Xnew, params=params)
        y = torch.as_tensor(ynew, dtype=_F64, device=mean.device).reshape(mean.shape)
        return lik.predict_log_density(mean, var, y)
