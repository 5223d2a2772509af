"""Matérn kernels (1/2, 3/2, 5/2).

PyTorch counterpart of ``asvgp_tpu/models/kernels.py``: ``variance`` and
``lengthscales`` as floating tensors (numbers become float64; a float32
model's parameters stay float32), ``K``/``K_diag`` for the dense oracles
(the exact GP), and the ``name`` tag that selects the RKHS-norm formula in
features/spline_features.py.
"""

from __future__ import annotations

import math

import torch

_SQRT3 = math.sqrt(3.0)
_SQRT5 = math.sqrt(5.0)


def as_float(value) -> torch.Tensor:
    """A floating tensor as it is; anything else as a float64 tensor."""
    if isinstance(value, torch.Tensor) and value.is_floating_point():
        return value
    return torch.as_tensor(value, dtype=torch.float64)


class Matern:
    """Matérn kernel with 2ν = ``nu2`` ∈ {1, 3, 5}.

    Numbers become float64 tensors on the CPU; a floating tensor is kept as
    it is (dtype, device and autograd history included)."""

    def __init__(self, variance=1.0, lengthscales=1.0, *, nu2=3):
        if nu2 not in (1, 3, 5):
            raise ValueError("nu2 must be 1, 3 or 5")
        self.variance = as_float(variance)
        self.lengthscales = as_float(lengthscales)
        self.nu2 = nu2

    @property
    def name(self) -> str:
        return {1: "matern12", 3: "matern32", 5: "matern52"}[self.nu2]

    def _points(self, X) -> torch.Tensor:
        return torch.as_tensor(X, dtype=self.variance.dtype,
                               device=self.variance.device).reshape(-1)

    def K_diag(self, X) -> torch.Tensor:
        n = self._points(X).shape[0]
        return self.variance * torch.ones(n, dtype=self.variance.dtype, device=self.variance.device)

    def K(self, X, X2=None) -> torch.Tensor:
        """Dense (n, n2) covariance on the device of the hyperparameters."""
        x = self._points(X)[:, None]
        x2 = x if X2 is None else self._points(X2)[:, None]
        r = torch.abs(x - x2.T) / self.lengthscales
        if self.nu2 == 1:
            return self.variance * torch.exp(-r)
        if self.nu2 == 3:
            s = _SQRT3 * r
            return self.variance * (1.0 + s) * torch.exp(-s)
        s = _SQRT5 * r
        return self.variance * (1.0 + s + s * s / 3.0) * torch.exp(-s)


def Matern12(variance=1.0, lengthscales=1.0):
    return Matern(variance, lengthscales, nu2=1)


def Matern32(variance=1.0, lengthscales=1.0):
    return Matern(variance, lengthscales, nu2=3)


def Matern52(variance=1.0, lengthscales=1.0):
    return Matern(variance, lengthscales, nu2=5)
