"""Matérn kernels (1/2, 3/2, 5/2).

PyTorch counterpart of ``asvgp_tpu/models/kernels.py``: ``variance`` and
``lengthscales`` as float64 tensors, and the ``name`` tag that selects the
RKHS-norm formula in features/spline_features.py.
"""

from __future__ import annotations

import torch


class Matern:
    """Matérn kernel with 2ν = ``nu2`` ∈ {1, 3, 5}.

    Numbers become float64 tensors on the CPU; a tensor is kept as it is
    (device and autograd history included)."""

    def __init__(self, variance=1.0, lengthscales=1.0, *, nu2=3):
        if nu2 not in (1, 3, 5):
            raise ValueError("nu2 must be 1, 3 or 5")
        self.variance = torch.as_tensor(variance, dtype=torch.float64)
        self.lengthscales = torch.as_tensor(lengthscales, dtype=torch.float64)
        self.nu2 = nu2

    @property
    def name(self) -> str:
        return {1: "matern12", 3: "matern32", 5: "matern52"}[self.nu2]


def Matern12(variance=1.0, lengthscales=1.0):
    return Matern(variance, lengthscales, nu2=1)


def Matern32(variance=1.0, lengthscales=1.0):
    return Matern(variance, lengthscales, nu2=3)


def Matern52(variance=1.0, lengthscales=1.0):
    return Matern(variance, lengthscales, nu2=5)
