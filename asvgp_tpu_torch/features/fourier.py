"""Variational Fourier Features (VFF) on an interval: the baseline's features.

PyTorch counterpart of ``asvgp_tpu/features/fourier.py``.  The inducing
features are u_m = <φ_m, f>_H for the truncated Fourier basis on [a, b],

    φ_0 = 1,  φ_{2i-1} = cos(ω_i (x - a)),  φ_{2i} = sin(ω_i (x - a)),
    ω_i = 2π i / (b - a),

and <·,·>_H the Matérn interval RKHS inner product of
features/spline_features.py.  The basis is L²-orthogonal on full periods
and periodic at the boundary, so every ∫φ⁽ᵈ⁾φ⁽ᵈ⁾ Gram is diagonal and every
boundary term an outer product of one boundary-value vector: Kuu is
diagonal plus low rank, built dense.  Kuf is dense too (the features are
global), which is what the banded ASVGP features avoid.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

_SQRT3 = math.sqrt(3.0)
_SQRT5 = math.sqrt(5.0)


@dataclasses.dataclass(frozen=True)
class FourierBasis1D:
    """Truncated Fourier basis on [a, b] with ``n_frequencies`` harmonics.

    Feature order: [1, cos_1..cos_F, sin_1..sin_F]; m = 2F + 1.  The tables
    (``omegas``, ``l2_diag``, ``boundary_value``) are float64 numpy arrays.
    """

    a: float
    b: float
    n_frequencies: int

    @property
    def m(self) -> int:
        return 2 * self.n_frequencies + 1

    @property
    def omegas(self) -> np.ndarray:
        i = np.arange(1, self.n_frequencies + 1, dtype=np.float64)
        return 2.0 * np.pi * i / (self.b - self.a)

    def l2_diag(self, dx: int) -> np.ndarray:
        """diag of ∫ φ⁽ᵈˣ⁾ φ⁽ᵈˣ⁾ over [a, b] (off-diagonals are zero)."""
        T = self.b - self.a
        w = self.omegas
        harm = 0.5 * T * w ** (2 * dx)
        const = T if dx == 0 else 0.0
        return np.concatenate([[const], harm, harm])

    def boundary_value(self, dx: int) -> np.ndarray:
        """φ⁽ᵈˣ⁾(a) (= φ⁽ᵈˣ⁾(b)) for dx in 0..2."""
        F = self.n_frequencies
        w = self.omegas
        zeros = np.zeros(F)
        if dx == 0:
            return np.concatenate([[1.0], np.ones(F), zeros])
        if dx == 1:
            return np.concatenate([[0.0], zeros, w])
        if dx == 2:
            return np.concatenate([[0.0], -w**2, zeros])
        raise ValueError(f"dx={dx} not supported")

    def evaluate(self, X) -> torch.Tensor:
        """Dense (n, m) feature matrix Φ with Φ[p, j] = φ_j(x_p), on the
        device and in the dtype of ``X`` (a tensor; anything else becomes a
        float64 tensor on the CPU)."""
        if not isinstance(X, torch.Tensor):
            X = torch.as_tensor(np.asarray(X), dtype=torch.float64)
        x = X.reshape(-1)[:, None] - self.a
        w = torch.as_tensor(self.omegas, dtype=x.dtype, device=x.device)[None, :]
        ones = torch.ones((x.shape[0], 1), dtype=x.dtype, device=x.device)
        return torch.cat([ones, torch.cos(w * x), torch.sin(w * x)], dim=1)


def make_kuu_vff(kernel, fb: FourierBasis1D) -> torch.Tensor:
    """Dense (m, m) VFF Gram Kuu[i, j] = <φ_i, φ_j>_H for a Matérn kernel, on
    the device and in the dtype of ``kernel.variance``: the diagonal L²
    Grams with the interval norm's coefficients, plus the boundary terms'
    outer products."""
    var = kernel.variance
    ell = kernel.lengthscales

    def table(values):
        return torch.as_tensor(values, dtype=var.dtype, device=var.device)

    A = table(fb.l2_diag(0))
    B = table(fb.l2_diag(1))
    v = table(fb.boundary_value(0))
    vv2 = 2.0 * torch.outer(v, v)  # φ(a)φ(a)ᵀ + φ(b)φ(b)ᵀ

    name = kernel.name
    if name == "matern12":
        diag = A / (2.0 * ell * var) + ell * B / (2.0 * var)
        return torch.diag(diag) + vv2 / (2.0 * var)

    C = table(fb.l2_diag(2))
    g = table(fb.boundary_value(1))
    gg2 = 2.0 * torch.outer(g, g)

    if name == "matern32":
        diag = (
            _SQRT3 / (4.0 * ell * var) * A
            + ell / (2.0 * _SQRT3 * var) * B
            + ell**3 / (12.0 * _SQRT3 * var) * C
        )
        return torch.diag(diag) + vv2 / (2.0 * var) + ell**2 / (2.0 * var) * gg2

    if name != "matern52":
        raise TypeError(f"unsupported kernel for Fourier features: {name}")

    D = table(fb.l2_diag(3))
    h = table(fb.boundary_value(2))
    hh2 = 2.0 * torch.outer(h, h)
    cross2 = 2.0 * (torch.outer(h, v) + torch.outer(v, h))
    diag = (
        (3.0 * _SQRT5) / (16.0 * ell * var) * A
        + (9.0 * ell) / (16.0 * _SQRT5 * var) * B
        + (9.0 * ell**3) / (80.0 * _SQRT5 * var) * C
        + (3.0 * ell**5) / (400.0 * _SQRT5 * var) * D
    )
    return (
        torch.diag(diag)
        + 9.0 / (16.0 * var) * vv2
        + (3.0 * ell**2) / (10.0 * var) * gg2
        + (9.0 * ell**4) / (400.0 * var) * hh2
        + (3.0 * ell**2) / (80.0 * var) * cross2
    )
