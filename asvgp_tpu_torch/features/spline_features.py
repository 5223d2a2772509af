"""Spline inducing features: banded Kuu via Matérn RKHS norms, structured Kuf.

PyTorch counterpart of ``asvgp_tpu/features/spline_features.py``.
``Kuu[i,j] = <φ_i, φ_j>_H`` combines the basis' L2 inner-product bands with
kernel-specific coefficients; ``Kuf[:, p] = φ(x_p)`` by the reproducing
property.  The Matérn interval norms:

  1/2:  <f,g> = 1/(2σ²) [ (1/ℓ)∫fg + ℓ∫f'g' + (fg)(a) + (fg)(b) ]
  3/2:  √3/(4ℓσ²)A + ℓ/(2√3σ²)B + ℓ³/(12√3σ²)C + 1/(2σ²)BC + ℓ²/(2σ²)BC'
  5/2:  3√5/(16ℓσ²)A + 9ℓ/(16√5σ²)B + 9ℓ³/(80√5σ²)C + 3ℓ⁵/(400√5σ²)D
        + 9/(16σ²)BC + 3ℓ²/(10σ²)BC' + 9ℓ⁴/(400σ²)BC''
        + 3ℓ²/(80σ²)(BC''·1 + 1·BC'')

where A..D are the banded L2 products of the 0th..3rd basis derivatives and
BC* the boundary outer-product bands.  The bands live on the device of the
kernel's hyperparameters (copied there once per basis).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from asvgp_tpu_torch.basis.splines import BSplineBasis

_SQRT3 = math.sqrt(3.0)
_SQRT5 = math.sqrt(5.0)

# minimum spline order for which each Matérn RKHS norm is defined
MIN_ORDER = {"matern12": 1, "matern32": 2, "matern52": 3}


def validate_kernel_basis(kernel, basis: BSplineBasis) -> None:
    """Raise if (kernel, basis) is outside the capability matrix: the
    Matérn-ν RKHS norm needs basis derivatives up to order ν+1/2, so
    matern12/32/52 need spline order >= 1/2/3."""
    name = getattr(kernel, "name", None)
    if name not in MIN_ORDER:
        raise TypeError(f"unsupported kernel for spline features: {name}")
    if basis.order < MIN_ORDER[name]:
        raise ValueError(
            f"{name} requires spline order >= {MIN_ORDER[name]}, "
            f"got order {basis.order}"
        )


def make_kuu(kernel, basis: BSplineBasis) -> torch.Tensor:
    """Banded (order+1, m) Kuu Gram matrix for a Matérn kernel, on the device
    and in the dtype of ``kernel.variance`` (the float64 tables rounded
    once, as the JAX package casts them to its parameters' type)."""
    validate_kernel_basis(kernel, basis)
    name = kernel.name
    var = kernel.variance
    ell = kernel.lengthscales

    def table(key):
        return basis.table(key, var.device, var.dtype)

    A = table("A")
    B = table("B")
    BC = table("BC")

    if name == "matern12":
        return (
            1.0 / (2.0 * ell * var) * A
            + ell / (2.0 * var) * B
            + 1.0 / (2.0 * var) * BC
        )

    C = table("C")
    BCg = table("BC_grad")

    if name == "matern32":
        return (
            _SQRT3 / (4.0 * ell * var) * A
            + ell / (2.0 * _SQRT3 * var) * B
            + ell**3 / (12.0 * _SQRT3 * var) * C
            + 1.0 / (2.0 * var) * BC
            + ell**2 / (2.0 * var) * BCg
        )

    D = table("D")
    BCgg = table("BC_ggrad")
    BC_cross = table("BC_ggrad_none") + table("BC_none_ggrad")

    return (
        (3.0 * _SQRT5) / (16.0 * ell * var) * A
        + (9.0 * ell) / (16.0 * _SQRT5 * var) * B
        + (9.0 * ell**3) / (80.0 * _SQRT5 * var) * C
        + (3.0 * ell**5) / (400.0 * _SQRT5 * var) * D
        + 9.0 / (16.0 * var) * BC
        + (3.0 * ell**2) / (10.0 * var) * BCg
        + (9.0 * ell**4) / (400.0 * var) * BCgg
        + (3.0 * ell**2) / (80.0 * var) * BC_cross
    )


def make_kuf(basis: BSplineBasis, X: torch.Tensor) -> tuple:
    """Structured-sparse Kuf: returns (vals (n, order+1), start (n,) int64).

    Column p of the implicit (m, n) Kuf has its order+1 nonzeros at rows
    start[p] .. start[p]+order with values vals[p].
    """
    return basis.evaluate_basis(X, dx=0)


def kuf_to_dense(basis: BSplineBasis, X: torch.Tensor) -> torch.Tensor:
    """Dense (m, n) Kuf, for tests and small m."""
    return basis.evaluate_basis_dense(X, dx=0)


@dataclasses.dataclass(frozen=True)
class SplineFeatures1D:
    """Bundles (kernel, basis) like the reference's feature class."""

    kernel: object
    basis: BSplineBasis

    def make_Kuu(self, kernel=None):
        return make_kuu(kernel if kernel is not None else self.kernel, self.basis)

    def make_Kuf(self, X):
        return make_kuf(self.basis, X)
