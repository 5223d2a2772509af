"""The plain Kuu of one input dimension: B-spline RKHS Gram matrices of the
Matérn kernels, dense, in plain PyTorch.

A frozen copy of the exact-rational B-spline tables (the L2 inner products
of the basis derivatives per overlapping cell, and the boundary terms) and
of the Matérn RKHS-norm formulas; it imports nothing of the program.

  Kuu[i, j] = <φ_i, φ_j>_H, with for Matérn-1/2, 3/2, 5/2
  1/2:  1/(2ℓσ²)A + ℓ/(2σ²)B + 1/(2σ²)BC
  3/2:  √3/(4ℓσ²)A + ℓ/(2√3σ²)B + ℓ³/(12√3σ²)C + 1/(2σ²)BC + ℓ²/(2σ²)BC'
  5/2:  3√5/(16ℓσ²)A + 9ℓ/(16√5σ²)B + 9ℓ³/(80√5σ²)C + 3ℓ⁵/(400√5σ²)D
        + 9/(16σ²)BC + 3ℓ²/(10σ²)BC' + 9ℓ⁴/(400σ²)BC''

where A..D are the L2 products of the 0th..3rd derivatives and BC* the
boundary outer products of the values, slopes and curvatures at a and b.
"""

from __future__ import annotations

import math
from fractions import Fraction
from functools import lru_cache

import numpy as np
import torch


def _add(a, b):
    n = max(len(a), len(b))
    a = tuple(a) + (Fraction(0),) * (n - len(a))
    b = tuple(b) + (Fraction(0),) * (n - len(b))
    return tuple(x + y for x, y in zip(a, b))


def _mul(a, b):
    out = [Fraction(0)] * (len(a) + len(b) - 1)
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            out[i + j] += x * y
    return tuple(out)


def _deriv(a):
    return tuple(Fraction(i) * a[i] for i in range(1, len(a))) or (Fraction(0),)


@lru_cache(maxsize=None)
def pieces(order: int, dx: int = 0) -> tuple:
    """The dx-th derivatives of the order + 1 polynomial pieces of the
    cardinal B-spline B_order on [0, order + 1], piece p in the local
    coordinate t ∈ [0, 1), ascending powers, exact."""
    if dx:
        return tuple(_deriv(p) for p in pieces(order, dx - 1))
    if order == 0:
        return ((Fraction(1),),)
    prev = pieces(order - 1)
    k = Fraction(order)
    out = []
    for p in range(order + 1):
        # B_k(p + t) = (p + t)/k B_{k-1}(p + t) + (k + 1 - p - t)/k B_{k-1}(p - 1 + t)
        term = (Fraction(0),)
        if p < order:
            term = _add(term, _mul((Fraction(p) / k, 1 / k), prev[p]))
        if p >= 1:
            term = _add(term, _mul(((k + 1 - p) / k, -1 / k), prev[p - 1]))
        out.append(term)
    return tuple(out)


def _integral01(a) -> Fraction:
    return sum((c / Fraction(i + 1) for i, c in enumerate(a)), Fraction(0))


def _l2_band(order: int, m: int, dx: int, delta: float) -> np.ndarray:
    """(order + 1, m) lower band of ∫ φ_i^(dx) φ_j^(dx) over [a, b]: the
    interior entries are the full sums over the overlapping cells, the ones
    at the ends the sums over the cells inside the domain."""
    ps = pieces(order, dx)
    rows = []
    for off in range(order + 1):
        cells = [float(_integral01(_mul(ps[j], ps[j - off]))) * delta ** (1 - 2 * dx)
                 for j in range(order, off - 1, -1)]
        lhs = np.cumsum(cells)
        mid = np.full(m - 2 * len(cells) - off, lhs[-1])
        rows.append(np.concatenate([lhs, mid, lhs[::-1], np.zeros(off)]))
    return np.stack(rows)


def _boundary_band(order: int, m: int, dx: int, delta: float) -> np.ndarray:
    """(order + 1, m) lower band of v vᵀ at both ends, v_s = φ_s^(dx)(a)."""
    ps = pieces(order, dx)
    v = np.array([float(sum(ps[order - s][:1])) * delta ** (-dx) for s in range(order)])
    outer = np.outer(v, v)
    rows = []
    for off in range(order):
        d = np.diagonal(outer, offset=off)
        rows.append(np.concatenate([d, np.zeros(m - 2 * d.shape[0] - off), d, np.zeros(off)]))
    rows.append(np.zeros(m))
    return np.stack(rows)


def band_to_dense(band: torch.Tensor) -> torch.Tensor:
    """The dense symmetric (m, m) matrix of a (k + 1, m) lower band
    (band[p, j] = A[j + p, j])."""
    k1, m = band.shape
    dense = torch.diag(band[0])
    for p in range(1, k1):
        off = torch.diag(band[p, : m - p], -p)
        dense = dense + off + off.T
    return dense


def kuu_dense(nu2: int, order: int, a: float, b: float, m: int,
              variance: torch.Tensor, lengthscale: torch.Tensor) -> torch.Tensor:
    """Dense (m, m) Kuu of a Matérn-ν (2ν = ``nu2``) kernel on the B-spline
    basis of ``order`` with m functions on [a, b]; differentiable in the
    hyperparameters, on their device and in their dtype."""
    delta = (b - a) / (m - order)
    dev, dt = variance.device, variance.dtype

    def t(table):
        return band_to_dense(torch.as_tensor(table, device=dev).to(dt))

    A, B = t(_l2_band(order, m, 0, delta)), t(_l2_band(order, m, 1, delta))
    BC = t(_boundary_band(order, m, 0, delta))
    var, ell = variance, lengthscale
    if nu2 == 1:
        return A / (2 * ell * var) + ell / (2 * var) * B + BC / (2 * var)
    C, BCg = t(_l2_band(order, m, 2, delta)), t(_boundary_band(order, m, 1, delta))
    s3, s5 = math.sqrt(3.0), math.sqrt(5.0)
    if nu2 == 3:
        return (s3 / (4 * ell * var) * A + ell / (2 * s3 * var) * B
                + ell ** 3 / (12 * s3 * var) * C + BC / (2 * var) + ell ** 2 / (2 * var) * BCg)
    D, BCgg = t(_l2_band(order, m, 3, delta)), t(_boundary_band(order, m, 2, delta))
    return (3 * s5 / (16 * ell * var) * A + 9 * ell / (16 * s5 * var) * B
            + 9 * ell ** 3 / (80 * s5 * var) * C + 3 * ell ** 5 / (400 * s5 * var) * D
            + 9 / (16 * var) * BC + 3 * ell ** 2 / (10 * var) * BCg
            + 9 * ell ** 4 / (400 * var) * BCgg)
