"""B-spline basis on a uniform mesh: evaluation + banded Gram tables.

PyTorch counterpart of ``asvgp_tpu/basis/splines.py``.  The inner-product
and boundary tables are the same exact-rational host tables (numpy float64,
bit-equal to the JAX package's); ``evaluate_basis`` runs on whatever device
its input tensor lies on and returns the structured-sparse pair
``(vals (n, k+1), start (n,))`` with ``start`` as int64, the index dtype
that torch's gathers take.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from asvgp_tpu_torch.basis import bsplines


def _banded_from_cells(cells_desc, m: int, scale: float) -> np.ndarray:
    """Assemble a (k+1, m) lower band from per-overlap-cell inner products.

    ``cells_desc[i]`` is the tuple of exact per-cell products for diagonal
    offset i, ordered boundary->interior (descending cell index j).  The
    running cumulative sum gives the truncated inner products of the
    boundary-straddling basis functions; interior entries are the full sum.
    """
    k = len(cells_desc) - 1
    if m < 2 * k + 2:
        raise ValueError(f"BSplineBasis requires m >= 2*order+2 = {2*k+2}, got m={m}")
    rows = []
    for i, cells in enumerate(cells_desc):
        cells = [float(c) * scale for c in cells]
        lhs = np.cumsum(cells)
        mid = np.full(m - 2 * len(cells) - i, lhs[-1])
        rhs = lhs[::-1]
        rows.append(np.concatenate([lhs, mid, rhs, np.zeros(i)]))
    return np.stack(rows, axis=0)


def _bc_band_from_vector(v: np.ndarray, m: int, order: int) -> np.ndarray:
    """Boundary-condition band from the vector v_s = φ_s^{(d)}(a), s=0..k-1:
    diag(v v^T, +i) at both corners (the bottom-right corner follows from
    the (anti)symmetry of cardinal B-splines)."""
    k = order
    outer = np.outer(v, v)
    rows = []
    for i in range(k):
        l = np.diagonal(outer, offset=i)
        fill = np.zeros(m - 2 * l.shape[0] - i)
        rows.append(np.concatenate([l, fill, l, np.zeros(i)]))
    rows.append(np.zeros(m))
    return np.stack(rows, axis=0)


@dataclasses.dataclass(frozen=True, eq=True)
class BSplineBasis:
    """B-spline basis of a given order on a uniform mesh over [a, b].

    Attributes:
      A, B, C, D      — banded L2 inner products of the 0th..3rd derivatives
                        (C needs order >= 2, D needs order >= 3), numpy f64
      BC, BC_grad, BC_ggrad — boundary outer-product bands (value/grad/ggrad)
      BC_ggrad_none, BC_none_ggrad — cross-boundary bands (identically zero
                        for m >= 2*order+2)
      mesh, delta, order, m
    """

    a: float
    b: float
    m: int
    order: int

    def __post_init__(self):
        if not (1 <= self.order <= 6):
            raise ValueError(f"order must be in 1..6, got {self.order}")
        if self.m < 2 * self.order + 2:
            raise ValueError(
                f"m must be >= 2*order+2 = {2 * self.order + 2}, got m={self.m}"
            )
        if not self.b > self.a:
            raise ValueError("need b > a")

    # ---- static geometry -------------------------------------------------
    @property
    def n_cells(self) -> int:
        return self.m - self.order

    @property
    def delta(self) -> float:
        return (self.b - self.a) / self.n_cells

    @property
    def mesh(self) -> np.ndarray:
        return np.linspace(self.a, self.b, self.n_cells + 1)

    # ---- banded inner-product tables (cached per instance) ---------------
    def _table(self, dx: int) -> np.ndarray:
        if dx > self.order:
            raise ValueError(
                f"L2 inner product of derivative order {dx} is not defined for "
                f"B{self.order} splines (needs order >= {dx})"
            )
        cells = [
            bsplines.overlap_cell_products(self.order, i, dx)
            for i in range(self.order + 1)
        ]
        return _banded_from_cells(cells, self.m, self.delta ** (1 - 2 * dx))

    @property
    def A(self) -> np.ndarray:
        return self._cached("A", lambda: self._table(0))

    @property
    def B(self) -> np.ndarray:
        return self._cached("B", lambda: self._table(1))

    @property
    def C(self) -> np.ndarray:
        return self._cached("C", lambda: self._table(2))

    @property
    def D(self) -> np.ndarray:
        return self._cached("D", lambda: self._table(3))

    def _bc_vector(self, dx: int) -> np.ndarray:
        """v_s = φ_s^{(dx)}(a) for s = 0..order-1 (the functions alive at a)."""
        vals = bsplines.piece_values_at_zero(self.order, dx)
        scale = self.delta ** (-dx)
        return np.array(
            [float(vals[self.order - s]) * scale for s in range(self.order)]
        )

    @property
    def BC(self) -> np.ndarray:
        return self._cached(
            "BC", lambda: _bc_band_from_vector(self._bc_vector(0), self.m, self.order)
        )

    @property
    def BC_grad(self) -> np.ndarray:
        return self._cached(
            "BC_grad",
            lambda: _bc_band_from_vector(self._bc_vector(1), self.m, self.order),
        )

    @property
    def BC_ggrad(self) -> np.ndarray:
        return self._cached(
            "BC_ggrad",
            lambda: _bc_band_from_vector(self._bc_vector(2), self.m, self.order),
        )

    @property
    def BC_ggrad_none(self) -> np.ndarray:
        # cross-boundary product φ''(a) x φ(b): disjoint supports -> zero
        return np.zeros((self.order + 1, self.m))

    @property
    def BC_none_ggrad(self) -> np.ndarray:
        return np.zeros((self.order + 1, self.m))

    def _cached(self, name, fn):
        cache = self.__dict__.setdefault("_cache", {})
        if name not in cache:
            cache[name] = fn()
        return cache[name]

    def table(self, name: str, device, dtype=torch.float64) -> torch.Tensor:
        """Table ``name`` (e.g. "A", "BC_grad") as a ``dtype`` tensor on
        ``device``, rounded from the float64 table and copied there once per
        basis, device and dtype."""
        device = torch.device(device)
        return self._cached(
            (name, str(device), str(dtype)),
            lambda: torch.as_tensor(getattr(self, name), device=device).to(dtype),
        )

    # ---- evaluation --------------------------------------------------------
    def evaluate_basis(self, X: torch.Tensor, dx: int = 0):
        """Structured-sparse evaluation of the basis (or a derivative) at X.

        Args:
          X: (n,) or (n, 1) floating tensor of points inside [a, b].
          dx: derivative order, 0..3.
        Returns:
          (vals, start): ``vals`` is (n, order+1) in X's dtype with
          ``vals[p, s] = φ_{start[p]+s}^{(dx)}(X[p])``; ``start`` is (n,)
          int64, the index of the first active basis function (= cell
          index), clipped to [0, n_cells-1] so that every ``start + s`` is a
          valid row.
        """
        if dx > 3 or dx < 0:
            raise NotImplementedError("dx must be in 0..3")
        x = X.reshape(-1)
        delta = self.delta
        c = torch.clamp(
            torch.floor((x - self.a) / delta).to(torch.int64), 0, self.n_cells - 1
        )
        t = (x - (self.a + c.to(x.dtype) * delta)) / delta
        # coeffs[s, q]: coefficient of t^q for basis function (cell + s)
        coeffs = bsplines.piece_coeff_matrix(self.order, dx) * delta ** (-dx)
        coeffs = torch.as_tensor(coeffs, dtype=x.dtype, device=x.device)
        deg = coeffs.shape[1]
        vals = coeffs[None, :, deg - 1].expand(x.shape[0], self.order + 1)
        for q in range(deg - 2, -1, -1):
            vals = vals * t[:, None] + coeffs[None, :, q]
        return vals, c

    def evaluate_basis_dense(self, X: torch.Tensor, dx: int = 0) -> torch.Tensor:
        """The dense (m, n) evaluation matrix (the reference's sparse=False
        path): column p holds ``evaluate_basis``'s values at rows
        start[p]..start[p]+order, zeros elsewhere."""
        vals, start = self.evaluate_basis(X, dx)
        n = vals.shape[0]
        rows = start[:, None] + torch.arange(self.order + 1, device=start.device)[None, :]
        cols = torch.arange(n, device=start.device)[:, None].expand_as(rows)
        out = vals.new_zeros((self.m, n))
        out[rows, cols] = vals  # each (row, column) once: no accumulation
        return out


def B1Spline(a, b, m):
    return BSplineBasis(a, b, m, 1)


def B2Spline(a, b, m):
    return BSplineBasis(a, b, m, 2)


def B3Spline(a, b, m):
    return BSplineBasis(a, b, m, 3)


def B4Spline(a, b, m):
    return BSplineBasis(a, b, m, 4)


def B5Spline(a, b, m):
    return BSplineBasis(a, b, m, 5)


def B6Spline(a, b, m):
    return BSplineBasis(a, b, m, 6)
