"""The port's B-spline basis against the JAX package's.

The tables come from the same exact-rational generator, so they must be
bit-equal; ``start`` is an integer cell index and must match exactly, on
cell boundaries and just inside b included.  Basis values are the same
float64 Horner polynomial in both; they are held to 1e-12 relative, room
for an fma contraction in either compiler.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asvgp_tpu.basis import BSplineBasis as JBasis
from asvgp_tpu.basis import bsplines as jbsplines
from asvgp_tpu_torch.basis import BSplineBasis, B3Spline
from asvgp_tpu_torch.basis import bsplines

TABLES = ("A", "B", "C", "D", "BC", "BC_grad", "BC_ggrad", "BC_ggrad_none", "BC_none_ggrad")


@pytest.mark.parametrize("order", range(1, 7))
def test_tables_bit_equal(order):
    a, b, m = -1.25, 2.5, 3 * order + 9
    ours, ref = BSplineBasis(a, b, m, order), JBasis(a, b, m, order)
    for name in TABLES:
        if name in ("C", "D") and order < {"C": 2, "D": 3}[name]:
            with pytest.raises(ValueError):
                getattr(ours, name)
            continue
        got, want = getattr(ours, name), getattr(ref, name)
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(ours.mesh, ref.mesh)
    assert ours.delta == ref.delta and ours.n_cells == ref.n_cells


@pytest.mark.parametrize("order", range(1, 7))
def test_generator_bit_equal(order):
    for dx in range(0, min(order, 3) + 1):
        np.testing.assert_array_equal(
            bsplines.piece_coeff_matrix(order, dx), jbsplines.piece_coeff_matrix(order, dx)
        )
        assert bsplines.piece_values_at_zero(order, dx) == jbsplines.piece_values_at_zero(order, dx)


def test_table_on_device_is_cached_float64():
    basis = B3Spline(0.0, 1.0, 40)
    t = basis.table("A", "cpu")
    assert t.dtype == torch.float64 and t is basis.table("A", torch.device("cpu"))
    np.testing.assert_array_equal(t.numpy(), basis.A)


def _points(basis, n, seed):
    """Random points plus every mesh node and the edges just inside b."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(basis.a, basis.b, n)
    edges = np.array([basis.a, np.nextafter(basis.b, basis.a), basis.b - 1e-12 * (basis.b - basis.a)])
    return np.concatenate([x, basis.mesh, edges])


@pytest.mark.parametrize(
    "order,dx", [(o, d) for o in range(1, 7) for d in range(0, min(o, 3) + 1)]
)
def test_evaluate_basis_matches_jax(order, dx):
    ours = BSplineBasis(-0.5, 3.0, 4 * order + 11, order)
    ref = JBasis(-0.5, 3.0, 4 * order + 11, order)
    x = _points(ours, 257, seed=order * 10 + dx)
    vals, start = ours.evaluate_basis(torch.from_numpy(x), dx)
    jvals, jstart = ref.evaluate_basis(jnp.asarray(x), dx)
    assert vals.dtype == torch.float64 and start.dtype == torch.int64
    np.testing.assert_array_equal(start.numpy(), np.asarray(jstart))
    assert int(start.max()) <= ours.n_cells - 1 and int(start.min()) >= 0
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), rtol=1e-12, atol=1e-12 * np.abs(jvals).max())


def test_evaluate_basis_shapes_and_errors():
    basis = B3Spline(0.0, 1.0, 20)
    vals, start = basis.evaluate_basis(torch.linspace(0.01, 0.99, 7, dtype=torch.float64)[:, None])
    assert vals.shape == (7, 4) and start.shape == (7,)
    with pytest.raises(NotImplementedError):
        basis.evaluate_basis(torch.zeros(3, dtype=torch.float64), dx=4)
    for bad in ((0.0, 1.0, 20, 0), (0.0, 1.0, 20, 7), (0.0, 1.0, 7, 3), (1.0, 1.0, 20, 3)):
        with pytest.raises(ValueError):
            BSplineBasis(*bad)
        with pytest.raises(ValueError):
            JBasis(*bad)


def test_partition_of_unity():
    basis = B3Spline(0.0, 1.0, 50)
    x = torch.from_numpy(np.random.RandomState(3).uniform(0, 1, 100))
    vals, _ = basis.evaluate_basis(x)
    torch.testing.assert_close(vals.sum(1), torch.ones(100, dtype=torch.float64), rtol=0, atol=1e-14)

