"""The port's Matérn kernels, likelihood, parameter transforms and Kuu/Kuf
against the JAX package's.

Kuu is the same sum of scaled exact tables in both packages; it is held to
1e-12 relative to its largest entry (the scalar coefficients are computed by
two libms, and ``ell**k`` may be a product or a power).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asvgp_tpu.basis import BSplineBasis as JBasis
from asvgp_tpu.features.spline_features import make_kuf as jmake_kuf
from asvgp_tpu.features.spline_features import make_kuu as jmake_kuu
from asvgp_tpu.features.spline_features import validate_kernel_basis as jvalidate
from asvgp_tpu.models import Gaussian as JGaussian
from asvgp_tpu.models import Matern as JMatern
from asvgp_tpu.models.parameters import positive as jpositive
from asvgp_tpu.models.parameters import positive_inverse as jpositive_inverse
from asvgp_tpu_torch.basis import BSplineBasis
from asvgp_tpu_torch.features import SplineFeatures1D, make_kuf, make_kuu
from asvgp_tpu_torch.features.spline_features import validate_kernel_basis
from asvgp_tpu_torch.models import Gaussian, Matern, Matern12, Matern32, Matern52
from asvgp_tpu_torch.models.parameters import positive, positive_inverse

F64 = torch.float64

CASES = [(1, o) for o in range(1, 7)] + [(3, o) for o in range(2, 7)] + [(5, o) for o in range(3, 7)]


@pytest.mark.parametrize("nu2,order", CASES)
@pytest.mark.parametrize("var,ell", [(1.0, 0.3), (0.7, 2.5)])
def test_make_kuu_matches_jax(nu2, order, var, ell):
    m = 5 * order + 13
    got = make_kuu(Matern(var, ell, nu2=nu2), BSplineBasis(-1.0, 4.0, m, order))
    want = np.asarray(jmake_kuu(JMatern(var, ell, nu2=nu2), JBasis(-1.0, 4.0, m, order)))
    assert got.dtype == F64 and got.shape == (order + 1, m)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_make_kuf_is_evaluate_basis():
    basis = BSplineBasis(0.0, 1.0, 30, 3)
    x = np.random.RandomState(0).uniform(0, 1, 50)
    vals, start = make_kuf(basis, torch.from_numpy(x))
    jvals, jstart = jmake_kuf(JBasis(0.0, 1.0, 30, 3), jnp.asarray(x))
    np.testing.assert_array_equal(start.numpy(), np.asarray(jstart))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), rtol=1e-12, atol=1e-15)
    feats = SplineFeatures1D(Matern32(), basis)
    torch.testing.assert_close(feats.make_Kuu(), make_kuu(Matern32(), basis), rtol=0, atol=0)


@pytest.mark.parametrize(
    "kernel,jkernel,order,exc",
    [
        (Matern32(), JMatern(nu2=3), 1, ValueError),
        (Matern52(), JMatern(nu2=5), 2, ValueError),
        (object(), object(), 3, TypeError),
    ],
)
def test_capability_errors_match(kernel, jkernel, order, exc):
    with pytest.raises(exc):
        validate_kernel_basis(kernel, BSplineBasis(0.0, 1.0, 20, order))
    with pytest.raises(exc):
        jvalidate(jkernel, JBasis(0.0, 1.0, 20, order))
    if exc is ValueError:
        with pytest.raises(exc):
            make_kuu(kernel, BSplineBasis(0.0, 1.0, 20, order))


def test_matern_surface():
    with pytest.raises(ValueError):
        Matern(nu2=2)
    assert [Matern12().name, Matern32().name, Matern52().name] == ["matern12", "matern32", "matern52"]
    k = Matern32(1.0, 1e-3)
    assert k.variance.dtype == F64 and k.lengthscales.dtype == F64
    assert k.lengthscales.item() == 1e-3  # a float64 tensor holds the float exactly


def test_gaussian_matches_jax():
    rng = np.random.RandomState(1)
    mean, var, y = rng.randn(40), rng.uniform(0.1, 2, 40), rng.randn(40)
    got = Gaussian(0.3).predict_log_density(*map(torch.from_numpy, (mean, var, y)))
    want = JGaussian(0.3).predict_log_density(jnp.asarray(mean), jnp.asarray(var), jnp.asarray(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-14)
    m2, v2 = Gaussian(0.3).predict_mean_and_var(torch.from_numpy(mean), torch.from_numpy(var))
    np.testing.assert_array_equal(v2.numpy(), var + 0.3)


@pytest.mark.parametrize("value", [1e-6, 1e-3, 0.1, 1.0, 7.5, 40.0])
def test_positive_roundtrip_matches_jax(value):
    raw = positive_inverse(value)
    assert raw.dtype == F64
    np.testing.assert_allclose(raw.item(), float(jpositive_inverse(value)), rtol=1e-14)
    np.testing.assert_allclose(positive(raw).item(), value, rtol=1e-13)
    np.testing.assert_allclose(positive(raw).item(), float(jpositive(jnp.asarray(raw.item()))), rtol=1e-15)
