"""The VFF baseline of the port (``features/fourier.py``, ``models/vff.py``)
against the JAX package's (``asvgp_tpu/features/fourier.py``,
``asvgp_tpu/models/vff.py``) on the CPU in float64.

The same data (n = 2000 points from a seed, 16 frequencies on [0, 1]) go
through both: the basis tables bit for bit, Kuu for Matérn-1/2, 3/2 and
5/2 within 1e-13, the chunked statistics within 1e-12, the collapsed ELBO
within 1e-10 and its raw-parameter gradient within 1e-8, the predictions
within 1e-10; the capability errors of ``tests/test_vff.py``; and the
model on the CUDA device by default, raising without one.  The JAX model
is built once for the file.  VFF reaches no hand-written kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asvgp_tpu.features.fourier import FourierBasis1D as JFourier
from asvgp_tpu.features.fourier import make_kuu_vff as jmake_kuu_vff
from asvgp_tpu.models.kernels import Matern as JMatern
from asvgp_tpu.models.vff import GPRVFF as JGPRVFF
from asvgp_tpu_torch.features import FourierBasis1D, make_kuu_vff
from asvgp_tpu_torch.models import GPRVFF, Matern
from asvgp_tpu_torch.models.vff import _vff_stats

N, F, ELL, NU2 = 2000, 16, 0.2, 5
CHUNK = 512  # four chunks and a ragged one


def rel(got, want):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def data():
    rng = np.random.RandomState(0)
    x = rng.uniform(0.01, 0.99, N)
    return x, np.sin(7 * x) + 0.3 * rng.randn(N)


@pytest.fixture(scope="module")
def models():
    """(the port's GPRVFF on the CPU, the JAX GPRVFF, a moved params
    pytree in the JAX layout)."""
    x, y = data()
    jm = JGPRVFF((x, y), JMatern(1.0, ELL, nu2=NU2), JFourier(0.0, 1.0, F), chunk=CHUNK)
    tm = GPRVFF((x, y), Matern(1.0, ELL, nu2=NU2), FourierBasis1D(0.0, 1.0, F), chunk=CHUNK,
                device="cpu")
    params = jm.init_params()
    moved = {"kernel": {"raw_lengthscales": params["kernel"]["raw_lengthscales"] + 0.3,
                        "raw_variance": params["kernel"]["raw_variance"] - 0.2},
             "likelihood": {"raw_variance": params["likelihood"]["raw_variance"] - 1.1}}
    return tm, jm, moved


def test_basis_tables_equal_the_jax_ones():
    for a, b, f in ((0.0, 1.0, F), (-3.5, 10.5, 20), (-0.3, 1.7, 4)):
        mine, theirs = FourierBasis1D(a, b, f), JFourier(a, b, f)
        assert mine.m == theirs.m
        assert np.array_equal(mine.omegas, theirs.omegas)
        for dx in range(4):
            assert np.array_equal(mine.l2_diag(dx), theirs.l2_diag(dx))
        for dx in range(3):
            assert np.array_equal(mine.boundary_value(dx), theirs.boundary_value(dx))
        with pytest.raises(ValueError):
            mine.boundary_value(3)
    x = np.linspace(0.0, 1.0, 37)
    assert rel(FourierBasis1D(0.0, 1.0, F).evaluate(torch.from_numpy(x)),
               JFourier(0.0, 1.0, F).evaluate(jnp.asarray(x))) <= 1e-15


@pytest.mark.parametrize("nu2", [1, 3, 5])
def test_kuu_matches_jax(nu2):
    for var, ell in ((1.0, 0.2), (1.7, 0.31), (0.4, 0.05)):
        got = make_kuu_vff(Matern(var, ell, nu2=nu2), FourierBasis1D(0.0, 1.0, F))
        want = jmake_kuu_vff(JMatern(var, ell, nu2=nu2), JFourier(0.0, 1.0, F))
        assert got.dtype == torch.float64 and got.shape == (2 * F + 1, 2 * F + 1)
        assert rel(got, want) <= 1e-13


def test_stats_match_jax(models):
    tm, jm, _ = models
    for got, want in ((tm.kuf_y, jm.kuf_y), (tm.kufkfu, jm.kufkfu), (tm.yty, jm.yty),
                      (tm.n, jm.n)):
        assert rel(got, want) <= 1e-12
    x, y = data()
    whole = _vff_stats(FourierBasis1D(0.0, 1.0, F), torch.from_numpy(x), torch.from_numpy(y),
                       chunk=N)
    assert rel(whole[1], tm.kufkfu) <= 1e-13


def test_elbo_and_gradient_match_jax(models):
    tm, jm, moved = models
    for params in (jm.init_params(), moved):
        want, grad = jax.value_and_grad(jm.training_loss)(params)
        tm.load_jax_params(params)
        tm.zero_grad()
        loss = tm.training_loss()
        loss.backward()
        assert rel(loss, want) <= 1e-10
        assert rel(tm.elbo(params), -want) <= 1e-10
        for p, g in ((tm.raw_lengthscales, grad["kernel"]["raw_lengthscales"]),
                     (tm.raw_variance, grad["kernel"]["raw_variance"]),
                     (tm.raw_noise_variance, grad["likelihood"]["raw_variance"])):
            assert rel(p.grad, g) <= 1e-8
        assert rel(tm.maximum_log_likelihood_objective(params), -want) <= 1e-10


def test_predictions_match_jax(models):
    tm, jm, moved = models
    xs = np.linspace(0.005, 0.995, 300)
    ys = np.cos(5 * xs)
    mean, var = tm.predict_f(xs, params=moved)
    jmean, jvar = jm.predict_f(moved, xs)
    assert mean.shape == var.shape == (300, 1)
    assert rel(mean, jmean) <= 1e-10 and rel(var, jvar) <= 1e-10
    ym, yv = tm.predict_y(xs, params=moved)
    jym, jyv = jm.predict_y(moved, xs)
    assert rel(ym, jym) <= 1e-10 and rel(yv, jyv) <= 1e-10
    assert rel(tm.predict_log_density((xs, ys), params=moved),
               jm.predict_log_density(moved, (xs, ys))) <= 1e-10
    tm.load_jax_params(moved)
    assert rel(tm.predict_f(xs)[0], jmean) <= 1e-10


def test_capability_errors():
    """As tests/test_vff.py: inputs outside the basis' interval and
    ``full_cov=True`` raise."""
    x = np.linspace(0.1, 0.9, 50)
    y = np.sin(x)
    with pytest.raises(ValueError):
        GPRVFF((x, y), Matern(1.0, 0.2, nu2=3), FourierBasis1D(0.2, 2.0, 4), device="cpu")
    model = GPRVFF((x, y), Matern(1.0, 0.2, nu2=3), FourierBasis1D(0.0, 1.0, 4), device="cpu")
    with pytest.raises(NotImplementedError):
        model.predict_f(x, full_cov=True)
    with pytest.raises(TypeError):
        make_kuu_vff(type("K", (), {"name": "rbf", "variance": torch.tensor(1.0),
                                    "lengthscales": torch.tensor(1.0)})(),
                     FourierBasis1D(0.0, 1.0, 4))


def test_device_defaults_to_the_card():
    x = np.linspace(0.1, 0.9, 50)
    if torch.cuda.is_available():
        model = GPRVFF((x, np.sin(x)), Matern(1.0, 0.2, nu2=3), FourierBasis1D(0.0, 1.0, 4))
        assert model.kuf_y.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            GPRVFF((x, np.sin(x)), Matern(1.0, 0.2, nu2=3), FourierBasis1D(0.0, 1.0, 4))
