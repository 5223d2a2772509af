"""The port's GPR1D serving path against the JAX package's, end to end.

Same data, same parameters (carried across with ``load_jax_params``): the
ELBO, the predictive mean and variance and the NLPD must agree to 1e-10
relative.  Both packages run the same float64 recursions on the CPU in
different summation orders; at Snelson's and the bench generator's scales
κ(Kuu) is small enough that the difference stays near 1e-13.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asvgp_tpu.basis import B2Spline as JB2Spline
from asvgp_tpu.basis import B3Spline as JB3Spline
from asvgp_tpu.models import GPR1D as JGPR1D
from asvgp_tpu.models import Matern32 as JMatern32
from asvgp_tpu.models import Matern52 as JMatern52
from asvgp_tpu.models.gpr1d import default_params as jdefault_params
from asvgp_tpu_torch.banded import core
from asvgp_tpu_torch.basis import B2Spline, B3Spline
from asvgp_tpu_torch.models import GPR1D, Matern32, Matern52, Posterior1D
from asvgp_tpu_torch.models.parameters import positive_inverse
from asvgp_tpu_torch.train import mse, nlpd

DATA_DIR = os.path.join(os.path.dirname(__file__), "..", "data", "snelson")
TOL = 1e-10


def snelson():
    X = np.loadtxt(os.path.join(DATA_DIR, "train_inputs")).reshape(-1, 1)
    y = np.loadtxt(os.path.join(DATA_DIR, "train_outputs")).reshape(-1, 1)
    Xt = np.loadtxt(os.path.join(DATA_DIR, "test_inputs")).reshape(-1, 1)
    return X, y, Xt


def bench_data(n, seed):
    """bench.py's generator at a reduced size."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(0.005, 0.995, n)
    return x, np.sin(4400.0 * x) + 0.5 * np.sin(1100.0 * x) + 0.3 * rng.randn(n)


def raw_params(var, ell, noise):
    def inv(value):
        return positive_inverse(value).numpy()

    return {"kernel": {"raw_variance": inv(var), "raw_lengthscales": inv(ell)},
            "likelihood": {"raw_variance": inv(noise)}}


def _rel(got, want):
    want = np.asarray(want)
    return float(np.max(np.abs(got.detach().numpy() - want)) / np.max(np.abs(want)))


def _assert_serving_matches(model, jmodel, params, Xt, Xd, yd, batch=None):
    with torch.no_grad():
        elbo = model.elbo()
    jelbo = jax.jit(jmodel.elbo)(params)
    assert elbo.dtype == torch.float64
    assert _rel(elbo, jelbo) <= TOL
    mean, var = model.predict_f(Xt, batch=batch)
    jmean, jvar = jmodel.predict_f(params, jnp.asarray(Xt), batch=batch)
    assert mean.shape == var.shape == (Xt.shape[0], 1)
    assert _rel(mean, jmean) <= TOL and _rel(var, jvar) <= TOL
    score = nlpd(model.predict_log_density((Xd, yd)))
    jscore = -jnp.mean(jmodel.predict_log_density(params, (jnp.asarray(Xd), jnp.asarray(yd))))
    assert _rel(score, jscore) <= TOL
    ym, yv = model.predict_y(Xt)
    jym, jyv = jmodel.predict_y(params, jnp.asarray(Xt))
    assert _rel(ym, jym) <= TOL and _rel(yv, jyv) <= TOL


@pytest.mark.parametrize("params", [None, raw_params(0.7, 0.8, 0.2)], ids=["init", "fitted-scale"])
def test_snelson_matches_jax(params):
    X, y, Xt = snelson()
    model = GPR1D((X, y), Matern32(), B3Spline(-3.5, 10.5, 100), device="cpu")
    jmodel = JGPR1D((jnp.asarray(X), jnp.asarray(y)), JMatern32(), JB3Spline(-3.5, 10.5, 100))
    if params is None:
        params = jmodel.init_params()
    model.load_jax_params(jax.tree.map(np.asarray, params))
    _assert_serving_matches(model, jmodel, params, Xt, X, y)
    assert bool((model.predict_f(Xt)[1] > 0).all())


def test_bench_generator_matches_jax():
    x, y = bench_data(20_000, 0)
    xt, yt = bench_data(2_000, 1)
    kernel_args = dict(variance=1.0, lengthscales=1e-3)
    model = GPR1D((x, y), Matern32(**kernel_args), B3Spline(0.0, 1.0, 500), noise_variance=0.1,
                  device="cpu")
    jmodel = JGPR1D((jnp.asarray(x), jnp.asarray(y)), JMatern32(**kernel_args),
                    JB3Spline(0.0, 1.0, 500), noise_variance=0.1)
    params = jmodel.init_params()
    _assert_serving_matches(model, jmodel, params, xt, xt, yt, batch=700)
    assert float(mse(torch.from_numpy(yt), model.predict_f(xt)[0])) < float(np.var(yt))


def test_batch_keeps_the_remainder_chunk():
    X, y, Xt = snelson()
    model = GPR1D((X, y), Matern32(), B3Spline(-3.5, 10.5, 100), device="cpu")
    post = model.posterior()
    assert isinstance(post, Posterior1D)
    mean, var = post.predict_f(Xt)
    for batch in (64, 300, 301, 1000):
        mb, vb = post.predict_f(Xt, batch=batch)
        assert mb.shape == (301, 1)
        # chunks are computed point by point, so batching changes no bit
        torch.testing.assert_close(mb, mean, rtol=0, atol=0)
        torch.testing.assert_close(vb, var, rtol=0, atol=0)


def test_full_cov_raises():
    X, y, Xt = snelson()
    model = GPR1D((X, y), Matern32(), B3Spline(-3.5, 10.5, 100), device="cpu")
    with pytest.raises(NotImplementedError):
        model.predict_f(Xt, full_cov=True)
    with pytest.raises(NotImplementedError):
        model.posterior().predict_f(Xt, full_cov=True)


@pytest.mark.parametrize("case", ["below_a", "above_b", "two_columns", "length_mismatch"])
def test_domain_errors_match_jax(case):
    X, y, _ = snelson()
    X = {"below_a": X - 10.0, "above_b": X + 10.0, "two_columns": np.hstack([X, X]),
         "length_mismatch": X}[case]
    yy = y[:-1] if case == "length_mismatch" else y
    with pytest.raises(ValueError):
        GPR1D((X, yy), Matern32(), B3Spline(-3.5, 10.5, 100), device="cpu")
    with pytest.raises(ValueError):
        JGPR1D((jnp.asarray(X), jnp.asarray(yy)), JMatern32(), JB3Spline(-3.5, 10.5, 100))


def test_capability_errors_match_jax():
    X, y, _ = snelson()
    with pytest.raises(ValueError):
        GPR1D((X, y), Matern52(), B2Spline(-3.5, 10.5, 100), device="cpu")
    with pytest.raises(ValueError):
        JGPR1D((jnp.asarray(X), jnp.asarray(y)), JMatern52(), JB2Spline(-3.5, 10.5, 100))
    with pytest.raises(TypeError):
        GPR1D((X, y), object(), B3Spline(-3.5, 10.5, 100), device="cpu")


def test_parameters_and_buffers():
    X, y, _ = snelson()
    model = GPR1D((X, y), Matern32(0.5, 2.0), B3Spline(-3.5, 10.5, 100), noise_variance=0.3,
                  device="cpu")
    want = jdefault_params(JMatern32(0.5, 2.0), 0.3)
    got = model.init_params()
    for path in (("kernel", "raw_variance"), ("kernel", "raw_lengthscales"), ("likelihood", "raw_variance")):
        np.testing.assert_allclose(got[path[0]][path[1]], np.asarray(want[path[0]][path[1]]), rtol=1e-15)
    names = dict(model.named_parameters())
    assert set(names) == {"raw_variance", "raw_lengthscales", "raw_noise_variance"}
    assert all(p.dtype == torch.float64 and p.requires_grad for p in names.values())
    np.testing.assert_allclose(model.raw_lengthscales.item(), np.asarray(want["kernel"]["raw_lengthscales"]), rtol=1e-15)
    buffers = dict(model.named_buffers())
    assert set(buffers) == {"kuf_y", "kufkfu_band", "yty", "n"}
    assert all(b.dtype == torch.float64 for b in buffers.values())
    model.load_jax_params(raw_params(0.9, 1.1, 0.05))
    kernel, lik = model._build()
    np.testing.assert_allclose([kernel.variance.item(), kernel.lengthscales.item(), lik.variance.item()],
                               [0.9, 1.1, 0.05], rtol=1e-14)
    with pytest.raises(ValueError):
        model.load_jax_params({"kernel": {"raw_variance": np.zeros(2), "raw_lengthscales": 0.0},
                               "likelihood": {"raw_variance": 0.0}})


def test_elbo_is_differentiable_on_cpu():
    """On the CPU the gradient runs the plain versions of the tangent
    sweeps with their elementwise backward, and agrees with JAX's."""
    X, y, _ = snelson()
    basis_args = (-3.5, 10.5, 30)
    model = GPR1D((X, y), Matern32(), B3Spline(*basis_args), device="cpu")
    model.training_loss().backward()
    jmodel = JGPR1D((jnp.asarray(X), jnp.asarray(y)), JMatern32(), JB3Spline(*basis_args))
    g = jax.grad(jmodel.training_loss)(jmodel.init_params())
    got = [model.raw_variance.grad, model.raw_lengthscales.grad, model.raw_noise_variance.grad]
    want = [g["kernel"]["raw_variance"], g["kernel"]["raw_lengthscales"], g["likelihood"]["raw_variance"]]
    np.testing.assert_allclose([t.item() for t in got], np.asarray(want, dtype=np.float64), rtol=1e-8)


@pytest.mark.cuda
def test_gpr1d_on_cuda_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA sweeps have no CPU mode")
    X, y, Xt = snelson()
    cpu = GPR1D((X, y), Matern32(), B3Spline(-3.5, 10.5, 100), device="cpu")
    gpu = GPR1D((X, y), Matern32(), B3Spline(-3.5, 10.5, 100), device="cuda")
    core.reset_counters()
    with torch.no_grad():
        assert _rel(gpu.elbo().cpu(), cpu.elbo().numpy()) <= TOL
    mean, var = gpu.predict_f(Xt, batch=100)
    cmean, cvar = cpu.predict_f(Xt)
    assert _rel(mean.cpu(), cmean.numpy()) <= TOL and _rel(var.cpu(), cvar.numpy()) <= TOL
    assert core.LAUNCHES["chol_pair_solve"] == 2 and core.PLAIN_CALLS["cuda"] == 0
    # with grad: the twisted tangent sweeps, no value sweep
    gpu.training_loss().backward()
    cpu.training_loss().backward()
    assert core.LAUNCHES["chol_quad_solve_tan"] == 1 and core.LAUNCHES["chol_pair_solve"] == 2
    for name, p in gpu.named_parameters():
        assert _rel(p.grad.cpu(), dict(cpu.named_parameters())[name].grad.numpy()) <= 1e-9, name
