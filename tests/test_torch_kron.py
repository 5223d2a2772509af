"""GPRKron in the port (stats/kron.py, models/kron.py) against the JAX
package's GPRKron on the CPU in float64.

Same numpy data from a seed (a few hundred points of a 2-D field), m = 9-10
features per dimension, spline orders (3, 3) and (2, 4); the parameters
carried across with ``load_jax_params``.  The statistics must agree to
1e-12 relative (the same products summed per cell in another order); the
ELBO and its gradient in the raw parameters with ``jax.value_and_grad`` to
1e-10; the posterior's predict_f, predict_y and predict_log_density to
1e-10 of the largest value; ``fit_lbfgs`` over a few iterations in the same
iteration and evaluation counts, its loss to 1e-8.  The port runs the
plain versions of K9–K12 and K16 here; the ``cuda``-marked tests run the
kernels and skip without a card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asvgp_tpu.basis import BSplineBasis as JBasis
from asvgp_tpu.models import Matern32 as JMatern32
from asvgp_tpu.models.kron import GPRKron as JGPRKron
from asvgp_tpu.stats.kron import compute_kron_stats as jcompute_kron_stats
from asvgp_tpu.train import fit_lbfgs as jfit_lbfgs
from asvgp_tpu_torch.banded import core
from asvgp_tpu_torch.basis import BSplineBasis
from asvgp_tpu_torch.models import GPRKron, Matern32, Matern52
from asvgp_tpu_torch.stats import compute_kron_stats
from asvgp_tpu_torch.train import fit_lbfgs

N = 300
CASES = {"o33": ((3, 3), (9, 9)), "o24": ((2, 4), (10, 10))}
LENGTHSCALES = (0.3, 0.2)
TOL = 1e-10


def field(n, seed):
    rng = np.random.RandomState(seed)
    X = rng.uniform(0.02, 0.98, (n, 2))
    f = np.sin(6 * X[:, 0] + 2 * X[:, 1]) + 0.5 * np.cos(9 * X[:, 1]) * X[:, 0]
    return X, (f + 0.1 * rng.randn(n)).reshape(-1, 1)


def rel(got, want):
    got = np.asarray(got.detach().cpu() if isinstance(got, torch.Tensor) else got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _bases(case, pkg):
    orders, ms = CASES[case]
    return [pkg(0.0, 1.0, m, o) for o, m in zip(orders, ms)]


def _model(case, device="cpu"):
    """The port's GPRKron of a case at its initial parameters."""
    X, y = field(N, 0)
    return GPRKron((X, y), [Matern32(lengthscales=ell) for ell in LENGTHSCALES],
                   _bases(case, BSplineBasis), noise_variance=0.1, device=device)


@functools.cache
def _jax_model(case):
    """The JAX package's GPRKron of a case, built once per run so that its
    compiled loss and posterior are reused; it holds no parameters."""
    X, y = field(N, 0)
    return JGPRKron((jnp.asarray(X), jnp.asarray(y)),
                    [JMatern32(lengthscales=ell) for ell in LENGTHSCALES],
                    _bases(case, JBasis), noise_variance=0.1)


def moved_params():
    return {"kernels": [{"raw_lengthscales": np.float64(-1.1), "raw_variance": np.float64(0.4)},
                        {"raw_lengthscales": np.float64(-1.6), "raw_variance": np.float64(-0.2)}],
            "likelihood": {"raw_variance": np.float64(-2.5)}}


def _jax_tree(params):
    """A parameter tree as JAX float64 scalars, one layout for every tree
    so that the compiled loss is reused."""
    return jax.tree.map(lambda v: jnp.asarray(np.float64(v)), params)


def _grads(model):
    """The module's gradient in the JAX package's flattening order."""
    out = []
    for var, ell in zip(model.raw_variances, model.raw_lengthscales):
        out += [float(ell.grad), float(var.grad)]
    return out + [float(model.raw_noise_variance.grad)]


@functools.cache
def _jax_loss(case):
    """The jitted value and gradient of a case's JAX training loss."""
    return jax.jit(jax.value_and_grad(_jax_model(case).training_loss))


def _jax_value_and_grad(case, moved):
    params = moved_params() if moved else _jax_model(case).init_params()
    value, grad = _jax_loss(case)(_jax_tree(params))
    return params, float(value), [float(g) for g in jax.tree.leaves(grad)]


@pytest.mark.parametrize("case", CASES)
def test_kron_stats_match_jax(case):
    X, y = field(N, 1)
    got = compute_kron_stats(_bases(case, BSplineBasis), torch.from_numpy(X), torch.from_numpy(y))
    want = jcompute_kron_stats(_bases(case, JBasis), jnp.asarray(X), jnp.asarray(y))
    for name in ("kuf_y", "t_band", "yty", "n"):
        assert rel(getattr(got, name), getattr(want, name)) <= 1e-12, name


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("moved", [False, True], ids=["init", "moved"])
def test_elbo_and_gradient_match_jax(case, moved):
    """The module's loss and ``backward()`` against ``jax.value_and_grad``;
    one value-and-grad step runs the plain K9 and K11 twice each forward,
    K10 and K12 twice each backward, and K16 once per block column.  At the
    initial parameters ``params()`` is the JAX ``init_params()`` leaf for
    leaf, lists included; at the moved ones ``training_loss(params)`` on a
    pytree of tensors equals the module's loss after ``load_jax_params``
    and differentiates into the tree."""
    model = _model(case)
    params, value, grad = _jax_value_and_grad(case, moved)
    if moved:
        tree = jax.tree.map(lambda v: torch.tensor(float(v), dtype=torch.float64,
                                                   requires_grad=True), params)
        tree_loss = model.training_loss(tree)
        (tree_grad,) = torch.autograd.grad(tree_loss, tree["kernels"][1]["raw_lengthscales"])
    else:
        got = model.params()
        assert set(got) == {"kernels", "likelihood"} and isinstance(got["kernels"], list)
        for g, w in zip(jax.tree.leaves(jax.tree.map(float, got)),
                        jax.tree.leaves(jax.tree.map(float, params)), strict=True):
            assert abs(g - w) <= 1e-15 * abs(w)
    model.load_jax_params(params)
    core.reset_counters()
    loss = model.training_loss()
    loss.backward()
    assert core.PLAIN_CALLS == {"cpu": 8 + model.bases[0].m, "cuda": 0}
    assert abs(float(loss.detach()) - value) <= TOL * abs(value)
    for got, want in zip(_grads(model), grad, strict=True):
        assert abs(got - want) <= TOL * abs(want)
    if moved:
        assert float(model.raw_lengthscales[1].detach()) == -1.6
        assert float(tree_loss.detach()) == float(loss.detach())
        assert float(tree_grad) == float(model.raw_lengthscales[1].grad)


@pytest.mark.parametrize("case", CASES)
def test_predictions_match_jax(case):
    model, jmodel = _model(case), _jax_model(case)
    params = moved_params()
    model.load_jax_params(params)
    jparams = _jax_tree(params)
    Xt, yt = field(120, 2)
    post = model.posterior()
    mean, var = post.predict_f(Xt)
    jmean, jvar = jmodel.predict_f(jparams, jnp.asarray(Xt))
    assert rel(mean, jmean) <= TOL and rel(var, jvar) <= TOL
    assert bool((var > 0).all())
    _, vy = model.predict_y(Xt)
    _, jvy = jmodel.predict_y(jparams, jnp.asarray(Xt))
    assert rel(vy, jvy) <= TOL
    ld = model.predict_log_density((Xt, yt))
    jld = jmodel.predict_log_density(jparams, (jnp.asarray(Xt), jnp.asarray(yt)))
    assert rel(ld, jld) <= TOL
    # in batches, the last one padded: the same values
    mb, vb = post.predict_f(Xt, batch=50)
    assert rel(mb, mean.numpy()) <= 1e-14 and rel(vb, var.numpy()) <= 1e-14


def test_fit_lbfgs_matches_jax():
    model, jmodel = _model("o33"), _jax_model("o33")
    jinfo, info = {}, {}
    jp, jloss, jiters = jfit_lbfgs(jax.jit(jmodel.training_loss), jmodel.init_params(),
                                   max_iters=6, curv_rtol=10.0, info=jinfo)
    params, loss, iters = fit_lbfgs(model.training_loss, model.params(), max_iters=6,
                                    curv_rtol=10.0, info=info)
    assert iters == int(jiters) == 6 and info["ls_evals"] == jinfo["ls_evals"]
    assert abs(loss - float(jloss)) <= 1e-8 * abs(float(jloss))
    assert isinstance(params["kernels"], list) and len(params["kernels"]) == 2
    for got, want in zip(jax.tree.leaves(jax.tree.map(float, params)),
                         jax.tree.leaves(jax.tree.map(float, jp))):
        assert abs(got - want) <= 1e-6 * abs(want)
    model.load_jax_params(params)
    assert abs(float(model.training_loss().detach()) - loss) <= 1e-12 * abs(loss)


def test_validation_errors():
    X, y = field(50, 3)
    bases = _bases("o33", BSplineBasis)
    kernels = [Matern32(), Matern32()]
    with pytest.raises(ValueError, match="D >= 2"):
        GPRKron((X[:, :1], y), kernels[:1], bases[:1], device="cpu")
    with pytest.raises(ValueError, match="one kernel and one basis"):
        GPRKron((X, y), kernels[:1], bases, device="cpu")
    with pytest.raises(ValueError, match="strictly inside"):
        GPRKron((X * 1.1, y), kernels, bases, device="cpu")
    with pytest.raises(ValueError, match="order"):
        GPRKron((X, y), [Matern52(), Matern32()], _bases("o24", BSplineBasis), device="cpu")
    X3 = np.random.RandomState(0).uniform(0.1, 0.9, (50, 3))
    with pytest.raises(NotImplementedError, match="D >= 3"):
        GPRKron((X3, y), kernels + [Matern32()], bases + bases[:1], device="cpu")
    model = GPRKron((X, y), kernels, bases, device="cpu")
    with pytest.raises(NotImplementedError):
        model.predict_f(X, full_cov=True)
    with pytest.raises(ValueError):
        model.load_jax_params({"kernels": moved_params()["kernels"][:1],
                               "likelihood": {"raw_variance": 0.0}})


def test_default_device_is_the_card():
    X, y = field(50, 4)
    if torch.cuda.is_available():
        model = GPRKron((X, y), [Matern32(), Matern32()], _bases("o33", BSplineBasis))
        assert model.kuf_y.is_cuda and model.raw_noise_variance.is_cuda
        return
    with pytest.raises(RuntimeError, match='device="cpu"'):
        GPRKron((X, y), [Matern32(), Matern32()], _bases("o33", BSplineBasis))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_cuda_value_and_grad_match_cpu(cuda_device, case):
    cpu, gpu = _model(case), _model(case, device=cuda_device)
    for model in (cpu, gpu):
        model.load_jax_params(moved_params())
    core.reset_counters()
    g_loss = gpu.training_loss()
    g_loss.backward()
    torch.cuda.synchronize()
    want = {"chol_fwd": 2, "chol_bwd": 2, "tak_fwd": 2, "tak_bwd": 2,
            "chol_inv_dense": gpu.bases[0].m}
    assert {k: v for k, v in core.LAUNCHES.items() if v} == want
    assert core.PLAIN_CALLS["cuda"] == 0
    c_loss = cpu.training_loss()
    c_loss.backward()
    assert abs(float(g_loss) - float(c_loss)) <= 1e-12 * abs(float(c_loss))
    for got, ref in zip(_grads(gpu), _grads(cpu)):
        assert abs(got - ref) <= 1e-10 * abs(ref)
    Xt, _ = field(100, 5)
    gm, gv = gpu.predict_f(Xt, batch=30)
    cm, cv = cpu.predict_f(Xt)
    assert rel(gm, cm.numpy()) <= 1e-10 and rel(gv, cv.numpy()) <= 1e-10
