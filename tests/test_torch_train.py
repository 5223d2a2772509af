"""GPR1D training in the port against the JAX package: the ELBO's value and
gradient through both training routes, ``fit_lbfgs`` and ``ExactGPR``.

Same data, same parameters (carried across with ``load_jax_params``).  The
value and gradient must agree with ``jax.value_and_grad`` to 1e-9 relative
(the float64 recursions in two summation orders, amplified by κ(Kuu)); the
Snelson fit must take the JAX package's 50 iterations and reach its loss to
1e-9 and its parameters to 1e-6; the exact GP's log marginal likelihood
must agree to 1e-10.  On the CPU the training core runs the plain versions
of the tangent sweeps; the ``cuda``-marked tests run the kernels and skip
without a card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asvgp_tpu.basis import B3Spline as JB3Spline
from asvgp_tpu.models import ExactGPR as JExactGPR
from asvgp_tpu.models import GPR1D as JGPR1D
from asvgp_tpu.models import Matern32 as JMatern32
from asvgp_tpu.train import fit_lbfgs as jfit_lbfgs
from asvgp_tpu_torch.banded import core, tan, twist, twist_scope
from asvgp_tpu_torch.basis import B3Spline
from asvgp_tpu_torch.models import GPR1D, ExactGPR, Matern32
from asvgp_tpu_torch.train import fit_lbfgs
from test_torch_gpr1d import bench_data, raw_params, snelson

# the params pytree in JAX's flattening order, and the port's parameters
PATHS = (("kernel", "raw_lengthscales"), ("kernel", "raw_variance"), ("likelihood", "raw_variance"))
TORCH_NAMES = ("raw_lengthscales", "raw_variance", "raw_noise_variance")
TOL_GRAD = 1e-9


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return float(np.asarray(tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree))


def _rel(got, want):
    return abs(got - want) / abs(want)


def _problem(case):
    """(torch args, JAX model, basis args, kernel args, noise) of a case."""
    if case.startswith("snelson"):
        X, y, _ = snelson()
        m = {"snelson": 100, "snelson-m8": 8}[case]
        return X, y, (-3.5, 10.5, m), {}, 1.0
    x, y = bench_data(20_000, 0)
    return x, y, (0.0, 1.0, 500), dict(variance=1.0, lengthscales=1e-3), 0.1


def _models(case, device="cpu"):
    X, y, basis_args, kernel_args, noise = _problem(case)
    model = GPR1D((X, y), Matern32(**kernel_args), B3Spline(*basis_args), noise_variance=noise,
                  device=device)
    jmodel = JGPR1D((jnp.asarray(X), jnp.asarray(y)), JMatern32(**kernel_args),
                    JB3Spline(*basis_args), noise_variance=noise)
    return model, jmodel


def _moved_params(case):
    """Raw parameters away from the initial point, at the lengthscale of
    the case's data."""
    return raw_params(0.7, 2e-3 if case == "bench" else 0.8, 0.2)


@functools.cache
def _jax_value_and_grad(case, moved):
    """The JAX package's loss and gradient at a case's initial or moved
    parameters (shared by both routes of the port)."""
    _, jmodel = _models(case)
    params = _moved_params(case) if moved else jmodel.init_params()
    value, grad = jax.value_and_grad(jmodel.training_loss)(jax.tree.map(jnp.asarray, params))
    return params, float(value), {path: _leaf(grad, path) for path in PATHS}


@pytest.fixture
def route_spy(monkeypatch):
    """Counts the calls of the twisted and the single-ended tangent sweeps."""
    calls = {"twist": 0, "tan": 0}

    def spy(module, name, key):
        fn = getattr(module, name)

        def wrapped(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)

        monkeypatch.setattr(module, name, wrapped)

    spy(twist, "chol_quad_solve_tan", "twist")
    spy(tan, "chol_pair_solve_tan", "tan")
    return calls


@pytest.mark.parametrize("case,twist_on,route", [
    ("snelson", True, "twist"),
    ("snelson", False, "tan"),
    ("bench", True, "twist"),
    ("bench", False, "tan"),
    ("snelson-m8", True, "tan"),  # m = 8: twist_applicable is false
])
@pytest.mark.parametrize("moved", [False, True], ids=["init", "moved"])
def test_value_and_grad_match_jax(route_spy, case, twist_on, route, moved):
    model, _ = _models(case)
    k, m = 3, model.kufkfu_band.shape[1]
    assert twist.twist_applicable(k, m) == (case != "snelson-m8")
    params, value, grad = _jax_value_and_grad(case, moved)
    model.load_jax_params(params)
    with twist_scope(twist_on):
        loss = model.training_loss()
    loss.backward()
    assert route_spy == {"twist": int(route == "twist"), "tan": int(route == "tan")}
    assert _rel(float(loss.detach()), value) <= TOL_GRAD
    for name, path in zip(TORCH_NAMES, PATHS):
        got = float(getattr(model, name).grad)
        assert _rel(got, grad[path]) <= TOL_GRAD, name


def test_value_without_grad_runs_the_value_sweeps(route_spy):
    model, _ = _models("snelson")
    core.reset_counters()
    with torch.no_grad():
        model.training_loss()
    assert route_spy == {"twist": 0, "tan": 0}
    assert core.PLAIN_CALLS["cpu"] == 2  # the plain K1 and K2


def test_explicit_params_match_module_params():
    """``training_loss(params)`` with a pytree of tensors is the module's
    loss at those parameters, and differentiates into the pytree."""
    model, _ = _models("snelson")
    params = {k: {kk: torch.as_tensor(v, dtype=torch.float64).requires_grad_()
                  for kk, v in sub.items()} for k, sub in _moved_params("snelson").items()}
    loss = model.training_loss(params)
    (g_var,) = torch.autograd.grad(loss, params["kernel"]["raw_variance"])
    model.load_jax_params(params)
    loss2 = model.training_loss()
    loss2.backward()
    assert float(loss.detach()) == float(loss2.detach())
    assert float(g_var) == float(model.raw_variance.grad)


@pytest.mark.parametrize("make", [
    lambda X, y: GPR1D((X, y), Matern32(), B3Spline(-3.5, 10.5, 100)),
    lambda X, y: ExactGPR((X, y), Matern32()),
], ids=["gpr1d", "exact"])
def test_default_device_is_the_card(make):
    X, y, _ = snelson()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            make(X, y)
        return
    model = make(X, y)
    assert model.y.is_cuda if isinstance(model, ExactGPR) else model.kuf_y.is_cuda
    assert model.raw_variance.is_cuda


def test_exact_gp_follows_a_tensors_device():
    X, y, _ = snelson()
    model = ExactGPR((torch.as_tensor(X), torch.as_tensor(y)), Matern32())
    assert model.X.device.type == "cpu" and model.raw_variance.device.type == "cpu"


def test_fit_lbfgs_snelson_matches_jax():
    model, jmodel = _models("snelson")
    jinfo, info = {}, {}
    jp, jloss, jiters = jfit_lbfgs(jax.jit(jmodel.training_loss), jmodel.init_params(), info=jinfo)
    params, loss, iters = fit_lbfgs(model.training_loss, model.params(), info=info)
    assert iters == int(jiters) == 50
    assert info["ls_evals"] == jinfo["ls_evals"]
    assert _rel(loss, float(jloss)) <= 1e-9
    for path in PATHS:
        assert _rel(_leaf(params, path), _leaf(jp, path)) <= 1e-6, path
        assert isinstance(params[path[0]][path[1]], torch.Tensor)
    assert set(info) >= {"grad_norm", "converged", "restarts", "ls_evals", "evals_per_iter",
                         "stopping_rule"}
    assert info["converged"] and info["stopping_rule"] == jinfo["stopping_rule"]
    # the fitted ELBO lower-bounds the exact GP's evidence, as in the
    # reference's Snelson protocol (exact logZ ≈ −60.574)
    assert loss > 60.57


def _rosenbrock(p):
    """A curved valley, on JAX arrays and on tensors alike."""
    a, b = p["x"]["a"], p["x"]["b"]
    return (1.0 - a) ** 2 + 100.0 * (b - a * a) ** 2 + 0.1 * p["z"] ** 2


@pytest.mark.parametrize("kwargs", [
    dict(),
    dict(curv_rtol=10.0, max_iters=15),
    dict(ls_guess="one", memory_size=3),
    dict(max_iters=4, restarts=3),
], ids=["default", "curv10", "guess-one-mem3", "restarts"])
def test_fit_lbfgs_controller_matches_jax(kwargs):
    """The zoom controller's decisions on a curved valley (bracketing,
    zoom, restarts): the same iterates, iteration and evaluation counts."""
    p0 = {"x": {"a": np.float64(-1.2), "b": np.float64(1.0)}, "z": np.float64(0.5)}
    jinfo, info = {}, {}
    jp, jloss, jiters = jfit_lbfgs(jax.jit(_rosenbrock), jax.tree.map(jnp.asarray, p0),
                                   info=jinfo, **kwargs)
    params, loss, iters = fit_lbfgs(_rosenbrock, p0, info=info, **kwargs)
    assert iters == int(jiters)
    assert {k: info[k] for k in ("ls_evals", "restarts", "converged")} == \
        {k: jinfo[k] for k in ("ls_evals", "restarts", "converged")}
    assert info.get("rejected_restart_iters") == jinfo.get("rejected_restart_iters")
    assert abs(loss - float(jloss)) <= 1e-12 * max(1.0, abs(float(jloss)))
    for path in (("x", "a"), ("x", "b"), ("z",)):
        assert abs(_leaf(params, path) - _leaf(jp, path)) <= 1e-9, path


def _rosenbrock_list(p):
    """The same valley with its parameters in a list and a tuple, as
    GPRKron keeps its per-dimension kernels."""
    a, b = p["x"][0]["a"], p["x"][1]
    return (1.0 - a) ** 2 + 100.0 * (b - a * a) ** 2 + 0.1 * p["z"][0] ** 2


def test_fit_lbfgs_takes_lists_like_jax():
    """A tree with a list and a tuple flattens in JAX's order (dict keys
    sorted, items in index order) and comes back with them intact."""
    p0 = {"z": (np.float64(0.5),), "x": [{"a": np.float64(-1.2)}, np.float64(1.0)]}
    jinfo, info = {}, {}
    jp, jloss, jiters = jfit_lbfgs(jax.jit(_rosenbrock_list), jax.tree.map(jnp.asarray, p0),
                                   info=jinfo)
    params, loss, iters = fit_lbfgs(_rosenbrock_list, p0, info=info)
    assert iters == int(jiters) and info["ls_evals"] == jinfo["ls_evals"]
    assert abs(loss - float(jloss)) <= 1e-12 * max(1.0, abs(float(jloss)))
    assert isinstance(params["x"], list) and isinstance(params["z"], tuple)
    for got, want in zip(jax.tree.leaves(params), jax.tree.leaves(jp)):
        assert isinstance(got, torch.Tensor)
        assert abs(float(got) - float(want)) <= 1e-9


def test_fit_lbfgs_rejects_mixed_devices_and_bad_guess():
    with pytest.raises(ValueError):
        fit_lbfgs(_rosenbrock, {"x": {"a": 1.0, "b": 1.0}, "z": 0.0}, ls_guess="two")
    p = {"x": {"a": torch.tensor(1.0, dtype=torch.float64),
               "b": torch.tensor(1.0, dtype=torch.float64, device="meta")},
         "z": torch.tensor(0.0, dtype=torch.float64)}
    with pytest.raises(ValueError, match="one device"):
        fit_lbfgs(_rosenbrock, p)


@pytest.mark.parametrize("params", [None, raw_params(0.7, 0.8, 0.2)], ids=["init", "moved"])
def test_exact_gp_matches_jax(params):
    X, y, Xt = snelson()
    model = ExactGPR((X, y), Matern32(), device="cpu")
    jmodel = JExactGPR((jnp.asarray(X), jnp.asarray(y)), JMatern32())
    if params is None:
        params = jmodel.init_params()
    model.load_jax_params(params)
    jparams = jax.tree.map(jnp.asarray, params)
    value, grad = jax.value_and_grad(jmodel.log_marginal_likelihood)(jparams)
    lml = model.log_marginal_likelihood()
    lml.backward()
    assert _rel(float(lml.detach()), float(value)) <= 1e-10
    for name, path in zip(TORCH_NAMES, PATHS):
        assert _rel(float(getattr(model, name).grad), _leaf(grad, path)) <= 1e-10, name
    mean, var = model.predict_f(Xt[:50])
    jmean, jvar = jmodel.predict_f(jparams, jnp.asarray(Xt[:50]))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=0,
                               atol=1e-10 * float(np.max(np.abs(jmean))))
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), rtol=0,
                               atol=1e-10 * float(np.max(np.abs(jvar))))


def test_exact_gp_predict_log_density_matches_jax():
    X, y, Xt = snelson()
    yt = np.sin(Xt[:40])
    model = ExactGPR((X, y), Matern32(), device="cpu")
    jmodel = JExactGPR((jnp.asarray(X), jnp.asarray(y)), JMatern32())
    params = {"kernel": {"raw_lengthscales": np.float64(0.3), "raw_variance": np.float64(-0.4)},
              "likelihood": {"raw_variance": np.float64(-1.5)}}
    model.load_jax_params(params)
    got = model.predict_log_density((Xt[:40], yt))
    want = np.asarray(jmodel.predict_log_density(jax.tree.map(jnp.asarray, params),
                                                 (jnp.asarray(Xt[:40]), jnp.asarray(yt))))
    assert got.shape == want.shape == (40, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10 * float(np.max(np.abs(want))))


def test_exact_gp_fit_matches_jax():
    X, y, _ = snelson()
    model = ExactGPR((X, y), Matern32(), device="cpu")
    jmodel = JExactGPR((jnp.asarray(X), jnp.asarray(y)), JMatern32())
    jp, jloss, jiters = jfit_lbfgs(jax.jit(jmodel.training_loss), jmodel.init_params())
    params, loss, iters = fit_lbfgs(model.training_loss, model.params())
    assert iters == int(jiters)
    assert _rel(loss, float(jloss)) <= 1e-9
    for path in PATHS:
        assert _rel(_leaf(params, path), _leaf(jp, path)) <= 1e-6, path


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA sweeps have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("twist_on", [True, False], ids=["twist", "single-ended"])
def test_cuda_value_and_grad_match_cpu(cuda_device, twist_on):
    cpu, _ = _models("bench")
    gpu, _ = _models("bench", device=cuda_device)
    core.reset_counters()
    with twist_scope(twist_on):
        g_loss = gpu.training_loss()
        c_loss = cpu.training_loss()
    g_loss.backward()
    c_loss.backward()
    torch.cuda.synchronize()
    keys = ("chol_quad_solve_tan", "tak_quad_solve_tan") if twist_on else \
        ("chol_pair_solve_tan", "tak_pair_solve_tan")
    assert [core.LAUNCHES[key] for key in keys] == [1, 1]
    assert core.PLAIN_CALLS["cuda"] == 0
    assert _rel(float(g_loss), float(c_loss)) <= 1e-12
    for name in TORCH_NAMES:
        got = float(getattr(gpu, name).grad)
        assert _rel(got, float(getattr(cpu, name).grad)) <= TOL_GRAD, name


@pytest.mark.cuda
def test_cuda_fit_matches_cpu(cuda_device):
    cpu, _ = _models("snelson")
    gpu, _ = _models("snelson", device=cuda_device)
    c_params, c_loss, c_iters = fit_lbfgs(cpu.training_loss, cpu.params(), max_iters=8)
    g_params, g_loss, g_iters = fit_lbfgs(gpu.training_loss, gpu.params(), max_iters=8)
    assert g_iters == c_iters == 8
    assert _rel(g_loss, c_loss) <= 1e-10
    for path in PATHS:
        assert g_params[path[0]][path[1]].is_cuda
        assert _rel(_leaf(g_params, path), _leaf(c_params, path)) <= 1e-8, path
    X, y, _ = snelson()
    exact = ExactGPR((torch.as_tensor(X, device=cuda_device), torch.as_tensor(y, device=cuda_device)),
                     Matern32())
    assert exact.X.is_cuda
    e_params, e_loss, _ = fit_lbfgs(exact.training_loss, exact.params(), max_iters=8)
    assert e_params["kernel"]["raw_variance"].is_cuda and np.isfinite(e_loss)
