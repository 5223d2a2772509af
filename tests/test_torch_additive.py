"""GPRAdditive in the port (stats/additive.py, models/additive.py) against
the JAX package's GPRAdditive on the CPU in float64.

Same numpy data from a seed, parameters carried across with
``load_jax_params``.  Two cases: "dense", D = 3 with m = 10, 12, 9 and
Matérn-3/2, 1/2 and 5/2 (M = 31 ≤ 128: P by ``torch.linalg.cholesky``),
and "block", D = 2 with m = 70 (M = 140 > 128: P through the
full-bandwidth block route with K16's plain version; the JAX package takes
its plain float64 Cholesky there on the CPU).  The statistics must agree
to 1e-12 relative; the ELBO and its gradient in the raw parameters with
``jax.value_and_grad`` to 1e-10 (the gradient relative to its largest
component); predict_f, predict_y and
predict_log_density to 1e-10 of the largest value; ``fit_lbfgs`` in the
same iteration and evaluation counts, its loss to 1e-8.  The block-route
functions are held to the JAX package's at M = 300 (3 blocks) at the JAX
test's tolerances.  The ``cuda``-marked tests run K9–K12 and K16 through
the model and skip without a card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asvgp_tpu.banded import layout as jlayout
from asvgp_tpu.basis import BSplineBasis as JBasis
from asvgp_tpu.models import Matern12 as JMatern12
from asvgp_tpu.models import Matern32 as JMatern32
from asvgp_tpu.models import Matern52 as JMatern52
from asvgp_tpu.models.additive import GPRAdditive as JGPRAdditive
from asvgp_tpu.models.additive import _logdet_halfsolve_block as jlogdet_halfsolve_block
from asvgp_tpu.models.additive import _solve_and_inverse_block as jsolve_and_inverse_block
from asvgp_tpu.train import fit_lbfgs as jfit_lbfgs
from asvgp_tpu_torch.banded import core, layout
from asvgp_tpu_torch.basis import B3Spline, BSplineBasis
from asvgp_tpu_torch.models import (
    GPR1D,
    ExactGPR,
    GPRAdditive,
    GPRKron,
    Matern12,
    Matern32,
    Matern52,
    PosteriorAdditive,
)
from asvgp_tpu_torch.models.additive import _logdet_halfsolve_block, _solve_and_inverse_block
from asvgp_tpu_torch.stats import compute_additive_stats
from asvgp_tpu_torch.train import fit_lbfgs

N = 200
# case: (per-dimension (m, order), per-dimension (kernel name, variance, lengthscale))
CASES = {
    "dense": (((10, 3), (12, 3), (9, 3)),
              (("32", 0.8, 0.5), ("12", 1.1, 0.9), ("52", 0.6, 0.7))),
    "block": (((70, 3), (70, 3)), (("32", 1.0, 0.05), ("52", 0.7, 0.06))),
}
TOL = 1e-10
JKERNELS = {"12": JMatern12, "32": JMatern32, "52": JMatern52}
KERNELS = {"12": Matern12, "32": Matern32, "52": Matern52}


def field(n, D, seed):
    rng = np.random.RandomState(seed)
    X = rng.uniform(0.05, 0.95, (n, D))
    y = sum(np.sin((d + 2) * X[:, d]) for d in range(D)) + 0.1 * rng.randn(n)
    return X, y.reshape(-1, 1)


def rel(got, want):
    got = np.asarray(got.detach().cpu() if isinstance(got, torch.Tensor) else got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _bases(case, pkg):
    return [pkg(0.0, 1.0, m, order) for m, order in CASES[case][0]]


def _kernels(case, table):
    return [table[name](var, ell) for name, var, ell in CASES[case][1]]


def _model(case, device="cpu"):
    """The port's GPRAdditive of a case at its initial parameters."""
    X, y = field(N, len(CASES[case][0]), 0)
    return GPRAdditive((X, y), _kernels(case, KERNELS), _bases(case, BSplineBasis),
                       noise_variance=0.2, device=device)


@functools.cache
def _jax_model(case):
    """The JAX package's GPRAdditive of a case, built once per run so that
    its compiled loss and prediction are reused; it holds no parameters."""
    X, y = field(N, len(CASES[case][0]), 0)
    return JGPRAdditive((jnp.asarray(X), jnp.asarray(y)), _kernels(case, JKERNELS),
                        _bases(case, JBasis), noise_variance=0.2)


@functools.cache
def _jax_loss(case):
    return jax.jit(jax.value_and_grad(_jax_model(case).training_loss))


def moved_params(D):
    rng = np.random.RandomState(5)
    return {"kernels": [{"raw_lengthscales": np.float64(-3.0 + 0.2 * rng.randn()),
                         "raw_variance": np.float64(0.3 * rng.randn())} for _ in range(D)],
            "likelihood": {"raw_variance": np.float64(-1.9)}}


def _jax_tree(params):
    return jax.tree.map(lambda v: jnp.asarray(np.float64(v)), params)


def _grads(model):
    """The module's gradient in the JAX package's flattening order."""
    out = []
    for var, ell in zip(model.raw_variances, model.raw_lengthscales):
        out += [float(ell.grad), float(var.grad)]
    return out + [float(model.raw_noise_variance.grad)]


# ---------------------------------------------------------------------------
# statistics, loss, gradient, predictions, fit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", CASES)
def test_additive_stats_match_jax(case):
    """The statistics against those the JAX model built from the same data."""
    X, y = field(N, len(CASES[case][0]), 0)
    got = compute_additive_stats(_bases(case, BSplineBasis), torch.from_numpy(X),
                                 torch.from_numpy(y))
    want = _jax_model(case).stats
    for name in ("kuf_y", "kufkfu", "yty", "n"):
        assert rel(getattr(got, name), getattr(want, name)) <= 1e-12, name
    # symmetric, and a second build gives the same bits
    assert torch.equal(got.kufkfu, got.kufkfu.T)
    again = compute_additive_stats(_bases(case, BSplineBasis), torch.from_numpy(X),
                                   torch.from_numpy(y))
    assert torch.equal(again.kufkfu, got.kufkfu) and torch.equal(again.kuf_y, got.kuf_y)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("moved", [False, True], ids=["init", "moved"])
def test_elbo_and_gradient_match_jax(case, moved):
    """The module's loss and ``backward()`` against ``jax.value_and_grad``.
    A step runs the plain K9, K10, K11 and K12 once per dimension, and on
    the block route K16's plain version once per block column."""
    model = _model(case)
    D = model.D
    params = moved_params(D) if moved else _jax_model(case).init_params()
    value, grad = _jax_loss(case)(_jax_tree(params))
    if not moved:
        for g, w in zip(jax.tree.leaves(jax.tree.map(float, model.params())),
                        jax.tree.leaves(jax.tree.map(float, params)), strict=True):
            assert abs(g - w) <= 1e-15 * abs(w)
    model.load_jax_params(params)
    core.reset_counters()
    loss = model.training_loss()
    loss.backward()
    nb = -(-sum(b.m for b in model.bases) // 128) if case == "block" else 0
    assert core.PLAIN_CALLS == {"cpu": 4 * D + nb, "cuda": 0}
    assert abs(float(loss.detach()) - float(value)) <= TOL * abs(float(value))
    # relative to the largest component: at the moved parameters one
    # component (-0.156 beside 55) is a difference of large terms
    want = [float(g) for g in jax.tree.leaves(grad)]
    assert len(want) == 2 * D + 1 and rel(_grads(model), want) <= TOL
    assert float(model.maximum_log_likelihood_objective().detach()) == -float(loss.detach())


@pytest.mark.parametrize("case", CASES)
def test_predictions_match_jax(case):
    model, jmodel = _model(case), _jax_model(case)
    D = model.D
    params = moved_params(D)
    model.load_jax_params(params)
    jparams = _jax_tree(params)
    Xt, yt = field(60, D, 2)
    core.reset_counters()
    post = model.posterior()
    assert isinstance(post, PosteriorAdditive)
    nb = 2 if case == "block" else 0
    assert core.PLAIN_CALLS == {"cpu": 2 * D + nb, "cuda": 0}
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
    mb, vb = post.predict_f(Xt, batch=25)
    assert rel(mb, mean.numpy()) <= 1e-14 and rel(vb, var.numpy()) <= 1e-14


def test_fit_lbfgs_matches_jax():
    model, jmodel = _model("dense"), _jax_model("dense")
    jinfo, info = {}, {}
    jp, jloss, jiters = jfit_lbfgs(jax.jit(jmodel.training_loss), jmodel.init_params(),
                                   max_iters=5, curv_rtol=10.0, info=jinfo)
    params, loss, iters = fit_lbfgs(model.training_loss, model.params(), max_iters=5,
                                    curv_rtol=10.0, info=info)
    assert iters == int(jiters) == 5 and info["ls_evals"] == jinfo["ls_evals"]
    assert abs(loss - float(jloss)) <= 1e-8 * abs(float(jloss))
    assert isinstance(params["kernels"], list) and len(params["kernels"]) == 3
    for got, want in zip(jax.tree.leaves(jax.tree.map(float, params)),
                         jax.tree.leaves(jax.tree.map(float, jp))):
        assert abs(got - want) <= 1e-6 * abs(want)
    model.load_jax_params(params)
    assert abs(float(model.training_loss().detach()) - loss) <= 1e-12 * abs(loss)


# ---------------------------------------------------------------------------
# the block route for P at full bandwidth
# ---------------------------------------------------------------------------


def test_block_route_matches_jax():
    """tests/test_additive.py's M = 300 case (padded to 384 = 3 blocks of
    128), the port's block route against the JAX package's: log|P| and
    L⁻¹b, P⁻¹b and the dense P⁻¹, and the symmetrized gradient in P of an
    ELBO-shaped composite (both routes read only P's lower triangle)."""
    rng = np.random.RandomState(3)
    M = 300
    A = rng.randn(M, M) / np.sqrt(M)
    P0 = A @ A.T + np.eye(M)
    rhs0 = rng.randn(M)

    def f_block(p):
        jld, jc = jlogdet_halfsolve_block(p, jnp.asarray(rhs0))
        return -0.5 * jld + 0.5 * jnp.sum(jnp.square(jc)), (jld, jc)

    (_, (jld, jc)), jg = jax.jit(jax.value_and_grad(f_block, has_aux=True))(jnp.asarray(P0))
    jw, jpinv = jax.jit(jsolve_and_inverse_block)(jnp.asarray(P0), jnp.asarray(rhs0))

    P = torch.from_numpy(P0).requires_grad_(True)
    rhs = torch.from_numpy(rhs0)
    core.reset_counters()
    ld, c = _logdet_halfsolve_block(P, rhs)
    assert core.PLAIN_CALLS["cpu"] == 3
    assert abs(float(ld.detach()) - float(jld)) <= 1e-11 * abs(float(jld))
    np.testing.assert_allclose(c.detach().numpy(), np.asarray(jc), rtol=1e-9, atol=1e-11)
    (-0.5 * ld + 0.5 * torch.sum(torch.square(c))).backward()
    g, jg = P.grad.numpy(), np.asarray(jg)
    np.testing.assert_allclose(g + g.T, jg + jg.T, rtol=1e-7, atol=1e-10)

    with torch.no_grad():
        w, pinv = _solve_and_inverse_block(P, rhs)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(pinv.numpy(), np.asarray(jpinv), rtol=1e-7, atol=1e-9)


# ---------------------------------------------------------------------------
# validation, layout helpers, the objective's other name
# ---------------------------------------------------------------------------


def test_validation_errors():
    X, y = field(50, 2, 3)
    bases = _bases("block", BSplineBasis)
    kernels = _kernels("block", KERNELS)
    with pytest.raises(ValueError, match="one kernel and one basis"):
        GPRAdditive((X, y), kernels[:1], bases, device="cpu")
    with pytest.raises(ValueError, match="one kernel and one basis"):
        GPRAdditive((X[:, 0], y), kernels, bases, device="cpu")
    with pytest.raises(ValueError, match="strictly inside"):
        GPRAdditive((X * 1.1, y), kernels, bases, device="cpu")
    with pytest.raises(ValueError, match="order"):
        GPRAdditive((X, y), [Matern52(), Matern32()], [BSplineBasis(0.0, 1.0, 10, 2)] * 2,
                    device="cpu")
    with pytest.raises(ValueError, match="same number"):
        GPRAdditive((X, y[:-1]), kernels, bases, device="cpu")
    model = GPRAdditive((X, y), kernels, bases, device="cpu")
    with pytest.raises(NotImplementedError):
        model.predict_f(X, full_cov=True)
    with pytest.raises(ValueError):
        model.load_jax_params({"kernels": moved_params(1)["kernels"],
                               "likelihood": {"raw_variance": 0.0}})


def test_default_device_is_the_card():
    X, y = field(50, 2, 4)
    bases, kernels = _bases("block", BSplineBasis), _kernels("block", KERNELS)
    if torch.cuda.is_available():
        model = GPRAdditive((X, y), kernels, bases)
        assert model.kufkfu.is_cuda and model.raw_noise_variance.is_cuda
        return
    with pytest.raises(RuntimeError, match='device="cpu"'):
        GPRAdditive((X, y), kernels, bases)


@pytest.mark.parametrize("shape", [(0, 0), (2, 0), (0, 3), (2, 1), (6, 6), (3, 8)],
                         ids=lambda s: f"l{s[0]}u{s[1]}")
def test_layout_helpers_match_jax(shape):
    l, u = shape
    dense = np.random.RandomState(l + 10 * u).randn(7, 7)
    band = layout.dense_to_band(torch.from_numpy(dense), l, u)
    assert np.array_equal(band.numpy(), np.asarray(jlayout.dense_to_band(jnp.asarray(dense), l, u)))
    assert np.array_equal(layout.dense_to_lower_band(torch.from_numpy(dense), l).numpy(),
                          np.asarray(jlayout.dense_to_lower_band(jnp.asarray(dense), l)))
    sym = dense + dense.T
    full = layout.dense_to_band(torch.from_numpy(sym), l, u)
    assert np.array_equal(layout.lower_band_of_symmetric(full, l, u).numpy(),
                          np.asarray(jlayout.lower_band_of_symmetric(
                              jlayout.dense_to_band(jnp.asarray(sym), l, u), l, u)))


def _objective_models():
    rng = np.random.RandomState(6)
    x = rng.uniform(0.05, 0.95, (40, 2))
    y = np.sin(6 * x[:, :1]) + 0.1 * rng.randn(40, 1)
    return {
        "GPR1D": lambda: GPR1D((x[:, :1], y), Matern32(), B3Spline(0.0, 1.0, 20), device="cpu"),
        "ExactGPR": lambda: ExactGPR((x[:, :1], y), Matern32(), device="cpu"),
        "GPRKron": lambda: GPRKron((x, y), [Matern32(lengthscales=0.3)] * 2,
                                   [BSplineBasis(0.0, 1.0, 8, 3)] * 2, device="cpu"),
    }


@pytest.mark.parametrize("name", ["GPR1D", "ExactGPR", "GPRKron"])
def test_maximum_log_likelihood_objective(name):
    """The JAX package's name for the objective that training maximises:
    the ELBO (the exact GP's log marginal likelihood), -training_loss."""
    model = _objective_models()[name]()
    got = model.maximum_log_likelihood_objective()
    want = model.log_marginal_likelihood() if name == "ExactGPR" else model.elbo()
    assert float(got.detach()) == float(want.detach()) == -float(model.training_loss().detach())


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
    """A step on the card launches K9, K10, K11 and K12 once per dimension
    and, on the block route, K16 once per block column; loss, gradient and
    predictions agree with the plain versions on the CPU."""
    cpu, gpu = _model(case), _model(case, device=cuda_device)
    for model in (cpu, gpu):
        model.load_jax_params(moved_params(model.D))
    core.reset_counters()
    g_loss = gpu.training_loss()
    g_loss.backward()
    torch.cuda.synchronize()
    D = gpu.D
    want = {"chol_fwd": D, "chol_bwd": D, "tak_fwd": D, "tak_bwd": D}
    if case == "block":
        want["chol_inv_dense"] = 2
    assert {k: v for k, v in core.LAUNCHES.items() if v} == want
    assert core.PLAIN_CALLS["cuda"] == 0
    c_loss = cpu.training_loss()
    c_loss.backward()
    assert abs(float(g_loss) - float(c_loss)) <= 1e-12 * abs(float(c_loss))
    assert rel(_grads(gpu), _grads(cpu)) <= 1e-10
    core.reset_counters()
    post = gpu.posterior()
    torch.cuda.synchronize()
    want = {"chol_fwd": D, "tak_fwd": D} | ({"chol_inv_dense": 2} if case == "block" else {})
    assert {k: v for k, v in core.LAUNCHES.items() if v} == want
    Xt, _ = field(100, D, 5)
    gm, gv = post.predict_f(Xt, batch=30)
    cm, cv = cpu.predict_f(Xt)
    assert rel(gm, cm.numpy()) <= 1e-10 and rel(gv, cv.numpy()) <= 1e-10
