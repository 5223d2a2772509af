"""GPRKron at D ≥ 3 in the port (stats/kron_nd.py, models/kron.py) against
the JAX package's GPRKron on the CPU in float64, and at D = 4 against a
dense numpy oracle.

Same numpy data from a seed (tests/test_kron_nd.py's shapes: 150 points in
three dimensions on three different domains), m = (7, 6, 6) at orders
(2, 2, 2) and m = (10, 9, 8) at orders (3, 3, 3); the parameters carried
across with ``load_jax_params``.  The statistics must agree to 1e-12
relative; the ELBO and its gradient in the raw parameters with
``jax.value_and_grad`` to 1e-10; at orders 2 the posterior's predict_f,
predict_y and predict_log_density to 1e-10 of the largest value and
``fit_lbfgs`` over 6 iterations in the same iteration and evaluation
counts, its loss to 1e-8 (tests/test_torch_kron.py's bars).  At orders 3
the JAX package's statistics are built op by op and its collapsed ELBO
takes them as an argument: its jitted statistics build alone compiles for
longer than this file runs.  The D = 4 case (m ≤ 5 a dimension)
holds the generic-D indexing to the dense Kronecker products, np.kron of
the dense Kuu_d and the Khatri-Rao product of the dense Kuf_d, without
another JAX compile.  The port runs the plain versions of K9–K12 and K16
here; the ``cuda``-marked test runs the kernels and skips without a card.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asvgp_tpu.basis import BSplineBasis as JBasis
from asvgp_tpu.models import Matern12 as JMatern12
from asvgp_tpu.models import Matern32 as JMatern32
from asvgp_tpu.models.kron import GPRKron as JGPRKron
from asvgp_tpu.models.kron import kron_collapsed_elbo
from asvgp_tpu.stats.kron_nd import compute_kron_stats_nd
from asvgp_tpu.train import fit_lbfgs as jfit_lbfgs
from asvgp_tpu_torch import banded
from asvgp_tpu_torch.banded import core
from asvgp_tpu_torch.basis import BSplineBasis
from asvgp_tpu_torch.features.spline_features import kuf_to_dense, make_kuu
from asvgp_tpu_torch.models import GPRKron, Matern12, Matern32
from asvgp_tpu_torch.train import fit_lbfgs

N = 150
DOMAINS = ((0.0, 1.0), (-1.0, 1.2), (0.1, 0.8))
CASES = {"o222": ((2, 2, 2), (7, 6, 6)), "o333": ((3, 3, 3), (10, 9, 8))}
# the cases held against a JAX GPRKron (predictions, fit, bandwidth); the
# others against the JAX package's statistics and collapsed ELBO
JAX_MODEL_CASES = ("o222",)
# (ℓ, variance) per dimension; the middle one Matérn-1/2
KERNELS = ((0.7, 0.9), (1.2, 0.5), (0.4, 0.8))
TOL = 1e-10


def make_data(n, seed):
    """tests/test_kron_nd.py's field: three dimensions on DOMAINS."""
    rng = np.random.RandomState(seed)
    X = rng.uniform(0.05, 0.95, (n, 3))
    X[:, 1] = X[:, 1] * 2.0 - 0.9
    X[:, 2] = X[:, 2] * 0.5 + 0.2
    y = np.sin(5 * X[:, 0]) * np.cos(3 * X[:, 1]) * (1 + X[:, 2]) + 0.1 * rng.randn(n)
    return X, y.reshape(-1, 1)


def rel(got, want):
    got = np.asarray(got.detach().cpu() if isinstance(got, torch.Tensor) else got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _bases(case, pkg):
    orders, ms = CASES[case]
    return [pkg(a, b, m, o) for (a, b), m, o in zip(DOMAINS, ms, orders)]


def _kernels(m32, m12):
    return [m32(*KERNELS[0]), m12(*KERNELS[1]), m32(*KERNELS[2])]


def _model(case, device="cpu"):
    """The port's GPRKron of a case at its initial parameters."""
    X, y = make_data(N, 0)
    return GPRKron((X, y), _kernels(Matern32, Matern12), _bases(case, BSplineBasis),
                   noise_variance=0.2, device=device)


@functools.cache
def _jax_model(case):
    """The JAX package's GPRKron of a case, built once per run so that its
    compiled loss and posterior are reused; it holds no parameters."""
    X, y = make_data(N, 0)
    return JGPRKron((jnp.asarray(X), jnp.asarray(y)), _kernels(JMatern32, JMatern12),
                    _bases(case, JBasis), noise_variance=0.2)


@functools.cache
def _jax_stats(case):
    """The JAX package's statistics of a case: its GPRKron's where the
    tests build one (predictions, fit), else op by op, which at order 3 is
    a fraction of the jitted build's compile."""
    if case in JAX_MODEL_CASES:
        return _jax_model(case).stats
    X, y = make_data(N, 0)
    with jax.disable_jit():
        return compute_kron_stats_nd(_bases(case, JBasis), jnp.asarray(X), jnp.asarray(y[:, 0]))


def moved_params():
    return {"kernels": [{"raw_lengthscales": np.float64(-0.6), "raw_variance": np.float64(0.4)},
                        {"raw_lengthscales": np.float64(0.3), "raw_variance": np.float64(-0.2)},
                        {"raw_lengthscales": np.float64(-1.1), "raw_variance": np.float64(0.1)}],
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
    """The jitted value and gradient of a case's JAX training loss, the
    statistics an argument."""
    nu2s = [k.nu2 for k in _kernels(JMatern32, JMatern12)]
    bases = _bases(case, JBasis)
    return jax.jit(jax.value_and_grad(lambda p, s: -kron_collapsed_elbo(bases, nu2s, p, s)))


@pytest.mark.parametrize("case", CASES)
def test_kron_nd_stats_match_jax(case):
    got, want = _model(case).stats, _jax_stats(case)
    assert got.t_band.shape == want.t_band.shape
    for name in ("kuf_y", "t_band", "yty", "n"):
        assert rel(getattr(got, name), getattr(want, name)) <= 1e-12, name


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("moved", [False, True], ids=["init", "moved"])
def test_kron_nd_elbo_and_gradient_match_jax(case, moved):
    """The module's loss and ``backward()`` against ``jax.value_and_grad``;
    a step runs the plain K9 and K11 once per dimension forward, K10 and K12
    once per dimension backward, and K16 once per block column (m₁)."""
    model = _model(case)
    params = moved_params() if moved else model.init_params()
    value, grad = _jax_loss(case)(_jax_tree(params), _jax_stats(case))
    model.load_jax_params(params)
    core.reset_counters()
    loss = model.training_loss()
    loss.backward()
    assert core.PLAIN_CALLS == {"cpu": 4 * 3 + model.bases[0].m, "cuda": 0}
    assert abs(float(loss.detach()) - float(value)) <= TOL * abs(float(value))
    for got, want in zip(_grads(model), jax.tree.leaves(grad), strict=True):
        assert abs(got - float(want)) <= TOL * abs(float(want))


@pytest.mark.parametrize("case", JAX_MODEL_CASES)
def test_kron_nd_predictions_match_jax(case):
    model, jmodel = _model(case), _jax_model(case)
    params = moved_params()
    model.load_jax_params(params)
    jparams = _jax_tree(params)
    Xt, yt = make_data(60, 2)
    post = model.posterior()
    mean, var = post.predict_f(Xt)
    jmean, jvar = jmodel.predict_f(jparams, jnp.asarray(Xt))
    assert rel(mean, jmean) <= TOL and rel(var, jvar) <= TOL
    assert bool((var > 0).all())
    _, vy = post.predict_y(Xt)
    _, jvy = jmodel.predict_y(jparams, jnp.asarray(Xt))
    assert rel(vy, jvy) <= TOL
    ld = post.predict_log_density((Xt, yt))
    jld = jmodel.predict_log_density(jparams, (jnp.asarray(Xt), jnp.asarray(yt)))
    assert rel(ld, jld) <= TOL
    # in batches, the last one padded: the same values
    mb, vb = post.predict_f(Xt, batch=25)
    assert rel(mb, mean.numpy()) <= 1e-14 and rel(vb, var.numpy()) <= 1e-14


def test_kron_nd_fit_lbfgs_matches_jax():
    model, jmodel = _model("o222"), _jax_model("o222")
    jinfo, info = {}, {}
    jp, jloss, jiters = jfit_lbfgs(jax.jit(jmodel.training_loss), jmodel.init_params(),
                                   max_iters=6, curv_rtol=10.0, info=jinfo)
    params, loss, iters = fit_lbfgs(model.training_loss, model.params(), max_iters=6,
                                    curv_rtol=10.0, info=info)
    assert iters == int(jiters) == 6 and info["ls_evals"] == jinfo["ls_evals"]
    assert abs(loss - float(jloss)) <= 1e-8 * abs(float(jloss))
    assert len(params["kernels"]) == 3
    for got, want in zip(jax.tree.leaves(jax.tree.map(float, params)),
                         jax.tree.leaves(jax.tree.map(float, jp))):
        assert abs(got - want) <= 1e-6 * abs(want)


@pytest.mark.parametrize("case", JAX_MODEL_CASES)
def test_kron_nd_bandwidth_matches_jax(case):
    assert _model(case).bandwidth == _jax_model(case).bandwidth
    orders, ms = CASES[case]
    assert _model(case).bandwidth == orders[0] * ms[1] * ms[2] + orders[1] * ms[2] + orders[2]


# ---------------------------------------------------------------------------
# D = 4 against the dense Kronecker products
# ---------------------------------------------------------------------------

D4_BASES = ((0.0, 1.0, 5, 1), (0.0, 1.0, 4, 1), (-1.0, 1.0, 5, 1), (0.0, 2.0, 4, 1))


def _d4_problem():
    rng = np.random.RandomState(11)
    lo = np.array([a for a, _, _, _ in D4_BASES])
    hi = np.array([b for _, b, _, _ in D4_BASES])
    X = lo + (hi - lo) * rng.uniform(0.03, 0.97, (120, 4))
    y = np.sin(3 * X[:, 0] + X[:, 1]) * np.cos(2 * X[:, 2]) + 0.2 * X[:, 3] + 0.1 * rng.randn(120)
    Xt = lo + (hi - lo) * rng.uniform(0.05, 0.95, (30, 4))
    bases = [BSplineBasis(*b) for b in D4_BASES]
    kernels = [Matern12(0.6, 0.8), Matern12(0.9, 1.1), Matern12(0.7, 0.6), Matern12(1.3, 0.9)]
    model = GPRKron((X, y[:, None]), kernels, bases, noise_variance=0.15, device="cpu")
    return model, X, y, Xt


def _dense(model, X):
    """np.kron of the dense Kuu_d, the Khatri-Rao product of the dense Kuf_d
    (row-major over the dimensions), and the kernels and likelihood."""
    with torch.no_grad():
        kernels, lik = model._build()
    kuu, kuf = np.ones((1, 1)), np.ones((1, X.shape[0]))
    for d, (k, b) in enumerate(zip(kernels, model.bases)):
        band = make_kuu(k, b).detach()
        kd = banded.band_to_dense(banded.symmetrise_lower_band(band), b.order, b.order).numpy()
        fd = kuf_to_dense(b, torch.from_numpy(X[:, d])).numpy()
        kuu = np.kron(kuu, kd)
        kuf = np.einsum("ip,jp->ijp", kuf, fd).reshape(-1, X.shape[0])
    return kernels, lik, kuu, kuf


def test_kron_d4_stats_and_elbo_match_dense_oracle():
    model, X, y, _ = _d4_problem()
    kernels, lik, kuu, kuf = _dense(model, X)
    ms = [b.m for b in model.bases]
    ks = [b.order for b in model.bases]
    s2 = float(lik.variance)
    kk = kuf @ kuf.T
    assert rel(model.kuf_y, kuf @ y) <= 1e-13
    # every entry of the multiband against the dense product
    tb = model.t_band.numpy()
    kk6 = kk.reshape(*ms, *ms)
    want = np.zeros_like(tb)
    for p in range(ks[0] + 1):
        for o in np.ndindex(*(2 * k + 1 for k in ks[1:])):
            off = [o[i] - ks[i + 1] for i in range(3)]
            for q in np.ndindex(*ms):
                i = (q[0] + p, *(q[d + 1] + off[d] for d in range(3)))
                if i[0] < ms[0] and all(0 <= i[d] < ms[d] for d in range(1, 4)):
                    want[(p, *o, *q)] = kk6[(*i, *q)]
    assert np.max(np.abs(tb - want)) <= 1e-13 * np.max(np.abs(want))
    p_dense = kuu + kk / s2
    lp = np.linalg.cholesky(p_dense)
    c = np.linalg.solve(lp, kuf @ y) / s2
    kdiag = math.prod(float(k.variance) for k in kernels)
    n = y.shape[0]
    elbo = (-0.5 * n * math.log(2 * math.pi * s2) - np.sum(np.log(np.diag(lp)))
            + 0.5 * np.linalg.slogdet(kuu)[1] - 0.5 * y @ y / s2 + 0.5 * c @ c
            - 0.5 * n * kdiag / s2 + 0.5 * np.trace(np.linalg.solve(kuu, kk)) / s2)
    got = float(model.elbo().detach())
    assert abs(got - elbo) <= 1e-10 * abs(elbo)


def test_kron_d4_predictions_match_dense_oracle():
    model, X, y, Xt = _d4_problem()
    kernels, lik, kuu, kuf = _dense(model, X)
    _, _, _, kus = _dense(model, Xt)
    s2 = float(lik.variance)
    p_dense = kuu + kuf @ kuf.T / s2
    w = np.linalg.solve(p_dense, kuf @ y) / s2
    kdiag = math.prod(float(k.variance) for k in kernels)
    var_want = (kdiag + np.sum(kus * np.linalg.solve(p_dense, kus), axis=0)
                - np.sum(kus * np.linalg.solve(kuu, kus), axis=0))
    mean, var = model.predict_f(Xt, batch=16)
    assert rel(mean[:, 0], kus.T @ w) <= 1e-10
    assert rel(var[:, 0], var_want) <= 1e-10
    assert model.bandwidth == 4 * 5 * 4 + 5 * 4 + 4 + 1


def test_kron_nd_validation_errors():
    X, y = make_data(40, 3)
    bases = _bases("o222", BSplineBasis)
    kernels = _kernels(Matern32, Matern12)
    with pytest.raises(ValueError, match="one kernel and one basis"):
        GPRKron((X, y), kernels[:2], bases, device="cpu")
    with pytest.raises(ValueError, match="strictly inside"):
        GPRKron((X * 1.5, y), kernels, bases, device="cpu")
    with pytest.raises(ValueError, match="order"):
        GPRKron((X, y), kernels, [BSplineBasis(0.0, 1.0, 7, 1)] + bases[1:], device="cpu")


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
def test_cuda_kron_nd_value_and_grad_match_cpu(cuda_device, case):
    cpu, gpu = _model(case), _model(case, device=cuda_device)
    for model in (cpu, gpu):
        model.load_jax_params(moved_params())
    core.reset_counters()
    g_loss = gpu.training_loss()
    g_loss.backward()
    torch.cuda.synchronize()
    want = {"chol_fwd": 3, "chol_bwd": 3, "tak_fwd": 3, "tak_bwd": 3,
            "chol_inv_dense": gpu.bases[0].m}
    assert {k: v for k, v in core.LAUNCHES.items() if v} == want
    assert core.PLAIN_CALLS["cuda"] == 0
    c_loss = cpu.training_loss()
    c_loss.backward()
    assert abs(float(g_loss) - float(c_loss)) <= 1e-12 * abs(float(c_loss))
    for got, ref in zip(_grads(gpu), _grads(cpu)):
        assert abs(got - ref) <= 1e-10 * abs(ref)
    Xt, _ = make_data(70, 5)
    gm, gv = gpu.predict_f(Xt, batch=30)
    cm, cv = cpu.predict_f(Xt)
    assert rel(gm, cm.numpy()) <= 1e-10 and rel(gv, cv.numpy()) <= 1e-10
