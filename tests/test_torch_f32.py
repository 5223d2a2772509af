"""The float32 route of the port: K17–K20 (the float32 forms of the
single-matrix Cholesky, Takahashi and their adjoints), the float32
dispatch of the public banded ops, and ``GPR1D(..., dtype=torch.float32)``
against the JAX package's float32 GPR1D.

Tolerances:

* K17–K20's plain versions in float32 against the JAX package's float32
  Pallas kernels (``pallas_kernels.py``) in interpret mode with TILE cut to
  4, on a well-conditioned random band: 1e-5 relative to the largest entry
  for the forward sweeps, 1e-4 for the adjoints (the two recursions round in
  other orders; the adjoints carry more terms per column).
* The float32 GPR1D (m = 64 B3 features, N = 2000, Matérn-3/2 with
  ℓ = 0.05, noise 0.1) against the JAX package's GPR1D with
  ``dtype=float32`` run under ``jax.enable_x64(False)`` on the scan route,
  on the same float32 statistics: ten times the JAX package's own spread
  between its two float32 routes at this configuration.  Measured (the
  scan against the Pallas route in interpret mode): loss 2.9e-6, gradient
  (ℓ, σ², noise) 1.3e-3, 5.0e-6, 5.7e-5, predictive mean 2.0e-7 and
  variance 9.9e-6 of the largest value.  So: loss 3e-5, each gradient
  component 1e-2 (the lengthscale's, a small difference of large trace
  terms, moves most), mean 2e-6, variance and NLPD 1e-4.  The port's route
  sat at 4.4e-6, (3.6e-3, 2.5e-5, 7.6e-5), 6.2e-7, 2.7e-5 and 8.7e-6.

The CUDA kernels have no CPU mode: their tests are marked ``cuda`` and skip
without a card; there K17–K20 are held to their plain versions at 1e-5
(forward) and 1e-4 (adjoints), and a float32 step and posterior to their
launch counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asvgp_tpu.banded import ops as jops
from asvgp_tpu.banded import pallas_ds as jpd
from asvgp_tpu.banded import pallas_ds_core as jpdc
from asvgp_tpu.banded import pallas_ds_pair as jpdp
from asvgp_tpu.banded import pallas_kernels as jpk
from asvgp_tpu.basis import B3Spline as JB3Spline
from asvgp_tpu.models import GPR1D as JGPR1D
from asvgp_tpu.models import Matern32 as JMatern32
from asvgp_tpu_torch import banded
from asvgp_tpu_torch.banded import core, ops, single, solve
from asvgp_tpu_torch.basis import B3Spline
from asvgp_tpu_torch.models import GPR1D, Matern32
from asvgp_tpu_torch.train import nlpd

F32_KEYS = ("chol_fwd_f32", "chol_bwd_f32", "tak_fwd_f32", "tak_bwd_f32",
            "solve_lower_f32", "solve_upper_t_f32")
# the launches of one float32 value-and-gradient step and of one posterior,
# as the JAX package's float32 route makes them
STEP = {"chol_fwd_f32": 2, "tak_fwd_f32": 1, "solve_lower_f32": 1,
        "chol_bwd_f32": 2, "tak_bwd_f32": 1, "solve_upper_t_f32": 1}
POSTERIOR = {"chol_fwd_f32": 2, "tak_fwd_f32": 2, "solve_lower_f32": 1, "solve_upper_t_f32": 1}
TOL_LOSS, TOL_GRAD, TOL_MEAN, TOL_VAR = 3e-5, 1e-2, 2e-6, 1e-4


def spd_band(k, m, rng):
    a = 0.3 * rng.randn(k + 1, m)
    a[0] = np.abs(a[0]) + 2.0 * k + 1.0
    for j in range(1, k + 1):
        a[j, m - j:] = 0.0
    return a


def rel(got, want):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want.detach() if isinstance(want, torch.Tensor) else want, np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def inputs32(k, m, seed):
    """(A, L, S, L̄, S̄) in float32: a random SPD band, its factor and
    Takahashi band (computed in float64, rounded once) and cotangents."""
    rng = np.random.RandomState(seed)
    a = torch.from_numpy(spd_band(k, m, rng))
    l = ops.cholesky_band_plain(a)
    s = ops.takahashi_inverse_band_plain(l)
    return tuple(t.float() for t in (a, l, s, torch.from_numpy(rng.randn(k + 1, m)),
                                     torch.from_numpy(rng.randn(k + 1, m))))


@pytest.fixture
def interpret_small_tile(monkeypatch):
    """Pallas interpret mode with 4-column tiles (the recursion is
    tile-agnostic; the full 128-column tile interprets for minutes)."""
    for mod in (jpk, jpd, jpdp, jpdc):
        monkeypatch.setattr(mod, "TILE", 4)
    jpk.set_interpret(True)
    yield
    jpk.set_interpret(False)


@pytest.mark.parametrize("k", [1, 3])
def test_f32_sweeps_match_jax_pallas_interpret(interpret_small_tile, k):
    """K17–K20's plain versions against ``cholesky_band_fwd_pallas``,
    ``cholesky_band_bwd_pallas``, ``takahashi_fwd_pallas`` and
    ``takahashi_bwd_pallas`` on a 3-tile band with a ragged last tile."""
    a, l, s, l_bar, s_bar = inputs32(k, 10, k)
    j = {name: jnp.asarray(t.numpy()) for name, t in
         (("a", a), ("l", l), ("s", s), ("l_bar", l_bar), ("s_bar", s_bar))}
    got = (single.chol_fwd(a), single.tak_fwd(l), single.chol_bwd(l, l_bar),
           single.tak_bwd(l, s, s_bar))
    assert all(g.dtype == torch.float32 for g in got)
    assert rel(got[0], jpk.cholesky_band_fwd_pallas(j["a"])) <= 1e-5
    assert rel(got[1], jpk.takahashi_fwd_pallas(j["l"])) <= 1e-5
    assert rel(got[2], jpk.cholesky_band_bwd_pallas(j["l"], j["l_bar"])) <= 1e-4
    assert rel(got[3], jpk.takahashi_bwd_pallas(j["l"], j["s"], j["s_bar"])) <= 1e-4


def data(n, seed):
    rng = np.random.RandomState(seed)
    x = rng.uniform(0.005, 0.995, n)
    return x, np.sin(20.0 * x) + 0.3 * rng.randn(n)


def test_f32_gpr1d_matches_jax_x64_off():
    """Loss, gradient, predictions and NLPD of the float32 GPR1D against
    the JAX package's float32 route (x64 off, scan), on the same float32
    statistics and parameters."""
    x, y = data(2000, 0)
    xt, yt = data(300, 1)
    kernel_args = dict(variance=1.0, lengthscales=0.05)
    model = GPR1D((x, y), Matern32(**kernel_args), B3Spline(0.0, 1.0, 64), noise_variance=0.1,
                  device="cpu", dtype=torch.float32)
    jmodel = JGPR1D((jnp.asarray(x), jnp.asarray(y)), JMatern32(**kernel_args),
                    JB3Spline(0.0, 1.0, 64), noise_variance=0.1, dtype=jnp.float32)
    for name in ("kuf_y", "kufkfu_band", "yty", "n"):
        assert getattr(model, name).dtype == torch.float32
        # both accumulate in float64 and round once
        assert rel(getattr(model, name), getattr(jmodel.stats, name)) <= 1e-7
    params = jmodel.init_params()
    model.load_jax_params(jax.tree.map(np.asarray, params))
    with jops.impl_scope("scan"), jax.enable_x64(False):
        p32 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float32), params)
        jloss, jgrad = jax.value_and_grad(jmodel.training_loss)(p32)
        jpost = jmodel.posterior(p32)
        jmean, jvar = jpost.predict_f(jnp.asarray(xt))
        jscore = -jnp.mean(jpost.predict_log_density((jnp.asarray(xt), jnp.asarray(yt))))
    assert jloss.dtype == jnp.float32

    loss = model.training_loss()
    loss.backward()
    assert loss.dtype == model.raw_lengthscales.grad.dtype == torch.float32
    assert rel(loss, jloss) <= TOL_LOSS
    for name, (g, k) in (("raw_lengthscales", ("kernel", "raw_lengthscales")),
                         ("raw_variance", ("kernel", "raw_variance")),
                         ("raw_noise_variance", ("likelihood", "raw_variance"))):
        assert rel(getattr(model, name).grad, jgrad[g][k]) <= TOL_GRAD, name
    post = model.posterior()
    mean, var = post.predict_f(xt, batch=128)
    assert mean.dtype == var.dtype == torch.float32 and mean.shape == (300, 1)
    assert rel(mean, jmean) <= TOL_MEAN and rel(var, jvar) <= TOL_VAR
    score = nlpd(post.predict_log_density((xt, yt)))
    assert score.dtype == torch.float32 and rel(score, jscore) <= TOL_VAR
    # the float64 model of the same data is float64 throughout
    assert GPR1D((x, y), Matern32(**kernel_args), B3Spline(0.0, 1.0, 64),
                 device="cpu").training_loss().dtype == torch.float64


def _spy(monkeypatch, calls):
    """Count the calls of every wrapper of a banded kernel by name."""
    for mod, names in ((single, ("chol_fwd", "chol_bwd", "tak_fwd", "tak_bwd", "chol_fwd_pair")),
                       (solve, ("solve_lower", "solve_upper_t")),
                       (core, ("chol_pair_solve", "tak_pair_solve", "tak_bwd_vec",
                               "chol_bwd_pair"))):
        for name in names:
            def spy(*args, _fn=getattr(mod, name), _name=name):
                calls[_name] = calls.get(_name, 0) + 1
                return _fn(*args)
            monkeypatch.setattr(mod, name, spy)


def test_dispatch_f32_composed_f64_unchanged(monkeypatch):
    """A float32 value-and-gradient step and posterior run the JAX
    package's composed route (the single-matrix ops and the solves, each
    wrapper as often as its kernel launches on the card); float64 keeps the
    fused sweeps and calls none of them."""
    x, y = data(500, 2)
    models = {dt: GPR1D((x, y), Matern32(1.0, 0.1), B3Spline(0.0, 1.0, 20), device="cpu",
                        dtype=dt) for dt in (torch.float32, torch.float64)}
    calls = {}
    _spy(monkeypatch, calls)
    models[torch.float32].training_loss().backward()
    assert calls == {name.removesuffix("_f32"): n for name, n in STEP.items()}
    calls.clear()
    models[torch.float32].posterior()
    assert calls == {name.removesuffix("_f32"): n for name, n in POSTERIOR.items()}
    calls.clear()
    models[torch.float64].training_loss().backward()
    models[torch.float64].posterior()
    assert calls == {"chol_pair_solve": 1, "tak_pair_solve": 1}
    # float64 parameters do not reach a float32 model (fit_lbfgs's)
    with pytest.raises(TypeError, match="its own dtype"):
        models[torch.float32].training_loss(models[torch.float64].params())
    with pytest.raises(ValueError, match="dtype"):
        GPR1D((x, y), Matern32(), B3Spline(0.0, 1.0, 20), device="cpu", dtype=torch.float16)


def test_f32_banded_ops_follow_the_dtype():
    """The public ops keep float32: the pair Cholesky is two Choleskys (no
    float32 form of K15), the collapsed core and the posterior agree with
    their float64 values to float32 rounding."""
    rng = np.random.RandomState(4)
    kuu, p, big = (torch.from_numpy(spd_band(2, 30, rng)) for _ in range(3))
    b = torch.from_numpy(rng.randn(30))
    want = ops.collapsed_core(kuu, p, b, big)
    got = ops.collapsed_core(*(t.float() for t in (kuu, p, b, big)))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and rel(g, w) <= 1e-5
    for g, w in zip(banded.banded_posterior(kuu.float(), p.float(), b.float()),
                    banded.banded_posterior(kuu, p, b)):
        assert g.dtype == torch.float32 and rel(g, w) <= 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA sweeps have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("k", range(1, 7))
def test_cuda_f32_kernels_match_plain(cuda_device, k):
    """K17–K20 on the card against their plain float32 versions on the
    CPU, each launched once under its own counter."""
    host = inputs32(k, 1000, k)
    a, l, s, l_bar, s_bar = (t.to(cuda_device) for t in host)
    core.reset_counters()
    got = (single.chol_fwd(a), single.tak_fwd(l), single.chol_bwd(l, l_bar),
           single.tak_bwd(l, s, s_bar))
    torch.cuda.synchronize()
    assert [core.LAUNCHES[key] for key in F32_KEYS[:4]] == [1, 1, 1, 1]
    assert all(core.LAUNCHES[key] == 0 for key in ("chol_fwd", "chol_bwd", "tak_fwd", "tak_bwd"))
    want = (single.chol_fwd_plain(host[0]), single.tak_fwd_plain(host[1]),
            single.chol_bwd_plain(host[1], host[3]), single.tak_bwd_plain(*host[1:3], host[4]))
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.is_cuda and g.dtype == torch.float32
        assert rel(g.cpu(), w) <= (1e-5 if i < 2 else 1e-4)


@pytest.mark.cuda
def test_cuda_f32_model_launches_its_route(cuda_device):
    """A float32 step and posterior on the card launch exactly the JAX
    package's float32 route; a float32 tensor never reaches a float64-only
    kernel."""
    x, y = data(5000, 3)
    model = GPR1D((x, y), Matern32(1.0, 0.05), B3Spline(0.0, 1.0, 200), noise_variance=0.1,
                  device=cuda_device, dtype=torch.float32)
    core.reset_counters()
    model.training_loss().backward()
    torch.cuda.synchronize()
    assert {k: v for k, v in core.LAUNCHES.items() if v} == STEP
    core.reset_counters()
    model.posterior()
    torch.cuda.synchronize()
    assert {k: v for k, v in core.LAUNCHES.items() if v} == POSTERIOR
    assert core.PLAIN_CALLS["cuda"] == 0
    kuu = model.kufkfu_band
    with pytest.raises(TypeError, match="float64"):
        core.chol_pair_solve(kuu, kuu, model.kuf_y)
    with pytest.raises(TypeError, match="float64"):
        single.chol_fwd_pair(kuu, kuu)
