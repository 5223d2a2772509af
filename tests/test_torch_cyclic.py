"""Block cyclic reduction (banded/cyclic.py), its dispatch (``cr_scope``)
and ``GPR1D(..., backend="cr")``.

The JAX package's cyclic reduction compiles slowly on the CPU (seconds a
shape), so the port's is held to it directly only at (m, k) = (13, 1) and
(40, 2): log-det and solve to 1e-12 relative, the inverse band to 1e-11
relative to its largest entry.  Elsewhere it is held to the port's plain
recursions (``ops.*_plain``), which the other test files hold to the JAX
package, at the bars that the JAX package's own test holds its cyclic
reduction to against its scans (tests/test_cyclic.py): log-det 1e-12,
solve 1e-11, inverse band 1e-10.  The collapsed core's four scalars and
the gradient of their weighted sum in all four inputs (second order
through ``cr_trace``, by double backward) are held to autograd through the
plain recursions at m = 120, k = 3, that JAX test's shape and bars: values
1e-11, gradients 1e-7 relative and 1e-9 absolute.

The CR model at m = 32, N = 500 is held to the port's default route (loss
1e-10, gradient 1e-9, predictions 1e-10 of the largest value, a
10-iteration fit 1e-8 in as many iterations) and its loss to the JAX
GPR1D on its default route (1e-10); the float32 CR model's loss lies
within 1e-3 (relative) of the float64 one's.  The card's checks are in
tests/test_torch_cuda_cyclic.py, which imports no JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asvgp_tpu.banded import cyclic as jcyclic
from asvgp_tpu.basis import B3Spline as JB3Spline
from asvgp_tpu.models import GPR1D as JGPR1D
from asvgp_tpu.models import Matern32 as JMatern32
from asvgp_tpu_torch import banded
from asvgp_tpu_torch.banded import core, cyclic, ops
from asvgp_tpu_torch.banded.layout import dense_to_lower_band, lower_band_to_dense
from asvgp_tpu_torch.banded.tan import band_weights
from asvgp_tpu_torch.basis import B3Spline
from asvgp_tpu_torch.models import GPR1D, Matern32
from asvgp_tpu_torch.train import fit_lbfgs

N_MODEL, M_MODEL = 500, 32
COEF = (0.7, -1.3, 0.11, 0.37)


def spd_band(m, k, seed, diag=2.0):
    """A numpy-seeded SPD lower band (k+1, m): L Lᵀ of a random banded L."""
    rng = np.random.RandomState(seed)
    l0 = 0.3 * rng.randn(k + 1, m)
    l0[0] = diag + rng.rand(m)
    for j in range(1, k + 1):
        l0[j, m - j:] = 0.0
    L = lower_band_to_dense(torch.from_numpy(l0))
    return dense_to_lower_band(L @ L.T, k)


def rhs(m, seed):
    return torch.from_numpy(np.random.RandomState(seed).randn(m))


def rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def plain(band, b):
    """(log|A|, A⁻¹b, band(A⁻¹)) from the plain recursions."""
    l = ops.cholesky_band_plain(band)
    x = ops.solve_upper_band_transpose_plain(l, ops.solve_lower_band_plain(l, b))
    return ops.log_det_from_cholesky(l), x, ops.takahashi_inverse_band_plain(l)


@pytest.mark.parametrize("m,k", [(13, 1), (40, 2)])
def test_cr_matches_jax(m, k):
    a, b = spd_band(m, k, m * 7 + k), rhs(m, m + k)
    ja, jb = jnp.asarray(a.numpy()), jnp.asarray(b.numpy())
    jld, jx = jcyclic.cr_logdet_solve(ja, jb)
    jinv = jcyclic.cr_inverse_band(ja)
    ld, x = cyclic.cr_logdet_solve(a, b)
    assert rel(ld, jld) <= 1e-12 and rel(cyclic.cr_logdet(a), jld) <= 1e-12
    assert rel(x, jx) <= 1e-12 and rel(cyclic.cr_solve(a, b), jx) <= 1e-12
    assert rel(cyclic.cr_inverse_band(a), jinv) <= 1e-11


@pytest.mark.parametrize("m,k", [(129, 3), (64, 5), (96, 3), (1000, 6), (50, 0)],
                         ids=["129x3", "64x5", "96x3-unpadded", "1000x6-padded", "50x0"])
def test_cr_matches_plain(m, k):
    """Against the plain recursions; 96/3 = 32 blocks need no padding, the
    others pad to the next power of two with identity blocks."""
    a, b = spd_band(m, k, m + 11 * k), rhs(m, m)
    pld, px, pinv = plain(a, b)
    ld, x = cyclic.cr_logdet_solve(a, b)
    assert rel(ld, pld) <= 1e-12 and rel(cyclic.cr_logdet(a), pld) <= 1e-12
    assert rel(x, px) <= 1e-11 and rel(cyclic.cr_solve(a, b), px) <= 1e-11
    inv = cyclic.cr_inverse_band(a)
    assert inv.shape == (k + 1, m) and rel(inv, pinv) <= 1e-10
    with torch.no_grad():
        assert rel(cyclic.cr_inverse_band(a), pinv) <= 1e-10


def test_cr_float32_runs():
    """Dtype-generic, as the JAX functions are; float32 is held to no bar
    beyond float32 rounding of a well-conditioned band."""
    a, b = spd_band(129, 3, 5), rhs(129, 6)
    ld, x = cyclic.cr_logdet_solve(a.float(), b.float())
    assert ld.dtype == x.dtype == torch.float32
    pld, px, _ = plain(a, b)
    assert rel(ld, pld) <= 1e-5 and rel(x, px) <= 1e-4


def test_cr_collapsed_core_matches_plain():
    """The four scalars the CR way (``collapsed_core`` inside ``cr_scope``)
    and the gradient of their weighted sum in all four inputs, second order
    through ``cr_trace``, against autograd through the plain recursions."""
    m, k = 120, 3
    inputs = (spd_band(m, k, 1), spd_band(m, k, 2, diag=4.0), rhs(m, 3),
              spd_band(m, k, 4, diag=3.0))

    def cr_loss(kuu, p, b, big):
        with banded.cr_scope(True):
            out = ops.collapsed_core(kuu, p, b, big)
        return out, sum(c * o for c, o in zip(COEF, out))

    def plain_loss(kuu, p, b, big):
        l_kuu, l_p = ops.cholesky_band_plain(kuu), ops.cholesky_band_plain(p)
        s_kuu = ops.takahashi_inverse_band_plain(l_kuu)
        u = ops.solve_upper_band_transpose_plain(l_p, ops.solve_lower_band_plain(l_p, b))
        out = (ops.log_det_from_cholesky(l_kuu), ops.log_det_from_cholesky(l_p),
               torch.dot(b, u), torch.sum(band_weights(k, m, kuu) * s_kuu * big))
        return out, sum(c * o for c, o in zip(COEF, out))

    core.reset_counters()
    x_cr = [t.clone().requires_grad_() for t in inputs]
    out_cr, loss_cr = cr_loss(*x_cr)
    g_cr = torch.autograd.grad(loss_cr, x_cr)
    x_pl = [t.clone().requires_grad_() for t in inputs]
    out_pl, loss_pl = plain_loss(*x_pl)
    g_pl = torch.autograd.grad(loss_pl, x_pl)
    for got, want in zip(out_cr, out_pl):
        assert rel(got.detach(), want.detach()) <= 1e-11
    for got, want, name in zip(g_cr, g_pl, ("kuu", "p", "b", "big")):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-7, atol=1e-9,
                                   err_msg=name)
    # cyclic reduction runs no plain recursion and launches no kernel
    assert not any(core.LAUNCHES.values()) and not any(core.PLAIN_CALLS.values())


def test_cr_non_spd_gives_nan_in_both_packages():
    a = spd_band(13, 1, 0)
    a[0, 5] = -5.0
    assert np.isnan(float(jcyclic.cr_logdet(jnp.asarray(a.numpy()))))
    assert torch.isnan(cyclic.cr_logdet(a))
    assert torch.isnan(cyclic.cr_solve(a, rhs(13, 1))).all()
    assert torch.isnan(cyclic.cr_inverse_band(a)).any()


def test_cr_scope_dispatch():
    """``cr_scope`` nests, ``None`` is a no-op, and inside it
    ``collapsed_core_matern`` and ``banded_posterior`` take cyclic
    reduction (no plain recursion runs) and agree with their default
    route."""
    from asvgp_tpu_torch.features.spline_features import make_kuu

    basis = B3Spline(0.0, 1.0, 40)
    var = torch.tensor(1.3, dtype=torch.float64, requires_grad=True)
    ell = torch.tensor(0.2, dtype=torch.float64, requires_grad=True)

    def kuu_fn(v, l):
        return make_kuu(Matern32(v, l), basis)

    kuu = kuu_fn(var, ell).detach()
    big = spd_band(40, 3, 8)
    p = kuu + big / 0.1
    b = rhs(40, 9)
    assert not ops._cr_enabled()
    with banded.cr_scope(True):
        with banded.cr_scope(None):
            assert ops._cr_enabled()
        with banded.cr_scope(False):
            assert not ops._cr_enabled()
        core.reset_counters()
        got = ops.collapsed_core_matern(kuu_fn, var, ell, p, b, big)
        post = ops.banded_posterior(kuu, p, b)
        assert not any(core.PLAIN_CALLS.values())
    assert not ops._cr_enabled()
    want = ops.collapsed_core_matern(kuu_fn, var, ell, p, b, big)
    want_post = ops.banded_posterior(kuu, p, b)
    assert all(rel(g.detach(), w.detach()) <= 1e-11 for g, w in zip(got, want))
    assert all(rel(g, w) <= 1e-10 for g, w in zip(post, want_post))


# ---------------------------------------------------------------------------
# GPR1D(..., backend="cr")
# ---------------------------------------------------------------------------


def model_data():
    rng = np.random.RandomState(0)
    x = rng.uniform(0.01, 0.99, N_MODEL)
    y = np.sin(12.0 * x) + 0.3 * rng.randn(N_MODEL)
    return x, y


def make(backend=None, dtype=None):
    x, y = model_data()
    return GPR1D((x, y), Matern32(lengthscales=0.2), B3Spline(0.0, 1.0, M_MODEL),
                 noise_variance=0.1, device="cpu", backend=backend, dtype=dtype)


@pytest.fixture(scope="module")
def models():
    return {"default": make(), "cr": make("cr")}


def value_and_grad(model):
    model.zero_grad(set_to_none=True)
    loss = model.training_loss()
    loss.backward()
    return float(loss.detach()), [float(p.grad) for p in
                                  (model.raw_lengthscales, model.raw_variance,
                                   model.raw_noise_variance)]


def test_cr_model_matches_default_route(models):
    core.reset_counters()
    loss, grad = value_and_grad(models["cr"])
    assert not any(core.PLAIN_CALLS.values())  # no plain recursion on the CR route
    want_loss, want_grad = value_and_grad(models["default"])
    assert abs(loss - want_loss) <= 1e-10 * abs(want_loss)
    for g, w in zip(grad, want_grad):
        assert abs(g - w) <= 1e-9 * abs(w)
    xt = np.linspace(0.02, 0.98, 57)
    for got, want in zip(models["cr"].predict_f(xt), models["default"].predict_f(xt)):
        assert rel(got, want) <= 1e-10


def test_cr_model_fit_matches_default_route(models):
    runs = {}
    for name, model in models.items():
        info = {}
        params, loss, iters = fit_lbfgs(model.training_loss, model.params(), max_iters=10,
                                        info=info)
        runs[name] = (loss, iters, info["ls_evals"])
    (loss, iters, _), (want, want_iters, _) = runs["cr"], runs["default"]
    assert iters == want_iters == 10
    assert abs(loss - want) <= 1e-8 * abs(want)


def test_cr_model_loss_matches_jax(models):
    x, y = model_data()
    jmodel = JGPR1D((jnp.asarray(x), jnp.asarray(y)), JMatern32(lengthscales=0.2),
                    JB3Spline(0.0, 1.0, M_MODEL), noise_variance=0.1)
    params = jmodel.init_params()
    want = float(jax.jit(jmodel.training_loss)(params))
    model = models["cr"]
    model.load_jax_params(jax.tree.map(np.asarray, params))
    with torch.no_grad():
        got = float(model.training_loss())
    assert abs(got - want) <= 1e-10 * abs(want)


@pytest.mark.parametrize("backend", ["nope", "scan", "pallas_ds"])
def test_backend_names(backend):
    """The port takes None and "cr"; the JAX package's TPU selections and
    unknown names raise, as the JAX package raises on an unknown one."""
    with pytest.raises(ValueError, match="picks its route by device"):
        make(backend)


def test_cr_model_float32(models):
    m32 = make("cr", torch.float32)
    loss32 = m32.training_loss()
    loss32.backward()
    assert loss32.dtype == m32.raw_lengthscales.grad.dtype == torch.float32
    with torch.no_grad():
        want = float(make("cr").training_loss())
    assert abs(float(loss32.detach()) - want) <= 1e-3 * abs(want)
