"""The tangent-fused sweeps K3 + K4 (banded/tan.py) and the elementwise
backward of ``MaternCore``.

The plain versions are held to the JAX package's tangent kernels
(``pallas_ds_tan.factor_takahashi_solve_tan_ds``, run in Pallas interpret
mode with TILE cut to 4 as tests/test_twist_kernels.py does), to dense
float64 identities, and their tangents to ``torch.func.jvp`` of the plain
primal recursions.  Interpret mode runs the TPU kernels' double-single
arithmetic, which XLA:CPU rounds a little differently from the TPU; the
tolerances against it are that envelope (as in the JAX package's own
tests), the ones against float64 references a few ulps times κ.

The CUDA kernels have no CPU mode: their tests are marked ``cuda`` and skip
without a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asvgp_tpu.banded import pallas_ds as jpd
from asvgp_tpu.banded import pallas_ds_pair as jpdp
from asvgp_tpu.banded import pallas_ds_tan as jpdt
from asvgp_tpu.banded import pallas_kernels as jpk
from asvgp_tpu_torch.banded import core, layout, ops, tan

LAUNCH_KEYS = ("chol_pair_solve_tan", "tak_pair_solve_tan")


def spd_band(k, m, rng, diag=None):
    a = 0.3 * rng.randn(k + 1, m)
    a[0] = np.abs(a[0]) + (2.0 * k + 1.0 if diag is None else diag)
    for j in range(1, k + 1):
        a[j, m - j:] = 0.0
    return a


def sym_band(k, m, rng):
    """A random symmetric (not definite) band: a tangent direction."""
    a = rng.randn(k + 1, m)
    for j in range(1, k + 1):
        a[j, m - j:] = 0.0
    return a


def dense(band):
    k = band.shape[0] - 1
    return layout.band_to_dense(layout.symmetrise_lower_band(band), k, k)


def band_of(d, k):
    m = d.shape[0]
    return torch.stack([torch.cat([torch.diagonal(d, -j), d.new_zeros(j)]) for j in range(k + 1)])


def rel(got, want):
    got = torch.as_tensor(np.array(got))
    want = torch.as_tensor(np.array(want))
    assert got.shape == want.shape
    return float(torch.max(torch.abs(got - want)) / torch.max(torch.abs(want)))


def inputs(k, m, seed):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(a) for a in
            (spd_band(k, m, rng), 0.1 * sym_band(k, m, rng), spd_band(k, m, rng), rng.randn(m))]


@pytest.fixture
def interpret_small_tile(monkeypatch):
    """Pallas interpret mode with 4-column tiles (the recursion is
    tile-agnostic; the full 128-column tile interprets for minutes)."""
    for mod in (jpk, jpd, jpdp, jpdt):
        monkeypatch.setattr(mod, "TILE", 4)
    jpk.set_interpret(True)
    yield
    jpk.set_interpret(False)


def test_tan_sweeps_match_jax_interpret(interpret_small_tile):
    k, m = 2, 24
    kuu, tanb, p, b = inputs(k, m, 0)
    want = jpdt.factor_takahashi_solve_tan_ds(*(jnp.asarray(t.numpy()) for t in (kuu, tanb, p, b)))
    got = tan.factor_takahashi_solve_tan(kuu, tanb, p, b)
    names = ("l_kuu", "l_p", "s_kuu", "s_p", "c0", "u", "iv_kuu", "sdot_kuu")
    # the double-single envelope of interpret mode: on these inputs its u
    # is 3.4e-8 from a dense float64 solve (the port's: 1e-16), its bands
    # ~3e-10 (test_twist_kernels.py allows 3e-8 and 3e-9)
    tols = dict(l_kuu=1e-13, l_p=1e-13, s_kuu=3e-9, s_p=3e-9, c0=1e-13, u=1e-7,
                iv_kuu=1e-13, sdot_kuu=3e-9)
    for name, g, w in zip(names, got, want):
        assert rel(g, w) <= tols[name], name
    assert rel(got[5], torch.linalg.solve(dense(p), b)) <= 1e-12


@pytest.mark.parametrize("k", range(1, 7))
def test_tangents_match_jvp_and_dense(k):
    """The explicit tangent recursions against forward-mode AD through the
    plain primal recursions, and the sweeps against dense float64."""
    m = 30
    kuu, tanb, p, b = inputs(k, m, 10 + k)
    l_ref, ldot_ref = torch.func.jvp(ops.cholesky_band_plain, (kuu,), (tanb,))
    l, ldot = ops.cholesky_band_plain(kuu, tanb)
    assert rel(l, l_ref) == 0.0 and rel(ldot, ldot_ref) <= 1e-13
    s_ref, sdot_ref = torch.func.jvp(ops.takahashi_inverse_band_plain, (l,), (ldot,))
    s, sdot = ops.takahashi_inverse_band_plain(l, ldot)
    assert rel(s, s_ref) == 0.0 and rel(sdot, sdot_ref) <= 1e-13

    got = tan.factor_takahashi_solve_tan(kuu, tanb, p, b)
    for g, w in zip(got[:7], core.factor_takahashi_solve(kuu, p, b)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    K, T = dense(kuu), dense(tanb)
    Ki = torch.linalg.inv(K)
    assert rel(got[7], band_of(-Ki @ T @ Ki, k)) <= 1e-12


def test_cpu_tensors_run_the_plain_versions():
    core.reset_counters()
    tan.factor_takahashi_solve_tan(*inputs(2, 20, 1))
    assert all(core.LAUNCHES[key] == 0 for key in LAUNCH_KEYS)
    assert core.PLAIN_CALLS == {"cpu": 2, "cuda": 0}


def test_outer_band_and_weights():
    u = torch.from_numpy(np.random.RandomState(3).randn(9))
    o = tan.outer_band(u, 3)
    torch.testing.assert_close(o, band_of(torch.outer(u, u), 3), rtol=0, atol=0)
    w = tan.band_weights(3, 9, u)
    assert w.shape == (4, 9) and bool((w[0] == 1).all()) and bool((w[1:] == 2).all())


def _kuu_fn(g0, g1):
    def kuu_fn(var, ell):
        # the Matérn contract: kuu_fn = var⁻¹ · G(ell)
        return (g0 + ell * g1 + ell * ell * 0.3 * g1) / var
    return kuu_fn


@pytest.mark.parametrize("route", ["tan", "twist"])
def test_matern_core_gradient_matches_autograd(route):
    """MaternCore's elementwise backward against autograd through the plain
    untwisted recursions (``core.collapsed_core`` on the assembled Kuu)."""
    from asvgp_tpu_torch.banded import twist

    k, m = 3, 40
    rng = np.random.RandomState(7)
    g0 = torch.from_numpy(spd_band(k, m, rng, diag=3.0))
    g1 = torch.from_numpy(0.05 * sym_band(k, m, rng))
    kuu_fn = _kuu_fn(g0, g1)
    big0 = torch.from_numpy(spd_band(k, m, rng))
    b0 = torch.from_numpy(rng.randn(m))
    weights = (0.7, -0.3, 0.2, 1.3)
    fn = {"tan": tan.collapsed_core_matern, "twist": twist.collapsed_core_matern}[route]

    def run(core_fn):
        var = torch.tensor(1.3, dtype=torch.float64, requires_grad=True)
        ell = torch.tensor(0.8, dtype=torch.float64, requires_grad=True)
        s2 = torch.tensor(0.4, dtype=torch.float64, requires_grad=True)
        b = b0.clone().requires_grad_()
        big = big0.clone().requires_grad_()
        p = big / s2 + kuu_fn(var, ell)
        out = core_fn(var, ell, p, b, big)
        loss = sum(c * o for c, o in zip(weights, out))
        return loss, torch.autograd.grad(loss, (var, ell, s2, b, big))

    loss, grads = run(lambda v, l, p, b, big: fn(kuu_fn, v, l, p, b, big))
    loss_ref, grads_ref = run(lambda v, l, p, b, big: core.collapsed_core(kuu_fn(v, l), p, b, big))
    assert rel(loss.detach(), loss_ref.detach()) <= 1e-12
    for name, g, w in zip(("var", "ell", "s2", "b", "big"), grads, grads_ref):
        assert rel(g, w) <= 1e-10, name


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA sweeps have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("k", range(1, 7))
def test_cuda_kernels_match_plain(cuda_device, k):
    """K3 and K4 on the card against their plain versions on the CPU, at a
    well-conditioned random band: ≤ 1e-11 relative (a few ulps)."""
    host = inputs(k, 1000, k)
    core.reset_counters()
    k3 = tan.chol_pair_solve_tan(*(t.to(cuda_device) for t in host))
    k4 = tan.tak_pair_solve_tan(*k3)
    torch.cuda.synchronize()
    assert [core.LAUNCHES[key] for key in LAUNCH_KEYS] == [1, 1]
    assert core.PLAIN_CALLS["cuda"] == 0
    k3_ref = tan.chol_pair_solve_tan_plain(*host)
    k4_ref = tan.tak_pair_solve_tan_plain(*(t.cpu() for t in k3))
    for g, w in zip((*k3, *k4), (*k3_ref, *k4_ref)):
        assert g.is_cuda
        assert rel(g.cpu(), w) <= 1e-11
