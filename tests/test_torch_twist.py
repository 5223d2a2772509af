"""The twisted sweeps K5 + mid step + K6 (banded/twist.py) and the float64
twisted oracle (banded/twisted.py).

The oracle is held to the JAX package's ``twisted.py`` at 1e-12; the plain
versions of the twisted sweeps to the JAX package's twisted kernels
(``pallas_ds_twist.factor_takahashi_solve_tan_twist`` in Pallas interpret
mode, TILE cut to 4 as in tests/test_twist_kernels.py) within the
interpret-mode double-single envelope, and to the single-ended sweeps and
dense float64 at a few ulps times κ, for both parities of m - k (the
reversed stream is one column shorter when it is odd).

The CUDA kernels have no CPU mode: their tests are marked ``cuda`` and skip
without a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asvgp_tpu.banded import pallas_ds_twist as jpdw
from asvgp_tpu.banded import pallas_kernels as jpk
from asvgp_tpu.banded import twisted as jtw
from asvgp_tpu_torch.banded import core, tan, twist, twisted
from test_torch_tan import band_of, dense, inputs, rel, spd_band

LAUNCH_KEYS = ("chol_quad_solve_tan", "tak_quad_solve_tan")


@pytest.mark.parametrize("k,m", [(1, 9), (3, 30), (3, 31), (6, 40)])
def test_twisted_oracle_matches_jax(k, m):
    rng = np.random.RandomState(k + m)
    kuu, p, big = (spd_band(k, m, rng) for _ in range(3))
    b = rng.randn(m)
    want = jax.jit(jtw.twisted_collapsed_core)(*map(jnp.asarray, (kuu, p, b, big)))
    got = twisted.twisted_collapsed_core(*map(torch.from_numpy, (kuu, p, b, big)))
    for g, w in zip((*got[0], *got[1]), (*want[0], *want[1])):
        assert rel(g, w) <= 1e-12
    fb = torch.from_numpy(kuu)
    assert rel(twisted.flip_band(twisted.flip_band(fb)), fb) == 0.0
    assert rel(twisted.flip_band(fb), jtw.flip_band(jnp.asarray(kuu))) == 0.0


@pytest.mark.parametrize("k,m", [(1, 5), (2, 11), (2, 12), (3, 14), (3, 13), (6, 40), (6, 36)])
def test_twist_applicable_matches_jax(k, m):
    assert twist.twist_applicable(k, m) == jpdw.twist_applicable(k, m)
    assert twisted.split_point(m, k) == jtw.split_point(m, k)


@pytest.fixture
def interpret_small_tile(monkeypatch):
    monkeypatch.setattr(jpdw, "TILE", 4)
    jpk.set_interpret(True)
    yield
    jpk.set_interpret(False)


def test_twist_sweeps_match_jax_interpret(interpret_small_tile):
    k, m = 2, 24
    kuu, tanb, p, b = inputs(k, m, 0)
    want = jpdw.factor_takahashi_solve_tan_twist(*(jnp.asarray(t.numpy()) for t in (kuu, tanb, p, b)))
    got = twist.factor_takahashi_solve_tan_twist(kuu, tanb, p, b)
    names = ("ld_kuu", "ld_p", "quad", "s_kuu", "s_p", "u", "sdot_kuu")
    # the interpret-mode double-single envelope of test_twist_kernels.py
    tols = dict(ld_kuu=1e-12, ld_p=1e-12, quad=1e-10, s_kuu=3e-9, s_p=3e-9, u=3e-8, sdot_kuu=3e-8)
    for name, g, w in zip(names, got, want):
        assert rel(g, w) <= tols[name], name


@pytest.mark.parametrize("k,m", [(1, 20), (2, 24), (3, 40), (3, 41), (6, 60), (6, 61)])
def test_twist_sweeps_match_single_ended_and_dense(k, m):
    kuu, tanb, p, b = inputs(k, m, 20 + k + m)
    ld_kuu, ld_p, quad, s_kuu, s_p, u, sdot = twist.factor_takahashi_solve_tan_twist(kuu, tanb, p, b)
    single = tan.core_sweeps(kuu, tanb, p, b)
    for g, w in zip((ld_kuu, ld_p, quad, s_kuu, s_p, u, sdot), single):
        assert rel(g, w) <= 1e-12
    K, T, P = dense(kuu), dense(tanb), dense(p)
    Ki = torch.linalg.inv(K)
    assert rel(sdot, band_of(-Ki @ T @ Ki, k)) <= 1e-12
    assert rel(s_p, band_of(torch.linalg.inv(P), k)) <= 1e-12
    assert rel(quad, b @ torch.linalg.solve(P, b)) <= 1e-12
    # the bands keep their right padding zero
    for band in (s_kuu, s_p, sdot):
        for j in range(1, k + 1):
            assert bool((band[j, m - j:] == 0).all())


def test_mid_step_tangent_matches_jvp():
    """The written-out tangent of the middle inverse, Ż = −Z·Ṡ·Z, against
    forward-mode AD of the mid step in the Kuu direction."""
    k, m = 3, 40
    kuu, tanb, p, b = inputs(k, m, 5)
    l, ldot, _, _, y = twist.chol_quad_solve_tan(kuu, tanb, p, b)

    def z_kuu(kuu_band, l_kuu_streams):
        ll = torch.cat([l_kuu_streams[:1], l[1:2], l_kuu_streams[1:], l[3:]])
        return twist.mid_step(kuu_band, tanb, p, b, ll, ldot, y)[1][0]

    _, zdot_ref = torch.func.jvp(z_kuu, (kuu, l[0::2]), (tanb, ldot))
    _, z, _, _ = twist.mid_step(kuu, tanb, p, b, l, ldot, y)
    assert rel(z[2], zdot_ref) <= 1e-12


def test_wrappers_reject_bad_operands():
    kuu, tanb, p, b = inputs(3, 10, 0)
    with pytest.raises(ValueError):
        twist.chol_quad_solve_tan(kuu, tanb, p, b)  # too short to split
    kuu, tanb, p, b = inputs(3, 40, 0)
    l, ldot, iv, ivdot, y = twist.chol_quad_solve_tan(kuu, tanb, p, b)
    z, x2 = torch.zeros(3, 3, 3, dtype=torch.float64), torch.zeros(3, dtype=torch.float64)
    with pytest.raises(ValueError):
        twist.tak_quad_solve_tan(l, ldot, iv, ivdot, y, z, x2, 44)  # h != 21
    with pytest.raises(ValueError):
        twist.tak_quad_solve_tan(l, ldot, iv, ivdot, y, z[:2], x2, 40)


def test_cpu_tensors_run_the_plain_versions():
    core.reset_counters()
    twist.factor_takahashi_solve_tan_twist(*inputs(2, 20, 1))
    assert all(core.LAUNCHES[key] == 0 for key in LAUNCH_KEYS)
    assert core.PLAIN_CALLS == {"cpu": 2, "cuda": 0}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA sweeps have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("k", range(1, 7))
@pytest.mark.parametrize("m", [1000, 1001])
def test_cuda_kernels_match_plain(cuda_device, k, m):
    """K5 and K6 on the card against their plain versions on the CPU (same
    inputs; the mid step's outputs fed to both K6s): ≤ 1e-11 relative."""
    host = inputs(k, m, k)
    core.reset_counters()
    k5 = twist.chol_quad_solve_tan(*(t.to(cuda_device) for t in host))
    k5_ref = twist.chol_quad_solve_tan_plain(*host)
    for g, w in zip(k5, k5_ref):
        assert g.is_cuda and rel(g.cpu(), w) <= 1e-11
    k5_host = [t.cpu() for t in k5]
    _, z, x2, _ = twist.mid_step(*host, k5_host[0], k5_host[1], k5_host[4])
    k6 = twist.tak_quad_solve_tan(*k5, z.to(cuda_device), x2.to(cuda_device), m)
    torch.cuda.synchronize()
    assert [core.LAUNCHES[key] for key in LAUNCH_KEYS] == [1, 1]
    assert core.PLAIN_CALLS["cuda"] == 0
    k6_ref = twist.tak_quad_solve_tan_plain(*k5_host, z, x2, m)
    for g, w in zip(k6, k6_ref):
        assert g.is_cuda and rel(g.cpu(), w) <= 1e-11
