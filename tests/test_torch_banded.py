"""The port's banded recursions against the JAX package's float64 scans.

Inputs are random diagonally dominant SPD bands (numpy seeds), so every
recursion is well conditioned and two orders of summation agree to a few
ulps; each output is held to 1e-10 relative to its largest entry.

The CUDA sweeps have no CPU mode: their test against the plain versions is
marked ``cuda`` and skips without a card (run it on the GPU with
``python -m pytest tests/test_torch_banded.py -m cuda``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asvgp_tpu.banded import layout as jlayout
from asvgp_tpu.banded import ops as jops
from asvgp_tpu_torch import banded
from asvgp_tpu_torch.banded import core, layout, ops

TOL = 1e-10


def spd_band(k, m, rng):
    a = 0.3 * rng.randn(k + 1, m)
    a[0] = np.abs(a[0]) + 2.0 * k + 1.0
    for j in range(1, k + 1):
        a[j, m - j:] = 0.0
    return a


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


# each JAX reference is one jitted program: one compile per shape instead
# of one per scan keeps these tests quick
@jax.jit
def _jax_factor_takahashi_solve(kuu, p, b):
    """The seven outputs of factor_takahashi_solve from the JAX scans."""
    l_kuu, l_p = jops.cholesky_band(kuu), jops.cholesky_band(p)
    c0 = jops.solve_lower_band(l_p, b)
    return (
        l_kuu, l_p,
        jops.takahashi_inverse_band(l_kuu), jops.takahashi_inverse_band(l_p),
        c0, jops.solve_upper_band_transpose(l_p, c0), 1.0 / l_kuu[0],
    )


@pytest.mark.parametrize("k", range(1, 7))
@pytest.mark.parametrize("m", [7, 64, 300])
def test_factor_takahashi_solve_matches_jax(k, m):
    rng = np.random.RandomState(100 * k + m)
    kuu, p, b = spd_band(k, m, rng), spd_band(k, m, rng), rng.randn(m)
    got = core.factor_takahashi_solve(*map(torch.from_numpy, (kuu, p, b)))
    want = _jax_factor_takahashi_solve(*map(jnp.asarray, (kuu, p, b)))
    assert len(got) == 7
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        _close(g, w)


@jax.jit
def _jax_single_ops(a, rhs, b2):
    l = jops.cholesky_band(a)
    solves = [
        (jops.solve_lower_band(l, b), jops.solve_upper_band_transpose(l, b),
         jops.cholesky_solve_band(l, b))
        for b in (rhs, rhs[:, 0])
    ]
    return (l, jops.takahashi_inverse_band(l), solves, jops.log_det_from_cholesky(l),
            jops.band_frobenius(a, b2))


@pytest.mark.parametrize("k", [1, 3, 6])
def test_single_ops_match_jax(k):
    m = 40
    rng = np.random.RandomState(k)
    a, rhs, b2 = spd_band(k, m, rng), rng.randn(m, 3), spd_band(k, m, rng)
    jl, js, jsolves, jld, jfro = _jax_single_ops(*map(jnp.asarray, (a, rhs, b2)))
    l = ops.cholesky_band(torch.from_numpy(a))
    _close(l, jl)
    _close(ops.takahashi_inverse_band(l), js)
    for b, (jlo, jup, jch) in zip((rhs, rhs[:, 0]), jsolves):
        tb = torch.from_numpy(np.ascontiguousarray(b))
        _close(ops.solve_lower_band(l, tb), jlo)
        _close(ops.solve_upper_band_transpose(l, tb), jup)
        _close(ops.cholesky_solve_band(l, tb), jch)
    la, lb = ops.cholesky_band_pair(torch.from_numpy(a), torch.from_numpy(a))
    torch.testing.assert_close(la, lb, rtol=0, atol=0)
    _close(ops.log_det_from_cholesky(l), jld)
    _close(ops.band_frobenius(torch.from_numpy(a), torch.from_numpy(b2)), jfro)


def test_takahashi_is_the_inverse_band():
    """Independent of JAX: the Takahashi band equals the band of a dense
    inverse, and L Lᵀ reproduces A."""
    k, m = 3, 30
    a = torch.from_numpy(spd_band(k, m, np.random.RandomState(5)))
    dense = layout.band_to_dense(layout.symmetrise_lower_band(a), k, k)
    l = ops.cholesky_band(a)
    ld = layout.lower_band_to_dense(l)
    torch.testing.assert_close(ld @ ld.T, dense, rtol=0, atol=1e-12)
    inv = torch.linalg.inv(dense)
    s = ops.takahashi_inverse_band(l)
    for j in range(k + 1):
        diag = torch.diagonal(inv, offset=-j)
        torch.testing.assert_close(s[j, : m - j], diag, rtol=0, atol=1e-13)
        assert bool((s[j, m - j:] == 0).all())


@pytest.mark.parametrize("k", [1, 3])
def test_collapsed_core_and_posterior_match_jax(k):
    m = 50
    rng = np.random.RandomState(11 + k)
    kuu, big, b = spd_band(k, m, rng), spd_band(k, m, rng), rng.randn(m)
    p = kuu + big / 0.3
    want_core, want_post = jax.jit(
        lambda kuu, p, b, big: (jops.collapsed_core(kuu, p, b, big), jops.banded_posterior(kuu, p, b))
    )(*map(jnp.asarray, (kuu, p, b, big)))
    got = banded.collapsed_core(*map(torch.from_numpy, (kuu, p, b, big)))
    for g, w in zip(got, want_core):
        _close(g, w)
    got = banded.banded_posterior(*map(torch.from_numpy, (kuu, p, b)))
    for g, w in zip(got, want_post):
        _close(g, w)


def test_cpu_tensors_run_the_plain_versions():
    rng = np.random.RandomState(2)
    args = [torch.from_numpy(a) for a in (spd_band(2, 20, rng), spd_band(2, 20, rng), rng.randn(20))]
    core.reset_counters()
    core.factor_takahashi_solve(*args)
    assert set(core.LAUNCHES) >= {"chol_pair_solve", "tak_pair_solve"}
    assert all(count == 0 for count in core.LAUNCHES.values())
    assert core.PLAIN_CALLS["cpu"] == 2 and core.PLAIN_CALLS["cuda"] == 0


def test_plain_versions_are_differentiable_on_cpu():
    rng = np.random.RandomState(4)
    kuu = torch.from_numpy(spd_band(2, 12, rng)).requires_grad_()
    p = torch.from_numpy(spd_band(2, 12, rng))
    ld_kuu, _, quad, _ = core.collapsed_core(kuu, p, torch.from_numpy(rng.randn(12)), p)
    (g,) = torch.autograd.grad(ld_kuu, kuu)
    # ∂log|A|/∂A on the lower band is (2 − δ_j0) · band(A⁻¹)
    s = ops.takahashi_inverse_band(ops.cholesky_band(kuu.detach()))
    w = torch.ones_like(s)
    w[1:] = 2.0
    torch.testing.assert_close(g, w * s, rtol=0, atol=1e-12)


def test_wrapper_rejects_bad_operands():
    a = torch.from_numpy(spd_band(2, 10, np.random.RandomState(0)))
    with pytest.raises(ValueError):
        core.factor_takahashi_solve(a, a[:, :9], torch.zeros(10, dtype=torch.float64))
    with pytest.raises(ValueError):
        core.factor_takahashi_solve(a, a, torch.zeros(9, dtype=torch.float64))
    with pytest.raises(ValueError):
        core.tak_pair_solve(a, a, torch.zeros(3, 10, dtype=torch.float64), torch.zeros(10, dtype=torch.float64))
    with pytest.raises(ValueError):
        core.factor_takahashi_solve(a.to("meta"), a.to("meta"), torch.zeros(10, device="meta", dtype=torch.float64))


@pytest.mark.parametrize("k", [1, 4])
def test_layout_helpers_match_jax(k):
    m = 12
    a = spd_band(k, m, np.random.RandomState(k))
    ta = torch.from_numpy(a)

    @jax.jit
    def reference(ja):
        full = jlayout.symmetrise_lower_band(ja)
        return (full, jlayout.transpose_lower_band(ja), jlayout.lower_band_to_dense(ja),
                jlayout.band_to_dense(full, k, k), [jlayout.shift_cols(ja, s) for s in (-3, 0, 2)])

    jfull, jtr, jdense, jfull_dense, jshifts = reference(jnp.asarray(a))
    full = layout.symmetrise_lower_band(ta)
    _close(full, jfull, tol=0)
    _close(layout.transpose_lower_band(ta), jtr, tol=0)
    _close(layout.lower_band_to_dense(ta), jdense, tol=0)
    _close(layout.band_to_dense(full, k, k), jfull_dense, tol=0)
    for s, js in zip((-3, 0, 2), jshifts):
        _close(layout.shift_cols(ta, s), js, tol=0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA sweeps have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("k", range(1, 7))
def test_cuda_kernels_match_plain(cuda_device, k):
    """K1 and K2 on the card against their plain versions on the CPU, at a
    well-conditioned random band: ≤ 1e-11 relative (a few ulps)."""
    m = 1000
    rng = np.random.RandomState(k)
    host = [torch.from_numpy(a) for a in (spd_band(k, m, rng), spd_band(k, m, rng), rng.randn(m))]
    core.reset_counters()
    got = core.factor_takahashi_solve(*[t.to(cuda_device) for t in host])
    torch.cuda.synchronize()
    assert core.LAUNCHES["chol_pair_solve"] == 1 and core.LAUNCHES["tak_pair_solve"] == 1
    assert sum(core.LAUNCHES.values()) == 2
    assert core.PLAIN_CALLS["cuda"] == 0
    want = core.factor_takahashi_solve_plain(*host)
    for g, w in zip(got, want):
        assert g.is_cuda
        _close(g.cpu(), w.numpy(), tol=1e-11)


@pytest.mark.cuda
def test_cuda_wrapper_refusals(cuda_device):
    a = torch.from_numpy(spd_band(2, 10, np.random.RandomState(0))).to(cuda_device)
    b = torch.zeros(10, dtype=torch.float64, device=cuda_device)
    with pytest.raises(TypeError):
        core.factor_takahashi_solve(a.float(), a.float(), b.float())
    with pytest.raises(NotImplementedError):
        core.factor_takahashi_solve(a.clone().requires_grad_(), a, b)
    wide = torch.ones(8, 20, dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError):
        core.factor_takahashi_solve(wide, wide, torch.zeros(20, dtype=torch.float64, device=cuda_device))
