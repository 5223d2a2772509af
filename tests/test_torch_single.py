"""The single-matrix Cholesky and Takahashi and their adjoints, K9–K12
(banded/single.py), and the dispatch of the public banded ops.

The plain versions are held to the JAX package's double-single kernels
(``pallas_ds``) in Pallas interpret mode with TILE cut to 4, as
tests/test_torch_tan.py does.  Interpret mode runs the TPU kernels'
double-single arithmetic, which XLA:CPU rounds a little differently from
the TPU, so the tolerances against it are that envelope: the forward
sweeps agree to ~1e-14 relative (held at 1e-13), the adjoints to ~4e-9
(held at 3e-8, the envelope tests/test_twist_kernels.py allows).  The
explicit reverse-mode recursions (``ops.cholesky_band_bwd_plain``,
``ops.takahashi_bwd_plain``) are also held to ``jax.vjp`` through the JAX
package's float64 scans and to ``torch.autograd`` through the port's
forward recursions, to 1e-13 relative: the same float64 function in
another order of summation.

The CUDA kernels have no CPU mode: their tests are marked ``cuda`` and skip
without a card.
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
from asvgp_tpu_torch import banded
from asvgp_tpu_torch.banded import core, dense_block, ops, single, solve, tan, twist, twisted

LAUNCH_KEYS = ("chol_fwd", "chol_bwd", "tak_fwd", "tak_bwd")


def spd_band(k, m, rng):
    a = 0.3 * rng.randn(k + 1, m)
    a[0] = np.abs(a[0]) + 2.0 * k + 1.0
    for j in range(1, k + 1):
        a[j, m - j:] = 0.0
    return a


def rel(got, want):
    got = torch.as_tensor(np.array(got))
    want = torch.as_tensor(np.array(want))
    assert got.shape == want.shape
    return float(torch.max(torch.abs(got - want)) / torch.max(torch.abs(want)))


def inputs(k, m, seed):
    """(A, L = chol(A), S = band of A⁻¹, a cotangent of L, one of S)."""
    rng = np.random.RandomState(seed)
    a = torch.from_numpy(spd_band(k, m, rng))
    l = ops.cholesky_band_plain(a)
    s = ops.takahashi_inverse_band_plain(l)
    return a, l, s, torch.from_numpy(rng.randn(k + 1, m)), torch.from_numpy(rng.randn(k + 1, m))


@pytest.fixture
def interpret_small_tile(monkeypatch):
    """Pallas interpret mode with 4-column tiles (the recursion is
    tile-agnostic; the full 128-column tile interprets for minutes)."""
    for mod in (jpk, jpd, jpdp, jpdc):
        monkeypatch.setattr(mod, "TILE", 4)
    jpk.set_interpret(True)
    yield
    jpk.set_interpret(False)


def test_single_sweeps_match_jax_interpret(interpret_small_tile):
    """K9–K12's plain versions against ``cholesky_band_fwd_ds``,
    ``cholesky_band_bwd_ds``, ``takahashi_fwd_ds`` and ``takahashi_bwd_ds``
    on one 3-tile band with a ragged last tile."""
    a, l, s, l_bar, s_bar = inputs(2, 10, 0)
    j = {name: jnp.asarray(t.numpy()) for name, t in
         (("a", a), ("l", l), ("s", s), ("l_bar", l_bar), ("s_bar", s_bar))}
    assert rel(single.chol_fwd(a), jpd.cholesky_band_fwd_ds(j["a"])) <= 1e-13
    assert rel(single.tak_fwd(l), jpd.takahashi_fwd_ds(j["l"])) <= 1e-13
    assert rel(single.chol_bwd(l, l_bar), jpd.cholesky_band_bwd_ds(j["l"], j["l_bar"])) <= 3e-8
    assert rel(single.tak_bwd(l, s, s_bar), jpd.takahashi_bwd_ds(j["l"], j["s"], j["s_bar"])) <= 3e-8


@pytest.mark.parametrize("k", [1, 3, 6])
def test_adjoints_match_jax_scan_vjp(k):
    """K10's and K12's plain versions against ``jax.vjp`` of the JAX
    package's float64 ``cholesky_band`` and ``takahashi_inverse_band``."""
    a, l, s, l_bar, s_bar = inputs(k, 21, 30 + k)
    with jops.impl_scope("scan"):
        _, chol_vjp = jax.vjp(jops.cholesky_band, jnp.asarray(a.numpy()))
        _, tak_vjp = jax.vjp(jops.takahashi_inverse_band, jnp.asarray(l.numpy()))
        (want_a,) = chol_vjp(jnp.asarray(l_bar.numpy()))
        (want_l,) = tak_vjp(jnp.asarray(s_bar.numpy()))
    assert rel(single.chol_bwd(l, l_bar), want_a) <= 1e-13
    assert rel(single.tak_bwd(l, s, s_bar), want_l) <= 1e-13


@pytest.mark.parametrize("k", range(1, 7))
def test_adjoints_match_autograd(k):
    """The explicit reverse-mode recursions against autograd through the
    forward recursions, at widths that leave padding in every column kind
    (m = k, k+1 and 23), with a cotangent on the padding slots too."""
    for m in (k, k + 1, 23):
        a, l, s, l_bar, s_bar = inputs(k, m, 10 * k + m)
        a = a.requires_grad_()
        (want,) = torch.autograd.grad(ops.cholesky_band_plain(a), a, l_bar)
        got = ops.cholesky_band_bwd_plain(l, l_bar)
        assert rel(got, want) <= 1e-13
        padding = banded.mask_lower_band(torch.ones_like(got)) == 0
        assert bool((got[padding] == 0).all())
        lv = l.clone().requires_grad_()
        (want,) = torch.autograd.grad(ops.takahashi_inverse_band_plain(lv), lv, s_bar)
        assert rel(ops.takahashi_bwd_plain(l, s, s_bar), want) <= 1e-13
        assert rel(ops.takahashi_bwd_plain(l, s, s_bar, 1.0 / l[0]), want) <= 1e-13


@pytest.mark.parametrize("k", [0, 1, 4])
def test_differentiable_ops_match_autograd_through_plain(k):
    """``banded.cholesky_band`` and ``banded.takahashi_inverse_band`` (the
    autograd Functions of K9–K12) against autograd through the plain
    recursions, chained as SVGP1D chains them; k = 0 runs torch ops."""
    a, _, _, _, cot = inputs(k, 19, k)

    def grad(chol, tak):
        av = a.clone().requires_grad_()
        s = tak(chol(av))
        (g,) = torch.autograd.grad(torch.sum(cot * s) + torch.sum(torch.log(chol(av)[0])), av)
        return s.detach(), g

    core.reset_counters()
    s, g = grad(banded.cholesky_band, banded.takahashi_inverse_band)
    s_ref, g_ref = grad(ops.cholesky_band_plain, ops.takahashi_inverse_band_plain)
    assert rel(s, s_ref) <= 1e-14 and rel(g, g_ref) <= 1e-12
    assert all(core.LAUNCHES[key] == 0 for key in LAUNCH_KEYS)
    # two Cholesky and one Takahashi forward, their three adjoints; k = 0
    # needs no plain version
    assert core.PLAIN_CALLS == {"cpu": 0 if k == 0 else 6, "cuda": 0}


def test_public_ops_dispatch_on_the_device():
    """A CPU tensor runs the plain recursion; a tensor on neither the CPU
    nor a card raises, the solves (K13/K14) included."""
    a, l, _, _, _ = inputs(3, 12, 5)
    b = torch.from_numpy(np.random.RandomState(1).randn(12))
    torch.testing.assert_close(banded.cholesky_band(a), ops.cholesky_band_plain(a), rtol=0, atol=0)
    la, lb = banded.cholesky_band_pair(a, a)
    torch.testing.assert_close(la, lb, rtol=0, atol=0)
    torch.testing.assert_close(banded.solve_lower_band(l, b), ops.solve_lower_band_plain(l, b),
                               rtol=0, atol=0)
    meta_l, meta_b = l.to("meta"), b.to("meta")
    with pytest.raises(ValueError, match="'cpu' or 'cuda'"):
        banded.solve_lower_band(meta_l, meta_b)
    with pytest.raises(ValueError, match="'cpu' or 'cuda'"):
        banded.solve_upper_band_transpose(meta_l, meta_b)
    with pytest.raises(ValueError, match="'cpu' or 'cuda'"):
        banded.cholesky_solve_band(meta_l, meta_b)
    with pytest.raises(ValueError):
        single.chol_fwd(a.to("meta"))
    with pytest.raises(ValueError):
        single.tak_bwd(l, l[:, :11], l)


def _kernel_wrappers():
    """Every public dispatcher and kernel wrapper of the banded package: a
    plain version must reach none of them."""
    names = {
        ops: ("cholesky_band", "cholesky_band_pair", "takahashi_inverse_band",
              "solve_lower_band", "solve_upper_band_transpose", "cholesky_solve_band",
              "collapsed_core", "banded_posterior", "collapsed_core_matern"),
        core: ("chol_pair_solve", "tak_pair_solve", "factor_takahashi_solve", "collapsed_core",
               "tak_bwd_vec", "chol_bwd_pair", "tak_bwd_pair"),
        single: ("chol_fwd", "chol_bwd", "tak_fwd", "tak_bwd", "chol_fwd_pair"),
        solve: ("solve_lower", "solve_upper_t"),
        dense_block: ("chol_inv_dense",),
        tan: ("chol_pair_solve_tan", "tak_pair_solve_tan", "factor_takahashi_solve_tan"),
        twist: ("chol_quad_solve_tan", "tak_quad_solve_tan", "factor_takahashi_solve_tan_twist"),
    }
    return [(mod, name) for mod, group in names.items() for name in group]


def test_plain_versions_reach_only_plain_loops(monkeypatch):
    """Every ``*_plain`` of the port, and the float64 twisted oracle, run with
    every dispatcher and kernel wrapper replaced by one that raises: on a
    CUDA tensor a plain version never launches a kernel."""
    for mod, name in _kernel_wrappers():
        def refuse(*args, _name=f"{mod.__name__}.{name}", **kwargs):
            raise AssertionError(f"a plain version called {_name}")
        monkeypatch.setattr(mod, name, refuse)

    k, m = 2, 24
    rng = np.random.RandomState(3)
    kuu, p, big = (torch.from_numpy(spd_band(k, m, rng)) for _ in range(3))
    tanb = 0.1 * big
    b = torch.from_numpy(rng.randn(m))
    _, l, s, l_bar, s_bar = inputs(k, m, 4)

    k1 = core.chol_pair_solve_plain(kuu, p, b)
    core.tak_pair_solve_plain(*k1)
    core.factor_takahashi_solve_plain(kuu, p, b)
    core.tak_bwd_vec_plain(l, s, s_bar, 1.0 / l[0])
    core.chol_bwd_pair_plain(l, l_bar)
    core.chol_bwd_pair_plain(torch.stack([l, l]), torch.stack([l_bar, l_bar]))
    single.chol_fwd_plain(kuu)
    single.chol_bwd_plain(l, l_bar)
    single.tak_fwd_plain(l)
    single.tak_bwd_plain(l, s, s_bar)
    single.chol_fwd_pair_plain(kuu, p)
    core.tak_bwd_pair_plain(torch.stack([l, l]), torch.stack([s, s]), torch.stack([s_bar, s_bar]),
                            torch.stack([1.0 / l[0]] * 2))
    dense_block.chol_inv_dense_plain(torch.eye(3, dtype=torch.float64) * 2.0)
    k3 = tan.chol_pair_solve_tan_plain(kuu, tanb, p, b)
    tan.tak_pair_solve_tan_plain(*k3)
    tan.factor_takahashi_solve_tan_plain(kuu, tanb, p, b)
    twist.factor_takahashi_solve_tan_twist_plain(kuu, tanb, p, b)
    twisted.twisted_collapsed_core(kuu, p, b, big)
    ops.cholesky_band_bwd_plain(l, l_bar)
    ops.takahashi_bwd_plain(l, s, s_bar)
    solve.solve_lower_plain(l, b)
    solve.solve_upper_t_plain(l, torch.stack([b, b], dim=1))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA sweeps have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("k", range(1, 7))
def test_cuda_kernels_match_plain(cuda_device, k):
    """K9–K12 on the card against their plain versions on the CPU, at a
    well-conditioned random band: ≤ 1e-11 relative (a few ulps)."""
    host = inputs(k, 1000, k)
    a, l, s, l_bar, s_bar = (t.to(cuda_device) for t in host)
    core.reset_counters()
    got = (single.chol_fwd(a), single.chol_bwd(l, l_bar), single.tak_fwd(l),
           single.tak_bwd(l, s, s_bar))
    torch.cuda.synchronize()
    assert [core.LAUNCHES[key] for key in LAUNCH_KEYS] == [1, 1, 1, 1]
    assert core.PLAIN_CALLS["cuda"] == 0
    want = (single.chol_fwd_plain(host[0]), single.chol_bwd_plain(host[1], host[3]),
            single.tak_fwd_plain(host[1]), single.tak_bwd_plain(host[1], host[2], host[4]))
    for g, w in zip(got, want):
        assert g.is_cuda
        assert rel(g.cpu(), w) <= 1e-11


@pytest.mark.cuda
def test_cuda_differentiable_ops_launch_the_kernels(cuda_device):
    a, _, _, _, cot = inputs(3, 200, 7)
    av = a.to(cuda_device).requires_grad_()
    core.reset_counters()
    s = banded.takahashi_inverse_band(banded.cholesky_band(av))
    (g,) = torch.autograd.grad(torch.sum(cot.to(cuda_device) * s), av)
    torch.cuda.synchronize()
    assert [core.LAUNCHES[key] for key in LAUNCH_KEYS] == [1, 1, 1, 1]
    assert core.PLAIN_CALLS["cuda"] == 0
    ac = a.clone().requires_grad_()
    (g_ref,) = torch.autograd.grad(
        torch.sum(cot * ops.takahashi_inverse_band_plain(ops.cholesky_band_plain(ac))), ac)
    assert rel(g.cpu(), g_ref) <= 1e-11
    # the solves launch K13 now; a float32 tensor never reaches a
    # float64-only kernel
    core.reset_counters()
    banded.solve_lower_band(av.detach(), av.detach()[0])
    assert core.LAUNCHES["solve_lower"] == 1
    with pytest.raises(TypeError, match="float64"):
        core.tak_bwd_vec(*(t.float() for t in (av.detach(),) * 3), av.detach()[0].float())
