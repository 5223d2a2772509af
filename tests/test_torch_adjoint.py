"""The adjoint of the generic collapsed core: K7 ``tak_bwd_vec``, K8
``chol_bwd_pair`` and ``CollapsedCore`` (banded/core.py), and the pair
forms K15 ``chol_fwd_pair`` (banded/single.py) and K23 ``tak_bwd_pair``.

K7's and K8's plain versions are held to the JAX package's
``takahashi_bwd_vec_ds`` and ``cholesky_band_pair_bwd_ds`` in Pallas
interpret mode with TILE cut to 4; interpret mode's double-single envelope
on these adjoints is ~4e-9 relative, held at 3e-8 (tests/test_torch_single.py
says why).  ``CollapsedCore``'s value and gradient in all four inputs are
held to ``jax.vjp`` of ``asvgp_tpu.banded.collapsed_core`` through the
float64 scans (``impl_scope("scan")``) to 1e-11 relative: the same float64
function, the port by its explicit adjoints, the JAX package by autodiff.

The CUDA kernels have no CPU mode: their tests are marked ``cuda`` and skip
without a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asvgp_tpu import banded as jbanded
from asvgp_tpu.banded import ops as jops
from asvgp_tpu.banded import pallas_ds as jpd
from asvgp_tpu.banded import pallas_ds_core as jpdc
from asvgp_tpu.banded import pallas_ds_pair as jpdp
from asvgp_tpu.banded import pallas_kernels as jpk
from asvgp_tpu_torch import banded
from asvgp_tpu_torch.banded import core, ops, single

LAUNCH_KEYS = ("chol_pair_solve", "tak_pair_solve", "tak_bwd_vec", "chol_bwd_pair")
WEIGHTS = (0.7, -0.3, 0.2, 1.3)


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


def core_inputs(k, m, seed):
    """(Kuu, P = Kuu + B/0.3, b, B) as numpy."""
    rng = np.random.RandomState(seed)
    kuu, big = spd_band(k, m, rng), spd_band(k, m, rng)
    return kuu, kuu + big / 0.3, rng.randn(m), big


@pytest.fixture
def interpret_small_tile(monkeypatch):
    for mod in (jpk, jpd, jpdp, jpdc):
        monkeypatch.setattr(mod, "TILE", 4)
    jpk.set_interpret(True)
    yield
    jpk.set_interpret(False)


def test_k7_k8_match_jax_interpret(interpret_small_tile):
    """K7 (reciprocal pivots given) and K8 (batch of one; the JAX pair
    kernel with a dead second matrix) on one 3-tile band."""
    rng = np.random.RandomState(0)
    a = torch.from_numpy(spd_band(2, 10, rng))
    l = ops.cholesky_band_plain(a)
    s = ops.takahashi_inverse_band_plain(l)
    s_bar, l_bar = (torch.from_numpy(rng.randn(3, 10)) for _ in range(2))
    jl, js = jnp.asarray(l.numpy()), jnp.asarray(s.numpy())
    want = jpdc.takahashi_bwd_vec_ds(jl, js, jnp.asarray(s_bar.numpy()), 1.0 / jl[0])
    assert rel(core.tak_bwd_vec(l, s, s_bar, 1.0 / l[0]), want) <= 3e-8
    want, _ = jpdp.cholesky_band_pair_bwd_ds(jl, jl, jnp.asarray(l_bar.numpy()),
                                             jnp.zeros_like(jl))
    assert rel(core.chol_bwd_pair(l, l_bar), want) <= 3e-8


def test_k15_k23_match_jax_interpret(interpret_small_tile):
    """K15's plain version against ``cholesky_band_pair_fwd_ds`` on two
    different bands, K23's against ``takahashi_bwd_pair_ds`` (one matrix and
    a dead second lane in the JAX package) on its second matrix; two tiles,
    the last one ragged."""
    rng = np.random.RandomState(4)
    a, b = (torch.from_numpy(spd_band(2, 7, rng)) for _ in range(2))
    want_a, want_b = jpdp.cholesky_band_pair_fwd_ds(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))
    got_a, got_b = single.chol_fwd_pair(a, b)
    assert rel(got_a, want_a) <= 1e-13 and rel(got_b, want_b) <= 1e-13
    l = torch.stack([got_a, got_b])
    s = torch.stack([ops.takahashi_inverse_band_plain(x) for x in l])
    s_bar = torch.from_numpy(rng.randn(2, 3, 7))
    iv = 1.0 / l[:, 0]
    got = core.tak_bwd_pair(l, s, s_bar, iv)
    want = jpdc.takahashi_bwd_pair_ds(*(jnp.asarray(t[1].numpy()) for t in (l, s, s_bar, iv)))
    assert rel(got[1], want) <= 3e-8
    assert rel(got[0], ops.takahashi_bwd_plain(l[0], s[0], s_bar[0], iv[0])) == 0.0


@pytest.mark.parametrize("k", [0, 2, 5])
def test_cholesky_band_pair_is_one_pair_and_differentiable(k):
    """``banded.cholesky_band_pair`` on two bands of one shape is the pair
    Function (one plain K15 forward, one plain K8 batch of two backward),
    equal to two single factorizations and to autograd through them; bands
    of two shapes take two ``cholesky_band`` calls."""
    rng = np.random.RandomState(k)
    a, b = (torch.from_numpy(spd_band(k, 17, rng)).requires_grad_() for _ in range(2))
    ca, cb = (torch.from_numpy(rng.randn(k + 1, 17)) for _ in range(2))
    core.reset_counters()
    la, lb = banded.cholesky_band_pair(a, b)
    ga, gb = torch.autograd.grad((la, lb), (a, b), (ca, cb))
    assert core.PLAIN_CALLS["cpu"] == (0 if k == 0 else 2)
    ra, rb = ops.cholesky_band_plain(a), ops.cholesky_band_plain(b)
    wa, wb = torch.autograd.grad((ra, rb), (a, b), (ca, cb))
    assert torch.equal(la, ra) and torch.equal(lb, rb)
    assert rel(ga, wa) <= 1e-13 and rel(gb, wb) <= 1e-13
    if k:
        lc, ld = banded.cholesky_band_pair(a[:, :12], b)
        assert torch.equal(lc, ops.cholesky_band_plain(a[:, :12])) and torch.equal(ld, lb)
    with pytest.raises(ValueError):
        core.tak_bwd_pair(la[None], la[None], la[None], la[:1])


@pytest.mark.parametrize("k,m", [(1, 9), (4, 23)])
def test_collapsed_core_grad_matches_jax_vjp(k, m):
    kuu, p, b, big = core_inputs(k, m, 7 * k + m)
    with jops.impl_scope("scan"):
        out, vjp = jax.vjp(jbanded.collapsed_core, *map(jnp.asarray, (kuu, p, b, big)))
        want = vjp(tuple(jnp.asarray(w) for w in WEIGHTS))
    args = [torch.from_numpy(t).requires_grad_() for t in (kuu, p, b, big)]
    core.reset_counters()
    got = banded.collapsed_core(*args)
    grads = torch.autograd.grad(got, args, [torch.tensor(w, dtype=torch.float64) for w in WEIGHTS])
    for g, w in zip(got, out):
        assert rel(g.detach(), w) <= 1e-12
    for name, g, w in zip(("kuu", "p", "b", "big"), grads, want):
        assert rel(g, w) <= 1e-11, name
    # forward K1 + K2, backward K7 + K8, all plain on the CPU
    assert all(core.LAUNCHES[key] == 0 for key in LAUNCH_KEYS)
    assert core.PLAIN_CALLS == {"cpu": 4, "cuda": 0}


def test_collapsed_core_missing_cotangents_count_as_zero():
    """A loss that uses only some outputs: the others' cotangents are None
    and count as zero; inputs that need no gradient get none."""
    kuu, p, b, big = (torch.from_numpy(t) for t in core_inputs(2, 15, 3))
    kv = kuu.clone().requires_grad_()
    bv = b.clone().requires_grad_()
    ld_kuu, _, quad, _ = banded.collapsed_core(kv, p, bv, big)
    g_kuu, g_b = torch.autograd.grad(ld_kuu + quad, (kv, bv))
    # ∂log|Kuu|/∂Kuu on the lower band is (2 − δ_j0)·band(Kuu⁻¹); ∂bᵀP⁻¹b/∂b = 2P⁻¹b
    s = ops.takahashi_inverse_band_plain(ops.cholesky_band_plain(kuu))
    w = torch.ones_like(s)
    w[1:] = 2.0
    assert rel(g_kuu, w * s) <= 1e-13
    l_p = ops.cholesky_band_plain(p)
    u = ops.solve_upper_band_transpose_plain(l_p, ops.solve_lower_band_plain(l_p, b))
    assert rel(g_b, 2.0 * u) <= 1e-13
    core.reset_counters()
    (g_b,) = torch.autograd.grad(banded.collapsed_core(kuu, p, bv, big)[2], bv)
    assert core.PLAIN_CALLS["cpu"] == 2  # K1 + K2; Kuu needs no gradient: no K7, K8
    assert rel(g_b, 2.0 * u) <= 1e-13


def test_chol_bwd_pair_batches():
    rng = np.random.RandomState(9)
    ls = [ops.cholesky_band_plain(torch.from_numpy(spd_band(3, 12, rng))) for _ in range(2)]
    cots = [torch.from_numpy(rng.randn(4, 12)) for _ in range(2)]
    got = core.chol_bwd_pair(torch.stack(ls), torch.stack(cots))
    for g, l, c in zip(got, ls, cots):
        torch.testing.assert_close(g, ops.cholesky_band_bwd_plain(l, c), rtol=0, atol=0)
    with pytest.raises(ValueError):
        core.chol_bwd_pair(ls[0], cots[0][:, :11])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA sweeps have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("k", range(1, 7))
def test_cuda_k7_k8_match_plain(cuda_device, k):
    """K7 and K8 on the card against their plain versions on the CPU:
    ≤ 1e-11 relative at a well-conditioned random band."""
    rng = np.random.RandomState(k)
    l = ops.cholesky_band_plain(torch.from_numpy(spd_band(k, 1000, rng)))
    s = ops.takahashi_inverse_band_plain(l)
    s_bar, l_bar = (torch.from_numpy(rng.randn(k + 1, 1000)) for _ in range(2))
    iv = 1.0 / l[0]
    core.reset_counters()
    got7 = core.tak_bwd_vec(*(t.to(cuda_device) for t in (l, s, s_bar, iv)))
    got8 = core.chol_bwd_pair(l.to(cuda_device), l_bar.to(cuda_device))
    torch.cuda.synchronize()
    assert core.LAUNCHES["tak_bwd_vec"] == 1 and core.LAUNCHES["chol_bwd_pair"] == 1
    assert core.PLAIN_CALLS["cuda"] == 0
    assert rel(got7.cpu(), core.tak_bwd_vec_plain(l, s, s_bar, iv)) <= 1e-11
    assert rel(got8.cpu(), core.chol_bwd_pair_plain(l, l_bar)) <= 1e-11


@pytest.mark.cuda
def test_cuda_collapsed_core_grad_matches_cpu(cuda_device):
    kuu, p, b, big = core_inputs(3, 500, 1)
    cpu = [torch.from_numpy(t).requires_grad_() for t in (kuu, p, b, big)]
    gpu = [torch.from_numpy(t).to(cuda_device).requires_grad_() for t in (kuu, p, b, big)]
    cots = [torch.tensor(w, dtype=torch.float64) for w in WEIGHTS]
    want = torch.autograd.grad(banded.collapsed_core(*cpu), cpu, cots)
    core.reset_counters()
    got = torch.autograd.grad(banded.collapsed_core(*gpu), gpu, [c.to(cuda_device) for c in cots])
    torch.cuda.synchronize()
    assert [core.LAUNCHES[key] for key in LAUNCH_KEYS] == [1, 1, 1, 1]
    assert core.PLAIN_CALLS["cuda"] == 0
    for g, w in zip(got, want):
        assert rel(g.cpu(), w) <= 1e-11


@pytest.mark.cuda
@pytest.mark.parametrize("k", range(1, 7))
def test_cuda_k15_k23_match_plain(cuda_device, k):
    """K15 and K23 on the card, one launch each for two matrices, against
    their plain versions: ≤ 1e-11 relative at well-conditioned bands."""
    rng = np.random.RandomState(20 + k)
    a, b = (torch.from_numpy(spd_band(k, 1000, rng)) for _ in range(2))
    la, lb = single.chol_fwd_pair_plain(a, b)
    l = torch.stack([la, lb])
    s = torch.stack([ops.takahashi_inverse_band_plain(x) for x in l])
    s_bar = torch.from_numpy(rng.randn(2, k + 1, 1000))
    iv = (1.0 / l[:, 0]).contiguous()
    core.reset_counters()
    ga, gb = single.chol_fwd_pair(a.to(cuda_device), b.to(cuda_device))
    g23 = core.tak_bwd_pair(*(t.to(cuda_device) for t in (l, s, s_bar, iv)))
    torch.cuda.synchronize()
    assert core.LAUNCHES["chol_fwd_pair"] == 1 and core.LAUNCHES["tak_bwd_pair"] == 1
    assert core.LAUNCHES["chol_fwd"] == 0 and core.PLAIN_CALLS["cuda"] == 0
    assert rel(ga.cpu(), la) <= 1e-11 and rel(gb.cpu(), lb) <= 1e-11
    assert rel(g23.cpu(), core.tak_bwd_pair_plain(l, s, s_bar, iv)) <= 1e-11
