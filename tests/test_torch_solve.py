"""The banded triangular solves (banded/solve.py): K13 and K14 in float64,
K21 and K22 in float32, and their autograd Functions.

The plain versions are held to the JAX package's Pallas kernels in
interpret mode with TILE cut to 4, as tests/test_torch_single.py does:
float64 against the double-single ``pallas_ds.solve_lower_ds`` and
``solve_upper_t_ds`` (K13, K14) at 1e-13 relative to the largest entry
(double-single carries ~2⁻⁴⁸, the forward sweeps of test_torch_single.py
agree to ~1e-14), float32 against ``pallas_kernels.solve_lower_pallas`` and
``solve_upper_t_pallas`` (K21, K22) at 1e-5 (a few float32 ulps after a
chain of 10 steps: the two recursions round in other orders).

``SolveLowerBand`` and ``SolveUpperBandTranspose`` are held to ``jax.vjp``
through the JAX package's float64 scans and to ``torch.autograd`` through
the port's plain loops, for a vector and a matrix right-hand side and at
k = 0, 1, 3, 6, to 1e-12 relative: the same float64 function in another
order of summation.  The float32 Functions are held to the float64 ones
at 1e-4 (well-conditioned random bands: float32 rounding, a few ulps times
the chain).

The CUDA kernels have no CPU mode: their tests are marked ``cuda`` and skip
without a card; there each kernel is held to its plain version at
1e-13 (float64) and 1e-5 (float32) relative to the largest entry.
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
from asvgp_tpu_torch.banded import core, ops, solve

KEYS = ("solve_lower", "solve_upper_t", "solve_lower_f32", "solve_upper_t_f32")


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


def factor(k, m, seed, r=None):
    """(L = chol(A) of a random SPD band, b of shape (m,) or (m, r)), float64."""
    rng = np.random.RandomState(seed)
    l = ops.cholesky_band_plain(torch.from_numpy(spd_band(k, m, rng)))
    b = torch.from_numpy(rng.randn(m) if r is None else rng.randn(m, r))
    return l, b


@pytest.fixture
def interpret_small_tile(monkeypatch):
    """Pallas interpret mode with 4-column tiles (the recursion is
    tile-agnostic; the full 128-column tile interprets for minutes)."""
    for mod in (jpk, jpd, jpdp, jpdc):
        monkeypatch.setattr(mod, "TILE", 4)
    jpk.set_interpret(True)
    yield
    jpk.set_interpret(False)


def test_f64_solves_match_jax_ds_interpret(interpret_small_tile):
    """K13's and K14's plain versions against ``solve_lower_ds`` and
    ``solve_upper_t_ds`` on one 3-tile band with a ragged last tile."""
    l, b = factor(2, 10, 0)
    jl, jb = jnp.asarray(l.numpy()), jnp.asarray(b.numpy())
    assert rel(solve.solve_lower(l, b), jpd.solve_lower_ds(jl, jb)) <= 1e-13
    assert rel(solve.solve_upper_t(l, b), jpd.solve_upper_t_ds(jl, jb)) <= 1e-13


def test_f32_solves_match_jax_pallas_interpret(interpret_small_tile):
    """K21's and K22's plain versions, in float32, against
    ``solve_lower_pallas`` and ``solve_upper_t_pallas``."""
    l, b = factor(3, 10, 1)
    l32, b32 = l.float(), b.float()
    jl, jb = jnp.asarray(l32.numpy()), jnp.asarray(b32.numpy())[None, :]
    got_lo, got_up = solve.solve_lower(l32, b32), solve.solve_upper_t(l32, b32)
    assert got_lo.dtype == got_up.dtype == torch.float32
    assert rel(got_lo, jpk.solve_lower_pallas(jl, jb)[0]) <= 1e-5
    assert rel(got_up, jpk.solve_upper_t_pallas(jl, jb)[0]) <= 1e-5


@pytest.mark.parametrize("k", [0, 1, 3, 6])
@pytest.mark.parametrize("r", [None, 3], ids=["vector", "matrix"])
def test_solve_functions_match_jax_scan_vjp(k, r):
    """The two autograd Functions and their backward against ``jax.vjp``
    of the JAX package's float64 scans (which take a matrix right-hand side
    too)."""
    l, b = factor(k, 17, 40 + k, r)
    cot = torch.from_numpy(np.random.RandomState(k).randn(*b.shape))
    for ours, theirs in ((banded.solve_lower_band, jops.solve_lower_band),
                         (banded.solve_upper_band_transpose, jops.solve_upper_band_transpose)):
        lv, bv = l.clone().requires_grad_(), b.clone().requires_grad_()
        x = ours(lv, bv)
        gl, gb = torch.autograd.grad(x, (lv, bv), cot)
        with jops.impl_scope("scan"):
            want_x, vjp = jax.vjp(theirs, jnp.asarray(l.numpy()), jnp.asarray(b.numpy()))
            want_l, want_b = vjp(jnp.asarray(cot.numpy()))
        assert rel(x, want_x) <= 1e-12
        assert rel(gb, want_b) <= 1e-12
        # jax.vjp differentiates every stored slot; the port gives the
        # padding slots of the band none (zero), as the JAX custom VJPs do
        mask = banded.mask_lower_band(torch.ones_like(l)).numpy()
        assert rel(gl, np.asarray(want_l) * mask) <= 1e-12
        assert bool((gl[mask == 0] == 0).all())


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("r", [None, 2], ids=["vector", "matrix"])
def test_solve_functions_match_autograd_through_plain(k, r):
    """``cholesky_solve_band`` with a gradient in L and b, against autograd
    through the plain loops, and the float32 Functions against the float64
    ones; the solves launch nothing on the CPU."""
    l, b = factor(k, 23, k, r)
    cot = torch.from_numpy(np.random.RandomState(9 + k).randn(*b.shape))

    def grads(fn, dtype):
        lv = l.to(dtype).requires_grad_()
        bv = b.to(dtype).requires_grad_()
        x = fn(lv, bv)
        return (x,) + torch.autograd.grad(x, (lv, bv), cot.to(dtype))

    def plain(lv, bv):
        return ops.solve_upper_band_transpose_plain(lv, ops.solve_lower_band_plain(lv, bv))

    core.reset_counters()
    got = grads(banded.cholesky_solve_band, torch.float64)
    want = grads(plain, torch.float64)
    for g, w in zip(got, want):
        assert rel(g, w) <= 1e-12
    got32 = grads(banded.cholesky_solve_band, torch.float32)
    for g, w in zip(got32, want):
        assert g.dtype == torch.float32 and rel(g, w) <= 1e-4
    assert all(core.LAUNCHES[key] == 0 for key in KEYS)
    # per run: two solves forward, two backward
    assert core.PLAIN_CALLS == {"cpu": 8, "cuda": 0}


def test_solve_checks_shapes():
    l, b = factor(2, 12, 3)
    with pytest.raises(ValueError, match=r"\(m,\) or \(m, r\)"):
        solve.solve_lower(l, b[:11])
    with pytest.raises(ValueError, match=r"\(m,\) or \(m, r\)"):
        solve.solve_upper_t(l, b.reshape(2, 6, 1))
    assert solve.solve_lower(l, b[:, None][:, :0]).shape == (12, 0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA solves have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("k", range(1, 7))
@pytest.mark.parametrize("r", [None, 5], ids=["vector", "matrix"])
def test_cuda_solves_match_plain(cuda_device, k, r):
    """K13, K14 (float64) and K21, K22 (float32) on the card against their
    plain versions on the CPU, each launched once."""
    l, b = factor(k, 1000, k, r)
    core.reset_counters()
    for dtype, tol in ((torch.float64, 1e-13), (torch.float32, 1e-5)):
        lh, bh = l.to(dtype), b.to(dtype)
        ld, bd = lh.to(cuda_device), bh.to(cuda_device)
        for fn, plain in ((solve.solve_lower, solve.solve_lower_plain),
                          (solve.solve_upper_t, solve.solve_upper_t_plain)):
            got = fn(ld, bd)
            assert got.is_cuda and got.dtype == dtype
            assert rel(got.cpu(), plain(lh, bh)) <= tol
    torch.cuda.synchronize()
    assert [core.LAUNCHES[key] for key in KEYS] == [1, 1, 1, 1]
    assert core.PLAIN_CALLS["cuda"] == 0


@pytest.mark.cuda
def test_cuda_solve_functions_launch_the_kernels(cuda_device):
    """The differentiable solves on the card: forward and backward each a
    kernel (the backward of a solve is the other solve's kernel)."""
    l, b = factor(3, 300, 5)
    cot = torch.from_numpy(np.random.RandomState(5).randn(300))
    lv, bv = l.to(cuda_device).requires_grad_(), b.to(cuda_device).requires_grad_()
    core.reset_counters()
    x = banded.solve_lower_band(lv, bv)
    gl, gb = torch.autograd.grad(x, (lv, bv), cot.to(cuda_device))
    torch.cuda.synchronize()
    assert core.LAUNCHES["solve_lower"] == 1 and core.LAUNCHES["solve_upper_t"] == 1
    lc, bc = l.clone().requires_grad_(), b.clone().requires_grad_()
    want = torch.autograd.grad(ops.solve_lower_band_plain(lc, bc), (lc, bc), cot)
    assert rel(gl.cpu(), want[0]) <= 1e-12 and rel(gb.cpu(), want[1]) <= 1e-12
