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

K13/K21 partition the forward substitution, and K14/K22 the backward one
(the same kernel walking the rows from the bottom up), into chunks of 64
rows (csrc/banded_solve.cu ``chunk_rows`` at these sizes): each chunk's
affine map from its incoming window to its outgoing one, a scan over the
maps for the true windows, and the plain recursion from them.  A numpy
emulation of those three passes, in the kernel's order of operations and
in the working dtype, is held to the plain version at the bars
``chip_smoke.py`` holds the kernels to (phase 6j): 1e-13 (float64) and
1e-5 (float32) on random bands, 1e-8 and 1e-4 on a GPR1D P band at the
north star's ℓ/δ = 10.

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
from asvgp_tpu_torch.basis import B3Spline
from asvgp_tpu_torch.features.spline_features import make_kuu
from asvgp_tpu_torch.models import GPR1D, Matern32

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


# ---------------------------------------------------------------------------
# the partition of K13 / K21 and of K14 / K22, emulated
# ---------------------------------------------------------------------------

CHUNK = 64  # rows per chunk of csrc/banded_solve.cu at m <= 16384, r <= 64
# phase 6j's bars: random bands (TOL_PARITY_ADJOINT, TOL_F32_FWD) and the
# north star's own arguments (TOL_PARITY_MAIN, TOL_F32_MAIN)
BARS = {np.float64: (1e-13, 1e-8), np.float32: (1e-5, 1e-4)}
DIRECTIONS = {False: solve.solve_lower_plain, True: solve.solve_upper_t_plain}


def partitioned_solve(l, b, upper, lc=CHUNK):
    """x = L⁻¹ b, or x = L⁻ᵀ b when ``upper``, by the kernel's three passes,
    in ``l``'s dtype, and the largest entry of the composed maps.  The rows
    are walked in the kernel's order, 0..m-1 (m-1..0 when ``upper``), and
    the walk is cut into chunks of ``lc`` positions from its start.  Each
    pass runs every chunk at once; positions past m are identity rows
    (pivot 1, no band, b = 0)."""
    dt = l.dtype.type
    k, m = l.shape[0] - 1, l.shape[1]
    b2 = b[:, None] if b.ndim == 1 else b
    r = b2.shape[1]
    n_chunks = -(-m // lc)
    # g[p, u]: the entry the window's X[p-1] meets at walk position u, row i
    g = np.zeros((k + 1, n_chunks * lc), dt)
    g[0] = 1
    if upper:
        g[:, :m] = l[:, ::-1]  # L[i+p, i], i = m-1-u: one run per p
    else:
        g[0, :m] = l[0]
        for p in range(1, k + 1):
            g[p, p:m] = l[p, :m - p]  # L[i, i-p], i = u
    g = g.reshape(k + 1, n_chunks, lc)
    walk = slice(None, None, -1) if upper else slice(None)
    bp = np.zeros((n_chunks * lc, r), dt)
    bp[:m] = b2[walk]
    bp = bp.reshape(n_chunks, lc, r)

    def sweep(window, rhs):
        """The plain recursion over every chunk from ``window`` (chunks, k,
        chains), X[:, p] = the x walked 1 + p positions before: the sum over
        p increasing, each product, sum, difference and quotient rounded in
        ``dt``."""
        xs = []
        for t in range(lc):
            acc = g[1, :, t, None] * window[:, 0]
            for p in range(2, k + 1):
                acc = acc + g[p, :, t, None] * window[:, p - 1]
            x = (rhs(t) - acc) / g[0, :, t, None]
            xs.append(x)
            window = np.concatenate([x[:, None], window[:, :-1]], axis=1)
        return window, np.stack(xs, axis=1)

    # pass 1: the k homogeneous responses (window e_q, b = 0) and the r
    # particular solutions (window 0); their last window is the chunk's map
    w1 = np.zeros((n_chunks, k, k + r), dt)
    for q in range(k):
        w1[:, q, q] = 1
    zeros = np.zeros((n_chunks, k), dt)
    out, _ = sweep(w1, lambda t: np.concatenate([zeros, bp[:, t]], axis=1))
    h, y = out[:, :, :k], out[:, :, k:]
    # pass 2: the incoming windows, w_{j+1} = y_j + H_j w_j
    win = np.zeros((n_chunks, k, r), dt)
    for j in range(n_chunks - 1):
        win[j + 1] = y[j] + h[j] @ win[j]
    # pass 3: the plain recursion from the true windows
    _, x = sweep(win, lambda t: bp[:, t])
    x = x.reshape(n_chunks * lc, r)[:m][walk]
    h_max = float(np.abs(h[:-1]).max()) if n_chunks > 1 else 0.0
    return (x[:, 0] if b.ndim == 1 else x), h_max


def check_partition_on_random_bands(k, upper):
    """The emulation against the plain version at m = 1000 (15 chunks and a
    ragged one of 40 rows) and m = 40 (one chunk), a vector and 5 columns,
    in float64 and float32, at 64- and 8-row chunks."""
    for m in (1000, 40):
        for r in (None, 5):
            l, b = factor(k, m, 60 + k, r)
            for dt in (np.float64, np.float32):
                lh, bh = l.numpy().astype(dt), b.numpy().astype(dt)
                want = DIRECTIONS[upper](torch.from_numpy(lh), torch.from_numpy(bh))
                for lc in (CHUNK, 8):
                    got, h_max = partitioned_solve(lh, bh, upper, lc)
                    assert got.dtype == dt and np.isfinite(h_max)
                    assert rel(got, want) <= BARS[dt][0], (m, r, dt, lc)


@pytest.mark.parametrize("k", range(1, 7))
def test_partitioned_lower_solve_matches_plain(k):
    """K13/K21's partition on random SPD bands; at 8-row chunks the maps'
    homogeneous part has not yet decayed below rounding and the scan must
    carry it."""
    check_partition_on_random_bands(k, upper=False)


@pytest.mark.parametrize("k", range(1, 7))
def test_partitioned_upper_solve_matches_plain(k):
    """K14/K22's partition, the same walked from the bottom row up: the
    chunk that holds row m-1 is solved from the zero window, the ragged
    chunk holds row 0."""
    check_partition_on_random_bands(k, upper=True)


def test_partitioned_lower_solve_at_north_star_conditioning():
    """The two solves of ``cholesky_solve_band``, L_P⁻¹ Kuf·y (also the
    collapsed bound's) and L_P⁻ᵀ of it, on a GPR1D at the north star's
    ℓ/δ = 10 and N/m = 100 (m = 320, B3, Matérn-3/2, noise 0.1), L_P in
    each dtype from its own Cholesky; the composed maps of both directions
    stay bounded."""
    m = 320
    rng = np.random.RandomState(5)
    x = rng.uniform(0.005, 0.995, 100 * m)
    y = np.sin(140.8 * x) + 0.5 * np.sin(35.2 * x) + 0.3 * rng.randn(x.shape[0])
    kernel, basis = Matern32(1.0, 10.0 / m), B3Spline(0.0, 1.0, m)
    model = GPR1D((x, y), kernel, basis, noise_variance=0.1, device="cpu")
    with torch.no_grad():
        p_band = model.kufkfu_band / 0.1 + make_kuu(kernel, basis)
    for dt, tdt in ((np.float64, torch.float64), (np.float32, torch.float32)):
        l = ops.cholesky_band_plain(p_band.to(tdt))
        b = model.kuf_y.to(tdt)
        for upper, plain in DIRECTIONS.items():
            got, h_max = partitioned_solve(l.numpy(), b.numpy(), upper)
            assert got.dtype == dt and h_max <= 1.0
            assert rel(got, plain(l, b)) <= BARS[dt][1], (dt, upper)
            b = plain(l, b)  # the upper solve takes the lower one's x


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


@pytest.mark.cuda
@pytest.mark.parametrize("k, m, r", [(1, 1, None), (3, 40, None), (3, 40, 5), (6, 64, None),
                                     (2, 65, 5), (4, 4097, None), (3, 10_000, None),
                                     (5, 10_000, 5), (3, 1000, 4096)])
def test_cuda_lower_solve_partition_edges(cuda_device, k, m, r):
    """K13, K21 and K14, K22 at their partitions' edges: one row, one chunk
    (m < 64, and m = 64 exactly), a ragged last chunk (the top rows of the
    upper solve), the north star's m = 10⁴, and 4096 columns, where the rows
    form one chunk; each launched once."""
    l, b = factor(k, m, 70 + k, r)
    core.reset_counters()
    for dtype, tol in ((torch.float64, 1e-13), (torch.float32, 1e-5)):
        lh, bh = l.to(dtype), b.to(dtype)
        for fn, plain in ((solve.solve_lower, solve.solve_lower_plain),
                          (solve.solve_upper_t, solve.solve_upper_t_plain)):
            got = fn(lh.to(cuda_device), bh.to(cuda_device))
            assert got.is_cuda and got.dtype == dtype and got.shape == bh.shape
            assert rel(got.cpu(), plain(lh, bh)) <= tol
    torch.cuda.synchronize()
    assert [core.LAUNCHES[key] for key in KEYS] == [1, 1, 1, 1]
    assert core.PLAIN_CALLS["cuda"] == 0
