"""The partition of the single-ended tangent sweeps: K3 (csrc/banded_tan.cu
``chol_pair_solve_tan<K>``) and K4 (``tak_pair_solve_tan<K>``).

Both run two matrices, Kuu and P, one walk each over the m columns, cut
into chunks.  K3 is the twisted K5's Schur partition on one stream: on Kuu
it walks the Schur-complement update W of each chunk's first rows as a
dual number (W, Ẇ), the tangent in the direction T riding beside every
value; on P it walks W with the lower solve's coupling β, as K1's P role
does.  K4 is the twisted K6's affine partition on one stream from a zero
carry (where K6 starts from the middle block's seed): Kuu carries the
windows of S and Ṡ, P those of S and of the upper solve, one scan over
both roles' maps.

K3 and K4 taper (rows past the last column are masked), K5 and K6 do not.
On a band whose right padding is zero, as every band here is, the two are
the same recursion (``tests/test_torch_core_partition.py``).  So the
emulation runs each matrix through the twisted emulation's roles
(``k5_matrix``, ``k6_matrix``) over all m columns, in the kernels' order of
operations (each fused multiply-add as a product and a sum), and holds the
outputs to the plain versions (``tan.chol_pair_solve_tan_plain``,
``tan.tak_pair_solve_tan_plain``) at 1e-13 of the largest entry; the
assembled outputs to the JAX package's float64 scans at 1e-12 and to its
double-single tangent kernels in interpret mode at their envelope; and at
the north star's conditioning at the main paths' bar.  The CUDA kernels
have no CPU mode: their test is marked ``cuda`` and skips without a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asvgp_tpu.banded import ops as jops
from asvgp_tpu.banded import pallas_ds_tan as jpdt
from asvgp_tpu_torch.banded import core, tan
from test_torch_banded import _jax_factor_takahashi_solve
from test_torch_tan import inputs, interpret_small_tile  # noqa: F401 (a fixture)
from test_torch_twist_partition import k5_matrix, k6_matrix, north_star_bands, rel

BAR = 1e-13      # chip_smoke.py's bar on random bands (TOL_PARITY_ADJOINT)
BAR_JAX = 1e-12  # the JAX package's float64 scans
TOL_MAIN = 1e-8  # chip_smoke.py's bar on the main paths' arguments
# csrc/chunk_scan.cuh and csrc/schur_walk.cuh: the partitions' constants
SMEM_LIMIT, MAX_CHUNKS, TILE, MIN_CHUNK, SCHUR_CHUNK = 232448, 256, 64, 64, 128
K3_NAMES = ("l_kuu", "l_p", "iv", "c0", "ldot", "ivdot")
K4_NAMES = ("s_kuu", "s_p", "u", "sdot")


def chunk_cols(k, m):
    """(K3's, K4's) columns per chunk at (k, m), as ``chol_quad_chunk_cols``
    and ``tak_quad_chunk_cols`` give them for one stream of m columns: K3's
    walk stages K5's triple, 2(k² + k(k+1)) doubles a chunk (Kuu's dual
    triple, longer than P's); K4's scan a map of (2D)² + 2D, 2D = k(k+1);
    at least 128 / 64 columns, at most 256 chunks and as many as fit, a
    multiple of the tile."""
    dd = k * (k + 1)
    out = []
    for per, least in ((2 * (k * k + dd), SCHUR_CHUNK), (dd * dd + dd, MIN_CHUNK)):
        cap = min(MAX_CHUNKS, SMEM_LIMIT // (per * 8) + 1)
        lc = max(least, -(-m // cap))
        out.append(min(-(-lc // TILE) * TILE, m))
    return tuple(out)


def to_torch(arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def partitioned_k3(kuu, tanb, p, b, lc):
    """K3's outputs (l_kuu, l_p, iv, c0, ldot, ivdot) by the partition with
    chunks of lc columns, and the walks' records: Kuu's largest W and Ẇ,
    P's largest W and β, and each matrix's smallest eigenvalue of I − UᵀWU
    over its chunks."""
    (l_kuu, ldot, r_kuu, ivdot, _), rec_k = k5_matrix(kuu.numpy(), tanb.numpy(), True, lc)
    (l_p, _, r_p, _, c0), rec_p = k5_matrix(p.numpy(), b.numpy()[None], False, lc)
    recs = {"kuu_w": rec_k["w"], "kuu_wdot": rec_k["wdot"], "kuu_sigma": rec_k["sigma"],
            "p_w": rec_p["w"], "p_beta": rec_p["beta"], "p_sigma": rec_p["sigma"]}
    return to_torch((l_kuu, l_p, np.stack([r_kuu, r_p]), c0, ldot, ivdot)), recs


def partitioned_k4(l_kuu, l_p, iv, c0, ldot, ivdot, lc):
    """K4's outputs (s_kuu, s_p, u, sdot) by the partition with chunks of
    lc columns, both matrices from the zero carry, and the largest entry of
    the maps over the two."""
    k, m = l_kuu.shape[0] - 1, l_kuu.shape[1]
    zero = (np.zeros((k, k + 1)), np.zeros((k, k + 1)), np.zeros(k))
    (s_kuu, sdot, _), h_kuu = k6_matrix(l_kuu.numpy(), ldot.numpy(), iv[0].numpy(),
                                        ivdot.numpy(), np.zeros(m), zero, True, lc)
    (s_p, _, u), h_p = k6_matrix(l_p.numpy(), np.zeros((k + 1, m)), iv[1].numpy(), np.zeros(m),
                                 c0.numpy(), zero, False, lc)
    return to_torch((s_kuu, s_p, u, sdot)), max(h_kuu, h_p)


def check_against_plain(bands, lc3, lc4, tol):
    """Both partitions against the plain versions at ``tol``, K4 fed the
    plain K3's outputs (as the kernels' parity checks feed it); returns
    K3's walk records and K4's maps' largest entry."""
    k3, recs = partitioned_k3(*bands, lc3)
    want3 = tan.chol_pair_solve_tan_plain(*bands)
    for name, got, want in zip(K3_NAMES, k3, want3):
        assert rel(got, want) <= tol, name
    k4, h_max = partitioned_k4(*want3, lc4)
    for name, got, want in zip(K4_NAMES, k4, tan.tak_pair_solve_tan_plain(*want3)):
        assert rel(got, want) <= tol, name
    return recs, h_max


@pytest.mark.parametrize("k", range(1, 7))
def test_partitioned_tan_matches_plain(k):
    """K3's and K4's partitions on random SPD bands and a random symmetric
    tangent band against the plain versions at 1e-13 of the largest entry,
    at K3's chunks twice K4's (as 128 and 64 are): one chunk of each, a
    chunk plus one column, two chunks exactly and a ragged last chunk, and
    at m = k + 1."""
    lc = max(8, 2 * k)
    for m in (k + 1, lc, lc + 1, 2 * lc, 2 * lc + 1, 5 * lc + 3):
        check_against_plain(inputs(k, m, 13 * k + m), 2 * lc, lc, BAR)


def test_first_chunk_is_the_one_chain_recursion():
    """Each walk's first chunk starts from nothing (K3: W = Ẇ = 0, β = 0;
    K4: the zero carry), so the partitioned run's first chunk equals the
    one-chain recursion (the same emulation in one chunk) bit for bit: K3's
    first lc columns (the bands' rows inside the chunk), K4's last lc."""
    k, m, lc = 3, 5 * 16 + 3, 16
    bands = inputs(k, m, 11)
    inside = np.arange(k + 1)[:, None] + np.arange(lc)[None] < lc
    part3, _ = partitioned_k3(*bands, lc)
    one3, _ = partitioned_k3(*bands, m)
    for i, (got, one) in enumerate(zip(part3, one3)):  # the bands are l_kuu, l_p, ldot
        got, one = got.numpy()[..., :lc], one.numpy()[..., :lc]
        assert np.array_equal(got[inside], one[inside]) if i in (0, 1, 4) else \
            np.array_equal(got, one)
    part4, _ = partitioned_k4(*one3, lc // 2)
    one4, _ = partitioned_k4(*one3, m)
    for got, one in zip(part4, one4):
        assert np.array_equal(got.numpy()[..., m - lc // 2:], one.numpy()[..., m - lc // 2:])


def jax_scan_tan(kuu, tanb, p, b):
    """``tan.factor_takahashi_solve_tan``'s eight outputs from the JAX
    package's float64 scans: the seven of ``factor_takahashi_solve`` and
    Ṡ_Kuu by ``jax.jvp`` through its scan Cholesky and Takahashi."""
    with jops.impl_scope("scan"):
        seven = _jax_factor_takahashi_solve(kuu, p, b)
        _, sdot = jax.jvp(lambda a: jops.takahashi_inverse_band(jops.cholesky_band(a)),
                          (kuu,), (tanb,))
    return (*seven, sdot)


@pytest.mark.parametrize("k,m", [(2, 45), (3, 52)])
def test_assembled_partitions_match_jax_scans(k, m):
    """K3 + K4 by the partitions (16- and 8-column chunks), assembled as
    ``tan.factor_takahashi_solve_tan`` assembles them, against the JAX
    package's float64 scans, the tangent by ``jax.jvp``, at 1e-12."""
    bands = inputs(k, m, 3 * m)
    k3, _ = partitioned_k3(*bands, 16)
    k4, _ = partitioned_k4(*k3, 8)
    want = jax_scan_tan(*(jnp.asarray(t.numpy()) for t in bands))
    for name, got, w in zip(("l_kuu", "l_p", "s_kuu", "s_p", "c0", "u", "iv_kuu", "sdot"),
                            tan._assemble(k3, k4), want):
        assert rel(got, np.asarray(w)) <= BAR_JAX, name


def test_assembled_partitions_match_jax_interpret(interpret_small_tile):  # noqa: F811
    """The same against the JAX package's double-single tangent kernels
    (``factor_takahashi_solve_tan_ds``) in Pallas interpret mode, with 8-
    and 4-column chunks (three and six of them), at the envelope that
    ``tests/test_torch_tan.py`` holds the plain versions to: 3e-9 on the
    bands of the inverse, 1e-7 on u, 1e-13 on the rest."""
    k, m = 2, 24
    bands = inputs(k, m, 0)
    k3, _ = partitioned_k3(*bands, 8)
    k4, _ = partitioned_k4(*k3, 4)
    want = jpdt.factor_takahashi_solve_tan_ds(*(jnp.asarray(t.numpy()) for t in bands))
    tols = dict(l_kuu=1e-13, l_p=1e-13, s_kuu=3e-9, s_p=3e-9, c0=1e-13, u=1e-7, iv_kuu=1e-13,
                sdot_kuu=3e-9)
    for (name, tol), got, w in zip(tols.items(), tan._assemble(k3, k4), want):
        assert rel(got, np.asarray(w)) <= tol, name


def chol_tan_extended(a, t):
    """(L, L̇, 1/diag L, its tangent) of the one-chain recursion
    (``ops.cholesky_band_plain``'s, tapered) in numpy's extended precision
    (an 80-bit long double on x86: 64-bit significands)."""
    a, t = a.numpy().astype(np.longdouble), t.numpy().astype(np.longdouble)
    k, m = a.shape[0] - 1, a.shape[1]
    l, ld = np.zeros_like(a), np.zeros_like(a)
    for i in range(m):
        for j in range(min(k, m - 1 - i) + 1):
            s, sd = a[j, i], t[j, i]
            for q in range(1, k + 1 - j):
                if i - q >= 0:
                    s -= l[q, i - q] * l[q + j, i - q]
                    sd -= ld[q, i - q] * l[q + j, i - q] + l[q, i - q] * ld[q + j, i - q]
            if j == 0:
                l[0, i] = np.sqrt(s)
                ld[0, i] = sd / (2 * l[0, i])
            else:
                l[j, i] = s / l[0, i]
                ld[j, i] = (sd - l[j, i] * ld[0, i]) / l[0, i]
    return l, ld, 1 / l[0], -ld[0] / (l[0] * l[0])


@pytest.mark.parametrize("ell_over_delta", [10.0, 100.0])
def test_partitions_at_north_star_conditioning(ell_over_delta):
    """Kuu, T, P and Kuf·y of GPR1D at the north star's ℓ/δ = 10 and at 100
    (m = 320, B3, Matérn-3/2), at the kernels' chunks (128 and 64 columns:
    3 and 5 chunks).  K4 holds the main paths' bar against its plain
    version.  K3's Kuu outputs are held to the one-chain recursion in
    extended precision, each within the main paths' bar or 4× the plain
    float64 version's own distance from it, whichever is larger: at
    ℓ/δ = 100 (κ(Kuu) = 3.9e7, ``tools/f32_high_kappa.py``) the last
    column's pivot cancels most of its digits, so float64 fixes the
    tangent of its reciprocal only to about the main paths' bar relative
    to ivdot's largest entry, and the partition, whose walk rounds W and Ẇ
    before that pivot, lands a few times farther from the extended
    recursion than the plain version does.  P's outputs hold the main
    paths' bar against the plain version.  The walks' margins stay
    positive: σ_min of I − UᵀWU > 0 on both matrices; W, Ẇ, β and the maps
    finite."""
    bands = north_star_bands(ell_over_delta)
    lc3, lc4 = chunk_cols(3, bands[0].shape[1])
    assert (lc3, lc4) == (128, 64)
    k3, recs = partitioned_k3(*bands, lc3)
    want3 = tan.chol_pair_solve_tan_plain(*bands)
    exact = chol_tan_extended(bands[0], bands[1])
    for name, i, e in zip(("l_kuu", "ldot", "iv", "ivdot"), (0, 4, 2, 5), exact):
        got, plain = (k3[i][0], want3[i][0]) if name == "iv" else (k3[i], want3[i])
        assert rel(got, e) <= max(TOL_MAIN, 4 * rel(plain, e)), name
    for name, i in (("l_p", 1), ("iv_p", 2), ("c0", 3)):
        assert rel(k3[i], want3[i]) <= TOL_MAIN, name
    k4, h_max = partitioned_k4(*want3, lc4)
    for name, got, want in zip(K4_NAMES, k4, tan.tak_pair_solve_tan_plain(*want3)):
        assert rel(got, want) <= TOL_MAIN, name
    assert recs["kuu_sigma"] > 0 and recs["p_sigma"] > 0
    assert np.isfinite([recs[key] for key in ("kuu_w", "kuu_wdot", "p_w", "p_beta")] + [h_max]).all()


def test_non_spd_band_gives_nan_from_the_failing_column():
    """A non-positive pivot in Kuu or in P, in the first chunk, at a chunk
    edge or past it: K3's partition gives that matrix's factor and
    reciprocal pivots (Kuu: and their tangents; P: and c0) finite before
    the failing column and NaN from it on, as the plain version does; the
    other matrix is unaffected."""
    k, m, lc = 3, 100, 16
    with np.errstate(invalid="ignore", divide="ignore"):
        for fail, which in ((5, 0), (16, 2), (40, 0), (99, 2)):
            bands = inputs(k, m, fail)
            bands[which][0, fail] = -1.0
            got, _ = partitioned_k3(*bands, lc)
            want = tan.chol_pair_solve_tan_plain(*bands)
            for g_, w_ in zip(got, want):
                assert torch.equal(torch.isnan(g_), torch.isnan(w_))
                fin = ~torch.isnan(w_)
                assert rel(g_[fin], w_[fin]) <= BAR
            mine, other = (got[0], got[1]) if which == 0 else (got[1], got[0])
            nan_cols = torch.isnan(mine).any(0)
            assert not nan_cols[:fail].any() and nan_cols[fail:].all()
            assert torch.isnan(got[2][which // 2, fail:]).all()
            assert not torch.isnan(other).any()
            assert torch.isnan(got[4]).any() == (which == 0)
            assert torch.isnan(got[3][fail:]).all() == (which == 2)


def test_chunk_cols_fit_the_walk_and_the_scan():
    """K3's chunks are 128 columns at m = 10⁴ at every k (79 chunks), K4's
    64 for k ≤ 3, then 192, 320 and 640 (so that the scan's maps fit); at
    every m each walk's triples and each scan's maps fit in shared memory."""
    assert [chunk_cols(k, 10_000)[0] for k in range(1, 7)] == [128] * 6
    assert [chunk_cols(k, 10_000)[1] for k in range(1, 7)] == [64, 64, 64, 192, 320, 640]
    for k in range(1, 7):
        dd = k * (k + 1)
        for m in (1, 64, 65, 128, 129, 10_000, 100_000):
            for lc, per in zip(chunk_cols(k, m), (2 * (k * k + dd), dd * dd + dd)):
                maps = -(-m // lc) - 1
                assert maps * per * 8 <= SMEM_LIMIT and maps < MAX_CHUNKS
                assert lc == m or lc % TILE == 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA tangent sweeps have no CPU mode")
    return torch.device("cuda", 0)


# (k, m): one column; one chunk of K4 (64) and one more column; one chunk of
# K3 (128) and one more column; ragged last chunks of both; k = 3 and 6 at
# m = 10⁴ (K4's 640-column chunks at k = 6)
CUDA_EDGES = [(1, 1), (2, 64), (3, 65), (4, 128), (5, 129), (6, 165), (2, 293), (3, 10_000),
              (6, 10_000)]


@pytest.mark.cuda
@pytest.mark.parametrize("k, m", CUDA_EDGES)
def test_cuda_tan_sweeps_at_partition_edges(cuda_device, k, m):
    """K3 and K4 on the card against their plain versions at 1e-13, each
    call counted once, with the workspace of ``chunk_cols``'s chunks; each
    walk's first SCHUR_CHUNK (K3) or MIN_CHUNK (K4) columns, which lie in
    its first chunk at every length and, alone, form one chunk, equal bit
    for bit to the kernel on those columns alone (one pass, the one-chain
    recursion)."""
    lc3, lc4 = chunk_cols(k, m)
    dd = k * (k + 1)
    n3, n4 = -(-m // lc3) - 1, -(-m // lc4) - 1
    want = max(2 * n3 * (2 * (k * k + dd) + dd), 2 * n4 * (dd * dd + 2 * dd))
    assert core.tan_workspace(k, m) == (want + 1 if want else 0)  # + K4's chunk length
    bands = inputs(k, m, 60 + k)
    dev = cuda_device
    core.reset_counters()
    k3 = tan.chol_pair_solve_tan(*(t.to(dev) for t in bands))
    want3 = tan.chol_pair_solve_tan_plain(*bands)
    assert max(rel(g.cpu(), w) for g, w in zip(k3, want3)) <= BAR
    k4 = tan.tak_pair_solve_tan(*(t.to(dev) for t in want3))
    assert max(rel(g.cpu(), w) for g, w in zip(k4, tan.tak_pair_solve_tan_plain(*want3))) <= BAR
    c = min(SCHUR_CHUNK, m)
    one = tan.chol_pair_solve_tan(*(t[..., :c].contiguous().to(dev) for t in bands))
    inside = (torch.arange(k + 1)[:, None] + torch.arange(c)[None] < c).to(dev)
    for i, (a, o) in enumerate(zip(k3, one)):  # the bands' rows inside the chunk
        assert torch.equal(a[:, :c][inside], o[inside]) if i in (0, 1, 4) else \
            torch.equal(a[..., :c], o)
    c = min(MIN_CHUNK, m)
    one = tan.tak_pair_solve_tan(*(t[..., m - c:].contiguous().to(dev) for t in want3))
    assert all(torch.equal(a[..., m - c:], o) for a, o in zip(k4, one))
    torch.cuda.synchronize()
    assert {n: c for n, c in core.LAUNCHES.items() if c} == {"chol_pair_solve_tan": 2,
                                                              "tak_pair_solve_tan": 2}
