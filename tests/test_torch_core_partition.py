"""The partition of the serving sweeps: K1 (csrc/banded_core.cu
``chol_pair_solve<K>``) and K2 (``tak_pair_solve<K>``).

Both run two matrices, Kuu and P, one walk each over the m columns, cut
into chunks.  K1 is the Schur partition of the Cholesky sweep
(``chol_fwd``, ``tests/test_torch_forward_partition.py``) on both, and on P
it carries beside W the lower solve's coupling β = L[c₀:c₀+k, :c₀]·y[:c₀],
as K5's P role does (``tests/test_torch_twist_partition.py``).  K2 is the
affine partition of the Takahashi sweep (``tak_fwd``) on both, d read from
K1's reciprocal pivots, and on P it carries the upper solve's k-window
beside the window of S: a block-diagonal map, as K6's P role has, from a
zero carry instead of K6's seed.

K1 and K2 taper (rows past the last column are masked), K5 and K6 do not.
On a band whose right padding is zero, as every band here is, the two are
the same recursion: each padding entry is (0 − 0)·r, so every later sum
over padding entries is 0 too.  So the emulation runs Kuu through the
single-matrix partitions (``partitioned_chol``, ``partitioned_tak``) and P
through K5's and K6's P roles on one stream (``k5_matrix``,
``k6_matrix``), each in the kernels' order of operations (each fused
multiply-add as a product and a sum), and holds the assembled outputs to
the plain versions (``core.chol_pair_solve_plain``,
``core.tak_pair_solve_plain``) at 1e-13 of the largest entry, to the JAX
package's float64 scans at 1e-12, and at the north star's conditioning at
the main paths' bar.  The CUDA kernels have no CPU mode: their test is
marked ``cuda`` and skips without a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asvgp_tpu.banded import ops as jops
from asvgp_tpu_torch.banded import core
from test_torch_banded import _jax_factor_takahashi_solve
from test_torch_forward_partition import partitioned_chol, partitioned_tak, rel, spd_band
from test_torch_twist_partition import k5_matrix, k6_matrix, north_star_bands

BAR = 1e-13      # chip_smoke.py's bar on random bands (TOL_PARITY_ADJOINT)
BAR_JAX = 1e-12  # the JAX package's float64 scans
TOL_MAIN = 1e-8  # chip_smoke.py's bar on the main paths' arguments
# csrc/chunk_scan.cuh and csrc/schur_walk.cuh: the partitions' constants
SMEM_LIMIT, MAX_CHUNKS, TILE, MIN_CHUNK, SCHUR_CHUNK = 232448, 256, 64, 64, 128
NAMES = ("l_kuu", "l_p", "iv", "c0", "s_kuu", "s_p", "u")


def chunk_cols(k, m):
    """(K1's, K2's) columns per chunk at (k, m), as ``core_chol_cols`` and
    ``core_tak_cols`` give them: K1's walk stages a triple of
    k² + k(k+1) + 2k doubles a chunk (P's p0 and r0 beside (U, Q, R)); K2's
    scan a map of DD² + DD, DD = k(k+1)/2 + k; at least 128 / 64 columns, at
    most 256 chunks and as many as fit, a multiple of the tile."""
    dd = k * (k + 1) // 2 + k
    out = []
    for per, least in ((k * k + k * (k + 1) + 2 * k, SCHUR_CHUNK), (dd * dd + dd, MIN_CHUNK)):
        cap = min(MAX_CHUNKS, SMEM_LIMIT // (per * 8) + 1)
        lc = max(least, -(-m // cap))
        out.append(min(-(-lc // TILE) * TILE, m))
    return tuple(out)


def partitioned_k1(kuu, p, b, lc):
    """K1's outputs (l_kuu, l_p, iv, c0) by the partition with chunks of lc
    columns, and the walks' records: Kuu's largest W and smallest singular
    value of I − W P, P's largest W and β and smallest eigenvalue of
    I − UᵀWU."""
    l_kuu, w_kuu, s_kuu = partitioned_chol(kuu.numpy(), lc)
    (l_p, _, r_p, _, c0), rec = k5_matrix(p.numpy(), b.numpy()[None], False, lc)
    # the kernel's reciprocal pivot is 1 / L[i, i], the same division
    iv = np.stack([1.0 / l_kuu[0], r_p])
    recs = {"kuu_w": w_kuu, "kuu_sigma": s_kuu, "p_w": rec["w"], "p_beta": rec["beta"],
            "p_sigma": rec["sigma"]}
    return tuple(torch.from_numpy(np.ascontiguousarray(t)) for t in (l_kuu, l_p, iv, c0)), recs


def partitioned_k2(l_kuu, l_p, iv, c0, lc):
    """K2's outputs (s_kuu, s_p, u) by the partition with chunks of lc
    columns, from a zero carry, and the largest entry of the maps over the
    two matrices."""
    s_kuu, h_kuu = partitioned_tak(l_kuu.numpy(), lc)
    k, m = l_kuu.shape[0] - 1, l_kuu.shape[1]
    zero = (np.zeros((k, k + 1)), np.zeros((k, k + 1)), np.zeros(k))
    (s_p, _, u), h_p = k6_matrix(l_p.numpy(), np.zeros((k + 1, m)), iv[1].numpy(), np.zeros(m),
                                 c0.numpy(), zero, False, lc)
    out = tuple(torch.from_numpy(np.ascontiguousarray(t)) for t in (s_kuu, s_p, u))
    return out, max(h_kuu, h_p)


def random_problem(k, m, seed):
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(spd_band(k, m, rng)), torch.from_numpy(spd_band(k, m, rng)),
            torch.from_numpy(rng.randn(m)))


def check_against_plain(kuu, p, b, lc1, lc2, tol):
    """Both partitions against the plain versions at ``tol``, K2 fed the
    plain K1's outputs (as the kernels' parity checks feed it); returns
    K1's walk records and K2's maps' largest entry."""
    k1, recs = partitioned_k1(kuu, p, b, lc1)
    want1 = core.chol_pair_solve_plain(kuu, p, b)
    for name, got, want in zip(NAMES, k1, want1):
        assert rel(got, want) <= tol, name
    k2, h_max = partitioned_k2(*want1, lc2)
    for name, got, want in zip(NAMES[4:], k2, core.tak_pair_solve_plain(*want1)):
        assert rel(got, want) <= tol, name
    return recs, h_max


@pytest.mark.parametrize("k", range(1, 7))
def test_partitioned_core_matches_plain(k):
    """K1's and K2's partitions on random SPD bands against the plain
    versions at 1e-13 of the largest entry, at K1's chunks twice K2's (as
    128 and 64 are): one chunk of each, a chunk plus one column, two
    chunks exactly and a ragged last chunk, and at m = k + 1."""
    lc = max(8, 2 * k)
    for m in (k + 1, lc, lc + 1, 2 * lc, 2 * lc + 1, 5 * lc + 3):
        check_against_plain(*random_problem(k, m, 13 * k + m), 2 * lc, lc, BAR)


def test_first_chunk_is_the_one_chain_recursion():
    """Each walk's first chunk starts from nothing (K1: W = 0, β = 0; K2:
    the zero carry), so the partitioned run's first chunk equals the
    one-chain recursion (the same emulation in one chunk) bit for bit: K1's
    first lc columns (their rows inside the chunk), K2's last lc."""
    k, m, lc = 3, 5 * 16 + 3, 16
    kuu, p, b = random_problem(k, m, 11)
    inside = np.arange(k + 1)[:, None] + np.arange(lc)[None] < lc
    part1, _ = partitioned_k1(kuu, p, b, lc)
    one1, _ = partitioned_k1(kuu, p, b, m)
    for i, (got, one) in enumerate(zip(part1, one1)):
        got, one = got.numpy()[..., :lc], one.numpy()[..., :lc]
        assert np.array_equal(got[inside], one[inside]) if i < 2 else np.array_equal(got, one)
    part2, _ = partitioned_k2(*one1, lc // 2)
    one2, _ = partitioned_k2(*one1, m)
    for got, one in zip(part2, one2):
        assert np.array_equal(got.numpy()[..., m - lc // 2:], one.numpy()[..., m - lc // 2:])


@pytest.mark.parametrize("k,m", [(2, 45), (3, 52)])
def test_assembled_partitions_match_jax_scans(k, m):
    """K1 + K2 by the partitions (16- and 8-column chunks), assembled as
    ``core.factor_takahashi_solve`` assembles them, against the JAX
    package's float64 scans as ``tests/test_torch_banded.py`` computes them,
    at 1e-12."""
    kuu, p, b = random_problem(k, m, 3 * m)
    k1, _ = partitioned_k1(kuu, p, b, 16)
    k2, _ = partitioned_k2(*k1, 8)
    emulated = core._assemble(k1, k2)
    with jops.impl_scope("scan"):
        want = _jax_factor_takahashi_solve(*(jnp.asarray(t.numpy()) for t in (kuu, p, b)))
    for name, got, w in zip(("l_kuu", "l_p", "s_kuu", "s_p", "c0", "u", "iv_kuu"),
                            emulated, want):
        assert rel(got, np.asarray(w)) <= BAR_JAX, name


@pytest.mark.parametrize("ell_over_delta", [10.0, 100.0])
def test_partitions_at_north_star_conditioning(ell_over_delta):
    """Kuu, P and Kuf·y of GPR1D at the north star's ℓ/δ = 10 and at 100
    (m = 320, B3, Matérn-3/2), at the kernels' chunks (128 and 64 columns:
    3 and 5 chunks): both partitions hold the main paths' bar against the
    plain versions, and the walks' margins stay positive: σ_min of
    I − W P and of I − UᵀWU > 0 on both matrices, W, β and the maps
    finite."""
    kuu, _, p, b = north_star_bands(ell_over_delta)
    recs, h_max = check_against_plain(kuu, p, b, *chunk_cols(3, kuu.shape[1]), TOL_MAIN)
    assert recs["kuu_sigma"] > 0 and recs["p_sigma"] > 0
    assert np.isfinite([recs["kuu_w"], recs["p_w"], recs["p_beta"], h_max]).all()


def test_non_spd_band_gives_nan_from_the_failing_column():
    """A non-positive pivot in Kuu or in P, in the first chunk, at a chunk
    edge or past it: K1's partition gives that matrix's factor and
    reciprocal pivots (and, for P, c0) finite before the failing column and
    NaN from it on, as the plain version does; the other matrix is
    unaffected."""
    k, m, lc = 3, 100, 16
    with np.errstate(invalid="ignore", divide="ignore"):
        for fail, which in ((5, 0), (16, 1), (40, 0), (99, 1)):
            kuu, p, b = random_problem(k, m, fail)
            (kuu, p)[which][0, fail] = -1.0
            got, _ = partitioned_k1(kuu, p, b, lc)
            want = core.chol_pair_solve_plain(kuu, p, b)
            for g_, w_ in zip(got, want):
                assert torch.equal(torch.isnan(g_), torch.isnan(w_))
                fin = ~torch.isnan(w_)
                assert rel(g_[fin], w_[fin]) <= BAR
            nan_cols = torch.isnan(got[which]).any(0)
            assert not nan_cols[:fail].any() and nan_cols[fail:].all()
            assert torch.isnan(got[2][which, fail:]).all()
            assert not torch.isnan(got[1 - which]).any()
            assert torch.isnan(got[3][fail:]).all() == (which == 1)


def test_chunk_cols_fit_the_walk_and_the_scan():
    """K1's chunks are 128 columns at m = 10⁴ at every k (79 chunks), K2's
    64 for k ≤ 3, then 128, 192 and 320 (so that the scan's maps fit); at every
    m each walk's triples and each scan's maps fit in shared memory."""
    assert [chunk_cols(k, 10_000)[0] for k in range(1, 7)] == [128] * 6
    assert [chunk_cols(k, 10_000)[1] for k in range(1, 7)] == [64, 64, 64, 128, 192, 320]
    for k in range(1, 7):
        dd = k * (k + 1) // 2 + k
        for m in (1, 64, 65, 128, 129, 10_000, 100_000):
            for lc, per in zip(chunk_cols(k, m), (k * k + k * (k + 1) + 2 * k, dd * dd + dd)):
                maps = -(-m // lc) - 1
                assert maps * per * 8 <= SMEM_LIMIT and maps < MAX_CHUNKS
                assert lc == m or lc % TILE == 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA serving sweeps have no CPU mode")
    return torch.device("cuda", 0)


# (k, m): one column; one chunk of K2 (64) and one more column; one chunk of
# K1 (128) and one more column; ragged last chunks of both; k = 3 and 6 at
# m = 10⁴ (K2's 320-column chunks at k = 6)
CUDA_EDGES = [(1, 1), (2, 64), (3, 65), (4, 128), (5, 129), (6, 165), (2, 293), (3, 10_000),
              (6, 10_000)]


@pytest.mark.cuda
@pytest.mark.parametrize("k, m", CUDA_EDGES)
def test_cuda_core_sweeps_at_partition_edges(cuda_device, k, m):
    """K1 and K2 on the card against their plain versions at 1e-13, each
    call counted once, with the workspace of ``chunk_cols``'s chunks; each
    walk's first SCHUR_CHUNK (K1) or MIN_CHUNK (K2) columns, which lie in
    its first chunk at every length and, alone, form one chunk, equal bit
    for bit to the kernel on those columns alone (one pass, the one-chain
    recursion)."""
    lc1, lc2 = chunk_cols(k, m)
    d, dd = k * (k + 1) // 2, k * (k + 1) // 2 + k
    n1, n2 = -(-m // lc1) - 1, -(-m // lc2) - 1
    want = max(2 * n1 * (k * k + 2 * d + 2 * k + dd), 2 * n2 * (dd * dd + 2 * dd))
    assert core.core_workspace(k, m) == (want + 1 if want else 0)  # + K2's chunk length
    kuu, p, b = random_problem(k, m, 60 + k)
    dev = cuda_device
    core.reset_counters()
    k1 = core.chol_pair_solve(kuu.to(dev), p.to(dev), b.to(dev))
    want1 = core.chol_pair_solve_plain(kuu, p, b)
    assert max(rel(g.cpu(), w) for g, w in zip(k1, want1)) <= BAR
    k2 = core.tak_pair_solve(*(t.to(dev) for t in want1))
    assert max(rel(g.cpu(), w) for g, w in zip(k2, core.tak_pair_solve_plain(*want1))) <= BAR
    c = min(SCHUR_CHUNK, m)
    one = core.chol_pair_solve(*(t[..., :c].contiguous().to(dev) for t in (kuu, p, b)))
    inside = (torch.arange(k + 1)[:, None] + torch.arange(c)[None] < c).to(dev)
    for i, (a, o) in enumerate(zip(k1, one)):  # the two factors, then iv and c0
        assert torch.equal(a[:, :c][inside], o[inside]) if i < 2 else torch.equal(a[..., :c], o)
    c = min(MIN_CHUNK, m)
    one = core.tak_pair_solve(*(t[..., m - c:].contiguous().to(dev) for t in want1))
    assert all(torch.equal(a[..., m - c:], o) for a, o in zip(k2, one))
    torch.cuda.synchronize()
    assert {n: c for n, c in core.LAUNCHES.items() if c} == {"chol_pair_solve": 2,
                                                              "tak_pair_solve": 2}
