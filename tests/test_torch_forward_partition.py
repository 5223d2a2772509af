"""The partition of the forward banded sweeps: the Cholesky K9, K15 and K17
(csrc/banded_adjoint.cu ``chol_fwd<K, T>``) and the Takahashi band of the
inverse K11 and K19 (``tak_fwd<K, T>``).

The Takahashi sweep walks the columns m-1..0 carrying the window of S it
has written, whose D = k(k+1)/2 read entries are affine in what it carries
given L (the d² term is the particular part).  So it is cut as the
adjoints are (``tests/test_torch_adjoint_partition.py``): each chunk's
affine map from D homogeneous chains and one particular chain, a scan over
the maps, the plain recursion from the true incoming windows.

The Cholesky sweep takes square roots and divides of what it carries, so
its chunks are joined by what the columns before a chunk subtract from its
first k rows: the k×k Schur-complement update W = L[c₀:c₀+k, :c₀]·
L[c₀:c₀+k, :c₀]ᵀ.  Over chunk c, with A_c its diagonal block, U the
Cholesky factor of P = (A_c⁻¹)[:k, :k] and (Q̃, R̃) what the chunk's last
columns send to the next chunk's first rows,
    W_{c+1} = R̃ + Q̃ᵀ (I − W_c P)⁻¹ W_c Q̃
            = R̃ + G₂₂ + YᵀY,   G = [U Q̃]ᵀ W_c [U Q̃],  Y = F⁻¹ G₁₂,
with F the Cholesky factor of N = I − G₁₁ = I − Uᵀ W_c U, which is
positive definite exactly when the chunk's true Schur complement is.  Pass
1 factors every chunk from W = 0 and substitutes V = L_c⁻¹ E (E the first k
unit columns) along the way, so P = VᵀV, Q̃ = V_lastᵀ Xᵀ, R̃ = X Xᵀ with X
the chunk's last columns' entries in the next chunk's rows; pass 2 walks W
over the chunks; pass 3 reruns the plain recursion on each chunk with W
subtracted from its first k rows.

A numpy emulation of both partitions, in the kernels' order of operations
(each fused multiply-add as a product and a sum) and in the working dtype,
is held here to the plain versions (``ops.cholesky_band_plain``,
``ops.takahashi_inverse_band_plain``) and to the JAX package's scans at
the bars ``chip_smoke.py`` holds the kernels to.  The CUDA kernels have no
CPU mode: their tests are marked ``cuda`` and skip without a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asvgp_tpu.banded import ops as jops
from asvgp_tpu_torch.banded import chunk_rule, core, ops, single
from asvgp_tpu_torch.basis import B3Spline
from asvgp_tpu_torch.features.spline_features import make_kuu
from asvgp_tpu_torch.models import GPR1D, Matern32

CHUNK = 64  # columns per chunk of the Takahashi sweep at k = 3, m = 10⁴
CHOL_CHUNK = 128  # of the Cholesky sweep
# chip_smoke.py's bars on random bands (TOL_PARITY_ADJOINT, TOL_F32_FWD) and
# on the main paths' arguments (TOL_PARITY_MAIN)
BARS = {np.float64: 1e-13, np.float32: 1e-5}
TOL_MAIN = 1e-8
# csrc/chunk_scan.cuh and csrc/banded_adjoint.cu: the partition's constants
SMEM_LIMIT, MAX_CHUNKS, TILE = 232448, 256, 64
TWO_CHUNK_COLS = 512  # the Takahashi sweep's two-chunk limit (``kTwoChunkCols``)


def chunk_cols(k, m, tak):
    """Columns per chunk (``carry_chunk_cols`` for the Takahashi sweep,
    whose scan stages (D² + D) doubles a map, D = k(k+1)/2;
    ``schur_chunk_cols`` for the Cholesky sweep, whose walk stages
    k² + k(k+1) doubles a chunk): at least 64 (Takahashi) or 128
    (Cholesky), at most 256 chunks and as many as fit, a multiple of the
    64-column tile; the Takahashi sweep's at most two chunks up to 512
    columns."""
    d = k * (k + 1) // 2
    per = d * d + d if tak else k * k + k * (k + 1)
    cap = min(MAX_CHUNKS, SMEM_LIMIT // (per * 8) + 1)
    lc = max(CHUNK if tak else CHOL_CHUNK, -(-m // cap))
    if tak and m <= TWO_CHUNK_COLS:
        lc = max(lc, -(-m // 2))
    return min(-(-lc // TILE) * TILE, m)


def tak_slots(k):
    """The D entries of the Takahashi window the step reads, in the
    kernel's packing order: cs[c][r] = S[j+1+c+r, j+1+c], r < k - c."""
    return [(c, r) for c in range(k) for r in range(k - c)]


def chunked(a, nb, nc, lc, shift=0):
    """(rows, nb·nc, lc): positions j·lc + shift + t of every chunk of a
    (nb, rows, positions) array."""
    pos = (np.arange(nc)[:, None] * lc + shift + np.arange(lc)[None]).reshape(-1)
    rows = a.shape[1]
    return a[..., pos].reshape(nb, rows, nc, lc).transpose(1, 0, 2, 3).reshape(rows, nb * nc, lc)


def by_walk(a, n, dt, down):
    """(nb, rows, n) of a (nb, rows, m) band by walk position (column m-1-u
    walking down, u walking up), past the end a column with a 1 on the
    diagonal and nothing else."""
    m = a.shape[-1]
    out = np.zeros(a.shape[:2] + (n,), dt)
    out[..., :m] = a[..., ::-1] if down else a
    out[:, 0, m:] = 1
    return out


def walk_masks(m, n, kp1, nb, nc, lc, down, dt):
    cols = (m - 1 - np.arange(n)) if down else np.arange(n)
    mask = (cols[None, :] + np.arange(kp1)[:, None] < m).astype(dt)[None]
    return chunked(np.broadcast_to(mask, (nb, kp1, n)), nb, nc, lc)


def unwalk(got, nb, m, down):
    """(nb, k+1, m) from the (k+1, nb·nc, lc) outputs by walk position."""
    kp1 = got.shape[0]
    got = got.reshape(kp1, nb, -1).transpose(1, 0, 2)[..., :m]
    return got[..., ::-1] if down else got


# ---------------------------------------------------------------------------
# K11 / K19: tak_fwd<K, T>
# ---------------------------------------------------------------------------


def tak_step(cs, lcol, mask, part, dt):
    """One column of ``tak_fwd``: the window cs (k, k+1, ...), L's column;
    the d² term scaled by ``part`` (0 in the homogeneous chains).  Returns
    (window of the next column, S's column), rounded as the kernel rounds."""
    k = cs.shape[0]
    d = dt(1) / lcol[0]
    sq = [None] * (k + 1)
    for q in range(1, k + 1):
        acc = np.zeros_like(d)
        for p in range(1, k + 1):
            lo, df = min(p, q), abs(q - p)
            acc = cs[lo - 1, df] * lcol[p] + acc
        sq[q] = (-d) * acc
    ws = np.zeros_like(d)
    for q in range(1, k + 1):
        ws = lcol[q] * sq[q] + ws
    col = np.stack([(d * d) * part - d * ws] + [sq[q] * mask[q] for q in range(1, k + 1)])
    return np.concatenate([col[None], cs[:-1]]), col


def partitioned_tak(l, lc, refine=False):
    """S = tak_fwd(L) by the kernel's three passes, in ``l``'s dtype, for
    nb (k+1, m) bands (or one), and the largest entry of the composed
    maps.  The walk (columns m-1..0) is cut into chunks of ``lc``
    positions from its start.  ``refine`` refinements between the scan and
    pass 3, as the kernel's (every chunk but the last rerun from the
    windows before, its final window the next chunk's)."""
    dt = l.dtype.type
    one = l.ndim == 2
    l = l[None] if one else l
    nb, kp1, m = l.shape
    k = kp1 - 1
    nc = -(-m // lc)
    n = nc * lc
    lcols = chunked(by_walk(l, n, dt, True), nb, nc, lc)
    masks = walk_masks(m, n, kp1, nb, nc, lc, True, dt)
    slots = tak_slots(k)
    dd = len(slots)

    def sweep(cs, part):
        outs = []
        for t in range(lc):
            cs, col = tak_step(cs, lcols[:, :, t, None], masks[:, :, t, None], part, dt)
            outs.append(col)
        return cs, outs

    # pass 1: D homogeneous chains (window e_d, no d²) and one particular
    # chain (window 0, the d² term)
    cs = np.zeros((k, kp1, nb * nc, dd + 1), dt)
    for e, (c, r) in enumerate(slots):
        cs[c, r, :, e] = 1
    part = np.zeros(dd + 1, dt)
    part[dd] = 1
    cs, _ = sweep(cs, part)
    packed = np.stack([cs[c, r] for c, r in slots]).reshape(dd, nb, nc, dd + 1)
    h, y = packed[..., :dd].transpose(1, 2, 0, 3), packed[..., dd].transpose(1, 2, 0)
    # pass 2: the incoming windows, w_{j+1} = y_j + H_j w_j from w_0 = 0
    win = np.zeros((nb, nc, dd), dt)
    for j in range(nc - 1):
        win[:, j + 1] = y[:, j] + np.einsum("bpq,bq->bp", h[:, j], win[:, j])
    for _ in range(int(refine)):
        cs = np.zeros((k, kp1, nb * nc, 1), dt)
        for e, (c, r) in enumerate(slots):
            cs[c, r, :, 0] = win[:, :, e].reshape(-1)
        cs, _ = sweep(cs, np.ones(1, dt))
        out = np.stack([cs[c, r, :, 0] for c, r in slots], axis=-1).reshape(nb, nc, dd)
        win = np.concatenate([np.zeros_like(win[:, :1]), out[:, :-1]], axis=1)
    # pass 3: the plain recursion from the true windows, writing S
    cs = np.zeros((k, kp1, nb * nc, 1), dt)
    for e, (c, r) in enumerate(slots):
        cs[c, r, :, 0] = win[:, :, e].reshape(-1)
    _, outs = sweep(cs, np.ones(1, dt))
    got = unwalk(np.stack(outs, axis=-1)[..., 0, :], nb, m, True)
    h_max = float(np.abs(h[:, :-1]).max()) if nc > 1 else 0.0
    return (got[0] if one else got), h_max


# ---------------------------------------------------------------------------
# K9 / K15 / K17: chol_fwd<K, T>
# ---------------------------------------------------------------------------


def chol_step(w, ac, mask, dt):
    """One column of ``chol_fwd``: the window w (k, k+1, ...) of the last k
    columns of L, A's column; returns (the next window, L's column, the
    reciprocal pivot), rounded as the kernel rounds."""
    k = w.shape[0]
    s = [np.zeros_like(ac[0]) for _ in range(k + 1)]
    for q in range(1, k + 1):
        g = w[q - 1, q]
        for j in range(k + 1 - q):
            s[j] = g * w[q - 1, q + j] + s[j]
    l0 = np.sqrt(ac[0] - s[0])
    rv = dt(1) / l0
    col = np.stack([l0] + [((ac[j] - s[j]) * rv) * mask[j] for j in range(1, k + 1)])
    return np.concatenate([col[None], w[:-1]]), col, rv


def chol_lower(a, dt):
    """Cholesky factor of the (k, k, ...) SPD matrices a, column by column
    as the walk kernel takes it: d = sqrt(a_jj - Σ f²), f_ij = (a_ij - Σ)/d."""
    k = a.shape[0]
    f = np.zeros_like(a)
    for j in range(k):
        acc = a[j, j]
        for p in range(j):
            acc = acc - f[j, p] * f[j, p]
        f[j, j] = np.sqrt(acc)
        rv = dt(1) / f[j, j]
        for i in range(j + 1, k):
            acc = a[i, j]
            for p in range(j):
                acc = acc - f[i, p] * f[j, p]
            f[i, j] = acc * rv
    return f


def schur_triples(acol, masks, wdt):
    """Pass 1 over every chunk of ``acol`` ((k+1, nb, nc, lc) A columns by
    chunk, in the working dtype): the chunk's plain recursion from W = 0
    and, along it, V = L_c⁻¹ E; returns (U, Q̃, R̃) of every chunk but the
    last, each (nb, nc-1, k, k) in ``wdt``."""
    dt = acol.dtype.type
    kp1, nb, nc, lc = acol.shape
    k = kp1 - 1
    acol = acol.reshape(kp1, nb * nc, lc)
    w = np.zeros((k, kp1, nb * nc), dt)
    vw = np.zeros((k, k, nb * nc), dt)  # vw[p-1][e] = V row t-p
    p_acc = np.zeros((k, k, nb * nc), dt)
    for t in range(lc):
        g = [w[p - 1, p] for p in range(1, k + 1)]
        w, _, rv = chol_step(w, acol[:, :, t], masks[:, :, t], dt)
        vnew = np.zeros((k, nb * nc), dt)
        for e in range(k):
            acc = np.full(nb * nc, dt(t == e))
            for p in range(1, k + 1):
                acc = (-g[p - 1]) * vw[p - 1, e] + acc
            vnew[e] = acc * rv
        for e in range(k):
            for f in range(e, k):
                p_acc[e, f] = vnew[e] * vnew[f] + p_acc[e, f]
        vw = np.concatenate([vnew[None], vw[:-1]])
    # X[a][b] = L[c1+a, c1-k+b] = w[k-1-b][k+a-b] (a <= b), V_last[b] = vw[k-1-b]
    x = np.zeros((k, k, nb * nc), wdt)
    for a_ in range(k):
        for b in range(a_, k):
            x[a_, b] = w[k - 1 - b, k + a_ - b]
    vl = np.stack([vw[k - 1 - b] for b in range(k)]).astype(wdt)  # vl[b][e]
    pm = np.zeros((k, k, nb * nc), wdt)
    for e in range(k):
        for f in range(e, k):
            pm[e, f] = pm[f, e] = p_acc[e, f]
    u = chol_lower(pm, wdt)
    qt = np.zeros((k, k, nb * nc), wdt)
    rt = np.zeros((k, k, nb * nc), wdt)
    for e in range(k):
        for a_ in range(k):
            acc = np.zeros(nb * nc, wdt)
            for b in range(k):
                acc = vl[b, e] * x[a_, b] + acc
            qt[e, a_] = acc
    for a_ in range(k):
        for c in range(a_, k):
            acc = np.zeros(nb * nc, wdt)
            for b in range(k):
                acc = x[a_, b] * x[c, b] + acc
            rt[a_, c] = rt[c, a_] = acc
    out = [t.reshape(k, k, nb, nc).transpose(2, 3, 0, 1)[:, :-1] for t in (u, qt, rt)]
    return out


def smallest_singular_value(w, u):
    """σ_min(I − W P) over (nb, k, k) pairs of W and P = U Uᵀ, the finite
    ones (∞ when none is)."""
    k = w.shape[-1]
    m = np.eye(k) - w.astype(np.float64) @ (u @ u.transpose(0, 2, 1)).astype(np.float64)
    fin = np.isfinite(m).all(axis=(1, 2))
    return float(np.linalg.svd(m[fin], compute_uv=False).min()) if fin.any() else np.inf


def schur_walk(u, qt, rt, wdt):
    """Pass 2: W_{c+1} = R̃ + G₂₂ + YᵀY from W_0 = 0 over the chunks of
    each matrix; returns the incoming W of every chunk (nb, nc, k, k) and
    the smallest singular value of I − W_c P_c over the chunks."""
    nb, nmap, k, _ = u.shape
    win = np.zeros((nb, nmap + 1, k, k), wdt)
    s_min = np.inf
    eye = np.eye(k, dtype=wdt)
    for c in range(nmap):
        wc = win[:, c]
        s_min = min(s_min, smallest_singular_value(wc, u[:, c]))
        j = np.concatenate([u[:, c], qt[:, c]], axis=2)  # (nb, k, 2k)
        z = np.einsum("bij,bjl->bil", wc, j)
        g = np.einsum("bji,bjl->bil", j, z)
        nmat = eye - g[:, :k, :k]
        f = chol_lower(nmat.transpose(1, 2, 0), wdt).transpose(2, 0, 1)
        y = np.empty((nb, k, k), wdt)
        for i in range(k):  # forward substitution F Y = G12
            acc = g[:, i, k:].copy()
            for p in range(i):
                acc = acc - f[:, i, p, None] * y[:, p]
            y[:, i] = acc * (wdt(1) / f[:, i, i, None])
        wn = rt[:, c] + g[:, k:, k:] + np.einsum("bpi,bpj->bij", y, y)
        win[:, c + 1] = np.triu(wn) + np.triu(wn, 1).transpose(0, 2, 1)
    return win, s_min


def partitioned_chol(a, lc, wdt=None):
    """L = chol_fwd(A) by the kernel's three passes, in ``a``'s dtype (the
    triples and the walk in ``wdt``, default the same), for nb (k+1, m)
    bands (or one); returns (L, the largest entry of W, the smallest
    singular value of I − W P over the chunks)."""
    dt = a.dtype.type
    wdt = wdt or dt
    one = a.ndim == 2
    a = a[None] if one else a
    nb, kp1, m = a.shape
    k = kp1 - 1
    nc = -(-m // lc)
    n = nc * lc
    acol = chunked(by_walk(a, n, dt, False), nb, nc, lc)
    masks = walk_masks(m, n, kp1, nb, nc, lc, False, dt)
    w_max, s_min = 0.0, np.inf
    win = np.zeros((nb, nc, k, k), dt)
    if nc > 1:
        triples = schur_triples(acol.reshape(kp1, nb, nc, lc), masks, wdt)
        w_all, s_min = schur_walk(*triples, wdt)
        win = w_all.astype(dt)
        w_max = float(np.abs(w_all).max())
    # pass 3: each chunk's plain recursion with W subtracted from its first
    # k rows (rows past the band's end are zero in W and masked anyway)
    acol = acol.copy()
    wflat = win.reshape(nb * nc, k, k)
    for t in range(min(k, lc)):
        for j in range(k - t):
            acol[j, :, t] = acol[j, :, t] - wflat[:, t, t + j]
    w = np.zeros((k, kp1, nb * nc), dt)
    outs = []
    for t in range(lc):
        w, col, _ = chol_step(w, acol[:, :, t], masks[:, :, t], dt)
        outs.append(col)
    got = unwalk(np.stack(outs, axis=-1), nb, m, False)
    return (got[0] if one else got), w_max, s_min


# ---------------------------------------------------------------------------
# the emulation against the plain versions
# ---------------------------------------------------------------------------


def spd_band(k, m, rng, zero_outer=False):
    a = 0.3 * rng.randn(k + 1, m)
    a[0] = np.abs(a[0]) + 2.0 * k + 1.0
    if zero_outer:
        a[k] = 0.0
    for j in range(1, k + 1):
        a[j, m - j:] = 0.0
    return a


def rel(got, want):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want.detach() if isinstance(want, torch.Tensor) else want, np.float64)
    assert got.shape == want.shape
    return float(np.nanmax(np.abs(got - want)) / np.nanmax(np.abs(want)))


def random_case(k, m, nb, seed, zero_outer=False):
    """nb random SPD bands (zero_outer: with a zero outer diagonal, so the
    coupling blocks and W are singular), their factors and Takahashi
    bands, float64 tensors of shape (nb, k+1, m)."""
    rng = np.random.RandomState(seed)
    a = torch.stack([torch.from_numpy(spd_band(k, m, rng, zero_outer)) for _ in range(nb)])
    l = torch.stack([ops.cholesky_band_plain(x) for x in a])
    s = torch.stack([ops.takahashi_inverse_band_plain(x) for x in l])
    return a, l, s


def plain_chol(a):
    return torch.stack([ops.cholesky_band_plain(x) for x in a])


def plain_tak(l):
    return torch.stack([ops.takahashi_inverse_band_plain(x) for x in l])


@pytest.mark.parametrize("k", range(1, 7))
@pytest.mark.parametrize("sweep", ["chol_fwd", "tak_fwd"])
def test_partitioned_forward_matches_plain(k, sweep):
    """K9/K15/K17's (``chol_fwd``) and K11/K19's (``tak_fwd``) partitions on
    random SPD bands against the plain versions, at m = 1000 (several
    chunks and a ragged one) and m = 40 (one chunk at 64 columns), one and
    two matrices, with and without a zero outer diagonal, in float64 and
    float32 (the triples, the walk and the maps in the working dtype), at
    64- and 8-column chunks."""
    for m in (1000, 40):
        for nb in (1, 2):
            for zero_outer in (False, True):
                a, l, _ = random_case(k, m, nb, 30 * k + 2 * nb + zero_outer, zero_outer)
                for dt, tdt in ((np.float64, torch.float64), (np.float32, torch.float32)):
                    ah, lh = a.to(tdt), l.to(tdt)
                    for lc in (CHUNK, 8):
                        if sweep == "chol_fwd":
                            got, w_max, s_min = partitioned_chol(ah.numpy(), lc)
                            want = plain_chol(ah)
                            assert np.isfinite(w_max) and s_min > 0
                        else:
                            got, h_max = partitioned_tak(lh.numpy(), lc)
                            want = plain_tak(lh)
                            assert np.isfinite(h_max)
                        assert got.dtype == dt
                        assert rel(got, want) <= BARS[dt], (m, nb, zero_outer, dt, lc)
                        pad = np.arange(k + 1)[:, None] + np.arange(m)[None] >= m
                        assert (got[:, pad] == 0).all()


def test_cholesky_chunk_cols_fit_the_walk():
    """The Cholesky sweep's chunk length: 128 columns at m = 10⁴ at every k,
    one chunk for m <= 128, and every triple of a matrix within the walk's
    shared memory (the Takahashi sweep's are the adjoints',
    ``tests/test_torch_adjoint_partition.py``)."""
    assert [chunk_cols(k, 10_000, False) for k in range(1, 7)] == [128] * 6
    for k in range(1, 7):
        for m in (1, 40, 128, 129, 10_000, 100_000):
            lc = chunk_cols(k, m, False)
            chunks = -(-m // lc) - 1
            assert chunks * (k * k + k * (k + 1)) * 8 <= SMEM_LIMIT and chunks < MAX_CHUNKS
            assert lc == m or lc % TILE == 0


def gpr_factors(ell_over_delta, m=320):
    """Kuu and P = Kuu + KufKfu/σ² (the GPR1D P band, the SVGP's C* seed)
    and their factors, for B3 × Matérn-3/2 at ℓ = ell_over_delta/m on
    [0, 1], N = 100 m points, noise 0.1, float64 tensors."""
    rng = np.random.RandomState(5)
    x = rng.uniform(0.005, 0.995, 100 * m)
    y = np.sin(140.8 * x) + 0.5 * np.sin(35.2 * x) + 0.3 * rng.randn(x.shape[0])
    kernel, basis = Matern32(1.0, ell_over_delta / m), B3Spline(0.0, 1.0, m)
    model = GPR1D((x, y), kernel, basis, noise_variance=0.1, device="cpu")
    with torch.no_grad():
        kuu = make_kuu(kernel, basis)
        p_band = model.kufkfu_band / 0.1 + kuu
    return [(a, ops.cholesky_band_plain(a)) for a in (kuu, p_band)]


def check_on_factors(ell_over_delta, tol, dtype=np.float64):
    """Both partitions at the kernels' chunks on Kuu and P, in ``dtype``,
    against the plain versions in that dtype; returns the largest entry of
    W, the smallest singular value of I − W P and the largest entry of the
    Takahashi maps over the two."""
    w_max, s_min, h_max = 0.0, np.inf, 0.0
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    for a, l in gpr_factors(ell_over_delta):
        a, l = a.to(tdt), l.to(tdt)
        got, w1, s1 = partitioned_chol(a.numpy(), CHOL_CHUNK)
        assert rel(got, ops.cholesky_band_plain(a)) <= tol
        got, h1 = partitioned_tak(l.numpy(), CHUNK)
        assert rel(got, ops.takahashi_inverse_band_plain(l)) <= tol
        w_max, s_min, h_max = max(w_max, w1), min(s_min, s1), max(h_max, h1)
    return w_max, s_min, h_max


def test_takahashi_two_chunks_at_additive_conditioning():
    """Up to 512 columns the Takahashi sweep takes at most two chunks (128
    at m = 250), so its scan applies no map to a nonzero carry: at the
    additive model's Kuu (B3 × Matérn-3/2, m = 250, ℓ = 0.2, κ ≈ 2.9e6) the
    partition at the kernel's chunks equals the one-chunk run, where
    64-column chunks (four, maps above 10) lie more than ten times farther
    from the plain version."""
    kernel, basis = Matern32(1.0, 0.2), B3Spline(0.0, 1.0, 250)
    with torch.no_grad():
        l = ops.cholesky_band_plain(make_kuu(kernel, basis))
    lc = chunk_cols(3, 250, True)
    assert lc == 128 and chunk_cols(3, 513, True) == CHUNK
    one, _ = partitioned_tak(l.numpy(), 250)
    got, _ = partitioned_tak(l.numpy(), lc)
    assert np.array_equal(got, one)
    want = ops.takahashi_inverse_band_plain(l)
    four, h_max = partitioned_tak(l.numpy(), CHUNK)
    assert h_max > 10.0 and rel(four, want) > 10 * rel(got, want)


@pytest.mark.parametrize("m", [1000, 2000])
def test_takahashi_past_two_chunks_at_additive_conditioning(m):
    """Past 512 columns the two-chunk rule ends and the chunk-length rule
    (``banded/chunk_rule.py``) chooses the Takahashi sweep's chunks from
    the factor: at the additive model's ℓ/δ = 49.4, 256 columns (maps
    below 1e-2), within 5e-13 of the one-chunk run; at the north star's
    ℓ/δ = 10 (maps below 1e-5) the partition's 64, within 1e-14.  The
    mechanism the rule avoids: at ℓ/δ = 49.4, 64-column chunks (maps above
    10) leave S more than 5e-12 from the one-chunk run."""
    assert chunk_cols(3, m, True) == CHUNK
    for ell_over_delta, want_lc, h_in, tol in ((49.4, 256, (0.0, 1e-2), (0.0, 5e-13)),
                                               (10.0, CHUNK, (0.0, 1e-5), (0.0, 1e-14))):
        kernel, basis = Matern32(1.0, ell_over_delta / (m - 3)), B3Spline(0.0, 1.0, m)
        with torch.no_grad():
            l = ops.cholesky_band_plain(make_kuu(kernel, basis))
        lc = chunk_rule.sweep_cols([l.numpy()], chunk_cols(3, m, True), chunk_rule.TAU)
        assert lc == want_lc
        one, _ = partitioned_tak(l.numpy(), m)
        got, h_max = partitioned_tak(l.numpy(), lc)
        assert h_in[0] < h_max < h_in[1] and tol[0] <= rel(got, one) < tol[1]
        if ell_over_delta > 10.0:
            old, h_old = partitioned_tak(l.numpy(), CHUNK)
            assert h_old > 10.0 and rel(old, one) > 5e-12


def test_partition_at_north_star_conditioning():
    """Kuu and P at the north star's ℓ/δ = 10 (m = 320, B3, Matérn-3/2):
    both partitions hold the main paths' bar in float64 and TOL_F32_MAIN
    (1e-4) in float32, the Takahashi maps decay below 1e-6 within a chunk
    and I − W P stays far from singular (σ_min 9.3e-3)."""
    w_max, s_min, h_max = check_on_factors(10.0, TOL_MAIN)
    assert h_max <= 1e-6 and 1e-3 <= s_min <= 1.0 and 1.0 <= w_max <= 1e3
    check_on_factors(10.0, 1e-4, np.float32)


def test_partition_at_high_conditioning():
    """At ℓ/δ = 100, κ(Kuu) is far higher: W grows to ~1e5, σ_min(I − W P)
    falls to ~2e-5 and the Takahashi maps to hundreds; both partitions
    still hold the main paths' bar in float64, relative to the largest
    entry."""
    w_max, s_min, h_max = check_on_factors(100.0, TOL_MAIN)
    assert h_max > 1.0 and 0.0 < s_min <= 1e-4 and w_max > 1e4


def test_non_spd_band_gives_nan_from_the_failing_column():
    """A non-positive pivot in any chunk: the partition's factor is finite
    before the failing column and NaN from it on, as the plain version's
    is (N = I − Uᵀ W U loses definiteness with the chunk's true Schur
    complement, so the walk carries NaN to every later chunk)."""
    rng = np.random.RandomState(3)
    with np.errstate(invalid="ignore", divide="ignore"):
        for k in (1, 3, 6):
            for fail in (5, 64, 100, 130, 299):
                a = spd_band(k, 300, rng)
                a[0, fail] = -1.0
                want = ops.cholesky_band_plain(torch.from_numpy(a)).numpy()
                got, _, _ = partitioned_chol(a, CHUNK)
                for x in (want, got):
                    nan_cols = np.isnan(x).any(axis=0)
                    assert not nan_cols[:fail].any() and nan_cols[fail:].all()
                assert rel(got[:, :fail], want[:, :fail]) <= BARS[np.float64]


def test_partition_matches_jax_scans():
    """The emulation against the JAX package's float64 ``cholesky_band``
    and ``takahashi_inverse_band`` scans, on a band of three 8-column
    chunks and a ragged one."""
    rng = np.random.RandomState(7)
    a = spd_band(3, 30, rng)
    l = ops.cholesky_band_plain(torch.from_numpy(a)).numpy()
    with jops.impl_scope("scan"):
        want_l = np.asarray(jops.cholesky_band(jnp.asarray(a)))
        want_s = np.asarray(jops.takahashi_inverse_band(jnp.asarray(l)))
    got, _, _ = partitioned_chol(a, 8)
    assert rel(got, want_l) <= BARS[np.float64]
    got, _ = partitioned_tak(l, 8)
    assert rel(got, want_s) <= BARS[np.float64]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA forward sweeps have no CPU mode")
    return torch.device("cuda", 0)


# (k, m, nb): one column; one chunk (m < 64, m = 64); a ragged last chunk
# of one column (the Takahashi's at 65, the Cholesky's at 129); the
# Takahashi sweep's two-chunk rule (the additive model's m = 250, 192 + 65
# columns at 257, 256 + 256 at 512, 64-column chunks from 513); two
# matrices (K15); 4097 columns; k = 6 at m = 10⁴
EDGES = [(1, 1, 1), (3, 40, 1), (6, 64, 1), (2, 65, 1), (2, 129, 1), (3, 250, 1),
         (3, 257, 1), (3, 512, 1), (3, 513, 1), (3, 1000, 2), (4, 4097, 1),
         (3, 10_000, 1), (6, 10_000, 1), (6, 10_000, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("k, m, nb", EDGES)
def test_cuda_forward_sweeps_at_partition_edges(cuda_device, k, m, nb):
    """K9/K17 (``single.chol_fwd``), K15 (``single.chol_fwd_pair``) and
    K11/K19 (``single.tak_fwd``) on the card against their plain versions,
    each call counted once, with the workspaces of ``chunk_cols``'s
    chunks; the first chunk of each walk equal bit for bit to the kernel
    on that chunk alone (one pass, the one-chain recursion)."""
    d = k * (k + 1) // 2
    maps = -(-m // chunk_cols(k, m, False)) - 1
    assert core.schur_workspace(k, m, nb) == nb * maps * (k * k + 3 * d)
    maps = -(-m // chunk_cols(k, m, True)) - 1
    assert core.carry_workspace(k, m, nb) == (nb * maps * (d * d + 2 * d) + 1 if maps else 0)
    a, l, s = random_case(k, m, nb, 60 + k)
    dev = cuda_device
    core.reset_counters()
    if nb == 2:
        got = single.chol_fwd_pair(a[0].to(dev), a[1].to(dev))
        assert max(rel(g.cpu(), w) for g, w in zip(got, l)) <= BARS[np.float64]
        want = {"chol_fwd_pair": 1}
    else:
        want = {}
        for dtype, suffix, tol in ((torch.float64, "", BARS[np.float64]),
                                   (torch.float32, "_f32", BARS[np.float32])):
            ah, lh = a[0].to(dtype), l[0].to(dtype)
            got_l = single.chol_fwd(ah.to(dev)).cpu()
            got_s = single.tak_fwd(lh.to(dev)).cpu()
            assert got_l.dtype == dtype and rel(got_l, single.chol_fwd_plain(ah)) <= tol
            assert rel(got_s, single.tak_fwd_plain(lh)) <= tol
            # every chunk spans at least CHUNK columns, so the first CHUNK of
            # a walk lie in its first chunk and, alone, form one chunk
            c = min(CHUNK, m)
            one = single.chol_fwd(ah[:, :c].contiguous().to(dev)).cpu()
            inside = np.arange(k + 1)[:, None] + np.arange(c)[None] < c
            assert torch.equal(got_l[:, :c][inside], one[inside])
            one = single.tak_fwd(lh[:, m - c:].contiguous().to(dev)).cpu()
            assert torch.equal(got_s[:, m - c:], one)
            want |= {"chol_fwd" + suffix: 2, "tak_fwd" + suffix: 2}
    torch.cuda.synchronize()
    assert {n: c for n, c in core.LAUNCHES.items() if c} == want
