"""The partition of the banded Cholesky and Takahashi adjoints: K10, K8 and
K18 (csrc/banded_adjoint.cu ``chol_bwd<K, T>``), K12, K7, K20 and K23
(``tak_bwd<K, T>``).

Given L, both adjoints carry state that is affine in the cotangent: the
Cholesky adjoint walks the columns m-1..0 carrying P[q][r] (the adjoint
sent to column i-1-q, nonzero for r >= q+1), the Takahashi adjoint walks
0..m-1 carrying Q[c][r] (sent to S column j+1+c, nonzero for
c + r <= k-1); both carries have D = k(k+1)/2 entries, and only L (and the
reciprocal pivots of K7) enter their update.  So each kernel cuts its walk
into chunks (64 columns at k = 3, m = 10⁴; longer at larger k, see
``chunk_cols``), builds every chunk's affine map from its incoming carry to
its outgoing one (D homogeneous chains and one particular chain), scans the
maps for the true incoming carries, and reruns the plain recursion from
them, writing the outputs.  A numpy emulation of those three passes, in the
kernel's order of operations (each fused multiply-add as a product and a
sum) and in the working dtype, is held here to the plain versions
(``ops.cholesky_band_bwd_plain``, ``ops.takahashi_bwd_plain``) at the bars
``chip_smoke.py`` holds the kernels to: 1e-13 (float64) and 1e-4 (float32)
relative to the largest entry on random SPD bands, 1e-8 on the factors of
the north star's conditioning (ℓ/δ = 10), where the composed maps stay
below 1, and 1e-8 at ℓ/δ = 100, where they do not.

The CUDA kernels have no CPU mode: their tests are marked ``cuda`` and skip
without a card; there each wrapper is held to its plain version at the
partition's edges.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asvgp_tpu.banded import ops as jops
from asvgp_tpu_torch import banded
from asvgp_tpu_torch.banded import chunk_rule, core, ops, single
from asvgp_tpu_torch.basis import B3Spline
from asvgp_tpu_torch.features.spline_features import make_kuu
from asvgp_tpu_torch.models import GPR1D, Matern32

CHUNK = 64  # columns per chunk of csrc/banded_adjoint.cu at k <= 4, m = 10⁴
# chip_smoke.py's bars: random bands (TOL_PARITY_ADJOINT, TOL_F32_ADJOINT)
BARS = {np.float64: 1e-13, np.float32: 1e-4}
TOL_MAIN = 1e-8  # the main paths' arguments (TOL_PARITY_MAIN)
# csrc/chunk_scan.cuh and csrc/banded_adjoint.cu: the scan stages every map
# of a matrix in shared memory, so the chunk count is bounded by what fits
SMEM_LIMIT, MIN_CHUNK, MAX_CHUNKS, TILE = 232448, 64, 256, 64
TWO_CHUNK_COLS = 512  # up to here at most two chunks (``kTwoChunkCols``)


def chunk_cols(k, m):
    """Columns per chunk of ``chol_bwd<K, T>`` and ``tak_bwd<K, T>``
    (``carry_chunk_cols``): at least 64, at most as many chunks as the
    scan can stage the maps of ((D² + D) doubles each, D = k(k+1)/2) and at
    most 256, a multiple of the 64-column tile, and at most two chunks up to
    512 columns."""
    d = k * (k + 1) // 2
    cap = min(MAX_CHUNKS, SMEM_LIMIT // ((d * d + d) * 8) + 1)
    lc = max(MIN_CHUNK, -(-m // cap))
    if m <= TWO_CHUNK_COLS:
        lc = max(lc, -(-m // 2))
    return min(-(-lc // TILE) * TILE, m)


def carry_slots(k, chol):
    """The D nonzero slots of the carry, in the kernel's packing order:
    P[q][r], r = q+1..k (Cholesky), or Q[c][r], r = 0..k-1-c (Takahashi)."""
    if chol:
        return [(q, r) for q in range(k) for r in range(q + 1, k + 1)]
    return [(c, r) for c in range(k) for r in range(k - c)]


def chol_step(P, lcol, W, cot, mask, dt):
    """One column of ``chol_bwd``: the carry P (k, k+1, ...), L's column
    ``lcol`` and window W[p-1] = L column i-p, the cotangent column; returns
    (P, ā of the column), rounded as the kernel rounds."""
    k = P.shape[0]
    lb = (cot + P[0]) * mask
    iv = dt(1) / lcol[0]
    t1 = np.zeros_like(lb[0])
    for r in range(1, k + 1):
        t1 = lb[r] * lcol[r] + t1
    ab = [(lb[0] - t1 * iv) * (dt(0.5) * iv)] + [lb[r] * iv for r in range(1, k + 1)]
    P = np.concatenate([P[1:], np.zeros_like(P[:1])])
    for p in range(1, k + 1):
        g = W[p - 1, p]
        gbar = np.zeros_like(ab[0])
        for j in range(k + 1 - p):
            gbar = (-ab[j]) * W[p - 1, p + j] + gbar
        for r in range(p, k + 1):
            P[p - 1, r] = (-ab[r - p]) * g + P[p - 1, r]
        P[p - 1, p] = P[p - 1, p] + gbar
    return P, np.stack(ab)


def tak_step(Q, lcol, d, cot, mask, dt, sc=None, cs=None):
    """One column of ``tak_bwd``: the carry Q (k, k+1, ...), L's column, the
    reciprocal pivot d, the cotangent column; with S's column ``sc`` and
    window cs[c] = S column j+1+c also L̄'s column.  Returns (Q, L̄'s column
    or None), rounded as the kernel rounds."""
    k = Q.shape[0]
    out = sc is not None
    cb = (cot + Q[0]) * mask
    l0 = lcol[0]
    m1 = d * cb[0]
    tb, wb = [None] * (k + 1), [None] * (k + 1)
    if out:
        ws = np.zeros_like(m1)
        for q in range(1, k + 1):
            ws = lcol[q] * sc[q] + ws
        db = dt(2) * m1 - ws * cb[0]
    for q in range(1, k + 1):
        sb = cb[q] - m1 * lcol[q]
        if out:
            db = db - sb * ((-sc[q]) * l0)
            wb[q] = (-m1) * sc[q]
        tb[q] = (-d) * sb
    Q = np.concatenate([Q[1:], np.zeros_like(Q[:1])])
    for q in range(1, k + 1):
        for p in range(1, k + 1):
            lo, df = min(p, q), abs(q - p)
            if out:
                wb[p] = tb[q] * cs[lo - 1, df] + wb[p]
            Q[lo - 1, df] = tb[q] * lcol[p] + Q[lo - 1, df]
    if not out:
        return Q, None
    return Q, np.stack([((-db) * d) * d] + wb[1:])


def partitioned(l, cot, lc, s=None, iv=None, chol=True, refine=False):
    """Ā = chol_bwd(L, L̄) (``chol``) or L̄ = tak_bwd(L, S, S̄[, iv]) by the
    kernel's three passes, in ``l``'s dtype, for nb (k+1, m) bands (or one),
    and the largest entry of the composed maps; ``refine`` refinements
    between the scan and pass 3, as the kernels' (every chunk but the last
    rerun from the carries before, its final carry the next chunk's).  The walk (columns m-1..0
    for the Cholesky adjoint, 0..m-1 for the Takahashi one) is cut into
    chunks of ``lc`` positions from its start; each pass runs every chunk
    of every matrix at once.  Positions past the walk's end are columns
    with pivot 1 and nothing else, whose outputs are dropped."""
    dt = l.dtype.type
    one = l.ndim == 2
    l, cot = (x[None] if one else x for x in (l, cot))
    s = None if s is None else (s[None] if one else s)
    iv = None if iv is None else (iv[None] if one else iv)
    nb, kp1, m = l.shape
    k = kp1 - 1
    nc = -(-m // lc)
    n = nc * lc
    walk = (lambda a: a[..., ::-1]) if chol else (lambda a: a)

    def by_walk(a, extra, diag=False):
        """(nb, rows, n + extra) of ``a``'s columns by walk position, zero
        past the end (the diagonal 1 there when ``diag``)."""
        out = np.zeros(a.shape[:2] + (n + extra,), dt)
        out[..., :m] = walk(a)
        if diag:
            out[:, 0, m:] = 1
        return out

    def chunked(a, shift=0):
        """(rows, nb·nc, lc): the positions j·lc + shift + t of every chunk."""
        pos = (np.arange(nc)[:, None] * lc + shift + np.arange(lc)[None]).reshape(-1)
        return a[..., pos].reshape(nb, a.shape[1], nc, lc).transpose(1, 0, 2, 3).reshape(
            a.shape[1], nb * nc, lc)

    lw = by_walk(l, kp1)
    lcols = chunked(by_walk(l, kp1, diag=True))
    cots = chunked(by_walk(cot, 0))
    u = np.arange(n)
    cols = (m - 1 - u) if chol else u
    mask = (cols[None, :] + np.arange(kp1)[:, None] < m).astype(dt)[None]
    masks = chunked(np.broadcast_to(mask, (nb, kp1, n)))
    if chol:
        # window W[p-1] of position u: L column i-p, at walk position u+p
        wins = np.stack([chunked(lw, p) for p in range(1, kp1)])
    else:
        ivs = chunked(by_walk(
            (dt(1) / l[:, :1]) if iv is None else iv[:, None], 0, diag=True))[0]
        if s is not None:
            sw = by_walk(s, kp1)
            scs = chunked(sw)
            css = np.stack([chunked(sw, 1 + c) for c in range(k)])
    slots = carry_slots(k, chol)
    dd = len(slots)

    def sweep(carry, cot_on, outputs):
        """Every chunk from ``carry`` (k, k+1, nb·nc, chains); ``cot_on``
        (chains,) says which chains take the cotangent."""
        outs = []
        for t in range(lc):
            c = cots[:, :, t, None] * cot_on
            mk = masks[:, :, t, None]
            lcol = lcols[:, :, t, None]
            if chol:
                carry, o = chol_step(carry, lcol, wins[:, :, :, t, None], c, mk, dt)
            else:
                d = ivs[:, t, None] if iv is not None else dt(1) / lcol[0]
                extra = (scs[:, :, t, None], css[:, :, :, t, None]) if outputs else ()
                carry, o = tak_step(carry, lcol, d, c, mk, dt, *extra)
            outs.append(o)
        return carry, outs

    # pass 1: D homogeneous chains (carry e_d, no cotangent) and one
    # particular chain (carry 0, the cotangent); the final carries are the
    # chunk's map, outgoing = y + H incoming
    carry = np.zeros((k, kp1, nb * nc, dd + 1), dt)
    for e, (q, r) in enumerate(slots):
        carry[q, r, :, e] = 1
    cot_on = np.zeros(dd + 1, dt)
    cot_on[dd] = 1
    carry, _ = sweep(carry, cot_on, False)
    packed = np.stack([carry[q, r] for q, r in slots]).reshape(dd, nb, nc, dd + 1)
    h, y = packed[..., :dd].transpose(1, 2, 0, 3), packed[..., dd].transpose(1, 2, 0)
    # pass 2: the incoming carries, w_{j+1} = y_j + H_j w_j from w_0 = 0
    win = np.zeros((nb, nc, dd), dt)
    for j in range(nc - 1):
        win[:, j + 1] = y[:, j] + np.einsum("bpq,bq->bp", h[:, j], win[:, j])
    for _ in range(int(refine)):
        carry = np.zeros((k, kp1, nb * nc, 1), dt)
        for e, (q, r) in enumerate(slots):
            carry[q, r, :, 0] = win[:, :, e].reshape(-1)
        fin, _ = sweep(carry, np.ones(1, dt), False)
        out = np.stack([fin[q, r, :, 0] for q, r in slots], axis=-1).reshape(nb, nc, dd)
        win = np.concatenate([np.zeros_like(win[:, :1]), out[:, :-1]], axis=1)
    # pass 3: the plain recursion from the true carries, writing the outputs
    carry = np.zeros((k, kp1, nb * nc, 1), dt)
    for e, (q, r) in enumerate(slots):
        carry[q, r, :, 0] = win[:, :, e].reshape(-1)
    _, outs = sweep(carry, np.ones(1, dt), True)
    got = np.stack(outs, axis=-1)[..., 0, :]  # (k+1, nb·nc, lc)
    got = got.reshape(kp1, nb, n).transpose(1, 0, 2)[..., :m]
    got = walk(got)
    h_max = float(np.abs(h[:, :-1]).max()) if nc > 1 else 0.0
    return (got[0] if one else got), h_max


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


def adjoint_inputs(k, m, nb, seed):
    """nb random SPD bands' (L, S = Takahashi band, L̄, S̄), float64 tensors
    of shape (nb, k+1, m)."""
    rng = np.random.RandomState(seed)
    ls = [ops.cholesky_band_plain(torch.from_numpy(spd_band(k, m, rng))) for _ in range(nb)]
    l = torch.stack(ls)
    s = torch.stack([ops.takahashi_inverse_band_plain(x) for x in ls])
    l_bar, s_bar = (torch.from_numpy(rng.randn(nb, k + 1, m)) for _ in range(2))
    return l, s, l_bar, s_bar


def plain(l, cot, s=None, iv=None, chol=True):
    """The plain version of each matrix of the batch."""
    if chol:
        return torch.stack([ops.cholesky_band_bwd_plain(a, c) for a, c in zip(l, cot)])
    ivs = [None] * len(l) if iv is None else iv
    return torch.stack([ops.takahashi_bwd_plain(a, b, c, v)
                        for a, b, c, v in zip(l, s, cot, ivs)])


def check_on_random_bands(k, chol, with_iv=False):
    """The emulation against the plain version at m = 1000 (several chunks
    and a ragged one) and m = 40 (one chunk), one and two matrices, in
    float64 and float32, at 64- and 8-column chunks."""
    for m in (1000, 40):
        for nb in (1, 2):
            l, s, l_bar, s_bar = adjoint_inputs(k, m, nb, 80 + 10 * k + nb)
            for dt, tdt in ((np.float64, torch.float64), (np.float32, torch.float32)):
                lh, sh = l.to(tdt), s.to(tdt)
                cot = (l_bar if chol else s_bar).to(tdt)
                iv = (1.0 / lh[:, 0]).contiguous() if with_iv else None
                want = plain(lh, cot, sh, iv, chol)
                args = dict(s=None if chol else sh.numpy(),
                            iv=None if iv is None else iv.numpy(), chol=chol)
                for lc in (CHUNK, 8):
                    got, h_max = partitioned(lh.numpy(), cot.numpy(), lc, **args)
                    assert got.dtype == dt and np.isfinite(h_max)
                    assert rel(got, want) <= BARS[dt], (m, nb, dt, lc)
                    pad = (banded.mask_lower_band(torch.ones_like(lh[0])) == 0).numpy()
                    assert (got[:, pad] == 0).all()


@pytest.mark.parametrize("k", range(1, 7))
def test_partitioned_chol_bwd_matches_plain(k):
    """K10/K8/K18's partition on random SPD bands; the first chunk holds
    column m-1 and starts from P = 0, the ragged one column 0."""
    check_on_random_bands(k, chol=True)


@pytest.mark.parametrize("k", range(1, 7))
@pytest.mark.parametrize("with_iv", [False, True], ids=["divide", "iv"])
def test_partitioned_tak_bwd_matches_plain(k, with_iv):
    """K12/K20's partition (dividing for the pivots) and K7/K23's (the
    reciprocal pivots given) on random SPD bands; the maps need L, S̄ and
    the pivots, not S."""
    check_on_random_bands(k, chol=False, with_iv=with_iv)


def test_chunk_cols_fit_the_scan():
    """The chunk length: 64 columns at k <= 4 and m = 10⁴, longer at k = 5,
    6 so that every map of a matrix fits the scan's shared memory, one
    chunk for m <= 64."""
    assert [chunk_cols(k, 10_000) for k in range(1, 7)] == [64, 64, 64, 64, 128, 192]
    for k in range(1, 7):
        d = k * (k + 1) // 2
        for m in (1, 40, 64, 65, 10_000, 100_000):
            lc = chunk_cols(k, m)
            maps = -(-m // lc) - 1
            assert maps * (d * d + d) * 8 <= SMEM_LIMIT and maps < MAX_CHUNKS
            assert lc == m or lc % TILE == 0


def svgp_factors(ell_over_delta, m=320):
    """L = chol(Kuu) and the SVGP's R = chol(Kuu + KufKfu/σ²) (its C* seed,
    the GPR1D P band) for B3 × Matérn-3/2 at ℓ = ell_over_delta/m on
    [0, 1], N = 100 m points, noise 0.1, float64 tensors."""
    rng = np.random.RandomState(5)
    x = rng.uniform(0.005, 0.995, 100 * m)
    y = np.sin(140.8 * x) + 0.5 * np.sin(35.2 * x) + 0.3 * rng.randn(x.shape[0])
    kernel, basis = Matern32(1.0, ell_over_delta / m), B3Spline(0.0, 1.0, m)
    model = GPR1D((x, y), kernel, basis, noise_variance=0.1, device="cpu")
    with torch.no_grad():
        kuu = make_kuu(kernel, basis)
        p_band = model.kufkfu_band / 0.1 + kuu
    return [ops.cholesky_band_plain(a) for a in (kuu, p_band)]


def check_on_factors(factors, tol, h_bound=None):
    """Both adjoints' emulation at 64-column chunks on each factor, with a
    random cotangent and S its Takahashi band, against the plain versions,
    relative to the largest entry; returns the maps' largest entry."""
    rng = np.random.RandomState(11)
    h_all = 0.0
    for l in factors:
        s = ops.takahashi_inverse_band_plain(l)
        cot = torch.from_numpy(rng.randn(*l.shape))
        got, h1 = partitioned(l.numpy(), cot.numpy(), CHUNK)
        assert rel(got, ops.cholesky_band_bwd_plain(l, cot)) <= tol
        for iv in (None, 1.0 / l[0]):
            got, h2 = partitioned(l.numpy(), cot.numpy(), CHUNK, s=s.numpy(),
                                  iv=None if iv is None else iv.numpy(), chol=False)
            assert rel(got, ops.takahashi_bwd_plain(l, s, cot, iv)) <= tol
            h_all = max(h_all, h1, h2)
    if h_bound is not None:
        assert h_all <= h_bound
    return h_all


def additive_kuu_factor():
    """L = chol(Kuu) of the additive model at ADDITIVE_PROBE.json's width:
    B3 × Matérn-3/2, m = 250 on [0, 1], ℓ = 0.2 (ℓ/δ = 49, κ ≈ 2.9e6)."""
    kernel, basis = Matern32(1.0, 0.2), B3Spline(0.0, 1.0, 250)
    with torch.no_grad():
        return ops.cholesky_band_plain(make_kuu(kernel, basis))


def test_two_chunks_keep_the_one_pass_at_additive_conditioning():
    """Up to 512 columns the adjoints take at most two chunks (128 at
    m = 250), so the scan applies no map to a nonzero carry: at the additive
    model's Kuu the partition at the kernels' chunks equals the one-chunk
    run, where 64-column chunks (four, maps above 10) lie more than ten
    times farther from it."""
    l = additive_kuu_factor()
    s = ops.takahashi_inverse_band_plain(l)
    cot = np.random.RandomState(12).randn(*l.shape)
    lc = chunk_cols(3, 250)
    assert lc == 128 and chunk_cols(3, 512) == 256 and chunk_cols(3, 513) == CHUNK
    for kwargs in ({}, {"s": s.numpy(), "chol": False}):
        one, _ = partitioned(l.numpy(), cot, 250, **kwargs)
        got, h_max = partitioned(l.numpy(), cot, lc, **kwargs)
        assert np.array_equal(got, one)
        four, h_max = partitioned(l.numpy(), cot, CHUNK, **kwargs)
        assert h_max > 10.0 and rel(four, one) > 10 * rel(got, one)


def kuu_factor(m, ell_over_delta):
    """L = chol(Kuu) for B3 × Matérn-3/2 at m features on [0, 1] and
    ℓ = ell_over_delta·δ, δ = 1/(m − 3)."""
    kernel, basis = Matern32(1.0, ell_over_delta / (m - 3)), B3Spline(0.0, 1.0, m)
    with torch.no_grad():
        return ops.cholesky_band_plain(make_kuu(kernel, basis))


@pytest.mark.parametrize("m", [1000, 2000])
def test_partition_past_two_chunks_at_additive_conditioning(m):
    """Past 512 columns the two-chunk rule ends and the chunk-length rule
    (``banded/chunk_rule.py``) chooses the kernels' chunks from the factor:
    at the additive model's ℓ/δ = 49.4, 256 columns, where the maps fall
    below 1e-2 and both adjoints lie within 5e-13 of the one-chunk run, at
    m = 1000 as at 2000; at the north star's ℓ/δ = 10 (maps below 1e-5)
    it keeps the partition's 64 columns, within 1e-14.  The mechanism the
    rule avoids: at ℓ/δ = 49.4, 64-column chunks (maps above 10) leave
    both adjoints more than 5e-13 from the one-chunk run; the loss follows
    the maps' size, not m."""
    assert chunk_cols(3, m) == CHUNK
    cot = np.random.RandomState(12).randn(4, m)
    for ell_over_delta, want_lc, h_in, tol in ((49.4, 256, (0.0, 1e-2), (0.0, 5e-13)),
                                               (10.0, CHUNK, (0.0, 1e-5), (0.0, 1e-14))):
        l = kuu_factor(m, ell_over_delta)
        lc = chunk_rule.sweep_cols([l.numpy()], chunk_cols(3, m), chunk_rule.TAU)
        assert lc == want_lc
        s = ops.takahashi_inverse_band_plain(l)
        for kwargs in ({}, {"s": s.numpy(), "chol": False}):
            one, _ = partitioned(l.numpy(), cot, m, **kwargs)
            got, h_max = partitioned(l.numpy(), cot, lc, **kwargs)
            assert h_in[0] < h_max < h_in[1] and tol[0] <= rel(got, one) < tol[1]
            if ell_over_delta > 10.0:
                old, h_old = partitioned(l.numpy(), cot, CHUNK, **kwargs)
                assert h_old > 10.0 and rel(old, one) > 5e-13


def test_partition_at_north_star_conditioning():
    """L = chol(Kuu) and the SVGP's R at the north star's ℓ/δ = 10 (m = 320,
    B3, Matérn-3/2): the maps decay below 1 within a chunk and the
    partition holds at the main paths' bar."""
    check_on_factors(svgp_factors(10.0), TOL_MAIN, h_bound=1.0)


def test_partition_at_high_conditioning():
    """At ℓ/δ = 100, κ(Kuu) is far higher and the 64-column maps no longer
    decay below 1; the partition still holds at the main paths' bar,
    relative to the largest entry."""
    h_max = check_on_factors(svgp_factors(100.0), TOL_MAIN)
    assert h_max > 1.0


def test_partition_matches_jax_scan_vjp():
    """The emulation against ``jax.vjp`` of the JAX package's float64
    ``cholesky_band`` and ``takahashi_inverse_band`` scans, on a band of
    three 8-column chunks."""
    rng = np.random.RandomState(7)
    a = spd_band(3, 20, rng)
    l = ops.cholesky_band_plain(torch.from_numpy(a))
    s = ops.takahashi_inverse_band_plain(l)
    l_bar, s_bar = rng.randn(4, 20), rng.randn(4, 20)
    with jops.impl_scope("scan"):
        _, chol_vjp = jax.vjp(jops.cholesky_band, jnp.asarray(a))
        _, tak_vjp = jax.vjp(jops.takahashi_inverse_band, jnp.asarray(l.numpy()))
        (want_a,) = chol_vjp(jnp.asarray(l_bar))
        (want_l,) = tak_vjp(jnp.asarray(s_bar))
    got, _ = partitioned(l.numpy(), l_bar, 8)
    assert rel(got, want_a) <= 1e-13
    got, _ = partitioned(l.numpy(), s_bar, 8, s=s.numpy(), chol=False)
    assert rel(got, want_l) <= 1e-13


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA adjoints have no CPU mode")
    return torch.device("cuda", 0)


# (k, m, nb): one column; one chunk (m < 64, m = 64); a ragged last chunk;
# the two-chunk rule (the additive model's m = 250, half of 257 rounded up
# to 192 columns, the last two-chunk walk at 512 and the first of 64-column
# chunks at 513); two matrices; k = 6 at m = 10⁴, where the chunks are
# longest so that the scan's maps fit in shared memory
EDGES = [(1, 1, 1), (3, 40, 1), (6, 64, 1), (2, 65, 1), (3, 250, 1), (3, 257, 1),
         (3, 512, 2), (3, 513, 1), (3, 1000, 2), (4, 4097, 1), (3, 10_000, 1),
         (6, 10_000, 1), (6, 10_000, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("k, m, nb", EDGES)
def test_cuda_adjoints_at_partition_edges(cuda_device, k, m, nb):
    """K10/K18 (``single.chol_bwd``), K8 (``core.chol_bwd_pair``), K12/K20
    (``single.tak_bwd``), K7 (``core.tak_bwd_vec``) and K23
    (``core.tak_bwd_pair``) on the card against their plain versions, each
    call counted once; the kernels' workspace is that of ``chunk_cols``'s
    chunks and one element for the chunk-length rule."""
    d = k * (k + 1) // 2
    maps = -(-m // chunk_cols(k, m)) - 1
    assert core.carry_workspace(k, m, nb) == (nb * maps * (d * d + 2 * d) + 1 if maps else 0)
    l, s, l_bar, s_bar = adjoint_inputs(k, m, nb, 90 + k)
    dev = cuda_device
    iv = (1.0 / l[:, 0]).contiguous()
    core.reset_counters()
    got = core.chol_bwd_pair(l.to(dev), l_bar.to(dev))
    assert rel(got.cpu(), plain(l, l_bar)) <= BARS[np.float64]
    if nb == 2:
        got = core.tak_bwd_pair(*(t.to(dev) for t in (l, s, s_bar, iv)))
        assert rel(got.cpu(), plain(l, s_bar, s, iv, chol=False)) <= BARS[np.float64]
        want = {"chol_bwd_pair": 1, "tak_bwd_pair": 1}
    else:
        l0, s0, lb0, sb0, iv0 = l[0], s[0], l_bar[0], s_bar[0], iv[0]
        got = core.tak_bwd_vec(*(t.to(dev) for t in (l0, s0, sb0, iv0)))
        assert rel(got.cpu(), ops.takahashi_bwd_plain(l0, s0, sb0, iv0)) <= BARS[np.float64]
        for dtype, tol in ((torch.float64, BARS[np.float64]), (torch.float32, BARS[np.float32])):
            lh, sh, lbh, sbh = (t.to(dtype) for t in (l0, s0, lb0, sb0))
            got = single.chol_bwd(lh.to(dev), lbh.to(dev))
            assert got.dtype == dtype and rel(got.cpu(), single.chol_bwd_plain(lh, lbh)) <= tol
            got = single.tak_bwd(lh.to(dev), sh.to(dev), sbh.to(dev))
            assert rel(got.cpu(), single.tak_bwd_plain(lh, sh, sbh)) <= tol
        want = {"chol_bwd_pair": 1, "tak_bwd_vec": 1, "chol_bwd": 1, "tak_bwd": 1,
                "chol_bwd_f32": 1, "tak_bwd_f32": 1}
    torch.cuda.synchronize()
    assert {n: c for n, c in core.LAUNCHES.items() if c} == want
