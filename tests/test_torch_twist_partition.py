"""The partition of the twisted tangent sweeps: K5 (csrc/banded_tan.cu
``chol_quad_solve_tan<K>``) and K6 (``tak_quad_solve_tan<K>``).

Both run four matrices, F/R × Kuu/P: stream F walks columns 0..h-1 of the
bands, stream R columns 0..g-1 of the index-reversed bands, g = m - h - k.
Each stream's walk is cut into chunks of lc columns.

K5 is the Schur partition of the Cholesky sweep (``chol_fwd``,
``tests/test_torch_forward_partition.py``) with more crossing a chunk
boundary.  Pass 1 runs each chunk's recursion from W = 0 and substitutes
V = L_c⁻¹E along it, for its triple (U = chol(VᵀV), Q = V_lastᵀXᵀ,
R = XXᵀ).  On Kuu everything is in dual numbers (value, tangent in the
direction T), so the walk carries Ẇ beside W.  On P the triple also holds
p0 = Vᵀy0 and r0 = X·y0_last from the chunk's own lower solve y0, so the
walk carries the solve's coupling β = L[c₀:c₀+k, :c₀]·y[:c₀]:
    β' = r0 + (WQ)ᵀd + Yᵀz − Qᵀβ,  d = p0 − UUᵀβ,  z = F⁻¹(WU)ᵀd
(Woodbury's identity for (A_c − EWEᵀ)⁻¹; F = chol(I − UᵀWU), Y = F⁻¹G₁₂ as
in the walk of W).  Pass 3 reruns each chunk with W subtracted from the
first k rows of A_c, Ẇ from those of T_c, β from the first k entries of b_c.

K6 is the affine partition of the Takahashi sweep (``tak_fwd``) seeded at
the middle block: a Kuu matrix carries the D = k(k+1)/2 read entries of
the windows of S and of Ṡ, whose joint map is [[H, 0], [H', H]] (D + 1
chains build it); a P matrix those of S and the upper solve's k-window.
Chunk 0's particular chain starts from the seed, so its map is H = 0 and
y = its outgoing window, and the scan (from 0) starts at the seed.

A numpy emulation of both, in the kernels' order of operations (each fused
multiply-add as a product and a sum), is held here to the plain versions
(``twist.chol_quad_solve_tan_plain``, ``tak_quad_solve_tan_plain``) at
1e-13 of the largest entry, its assembled outputs to the JAX package's
float64 twisted route at 1e-12, and at the north star's conditioning to
the main paths' bar.  The CUDA kernels have no CPU mode: their test is
marked ``cuda`` and skips without a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asvgp_tpu.banded import twisted as jtw
from asvgp_tpu_torch.banded import core, twist
from asvgp_tpu_torch.banded.twisted import flip_band, split_point
from asvgp_tpu_torch.basis import B3Spline
from asvgp_tpu_torch.features.spline_features import make_kuu
from asvgp_tpu_torch.models import GPR1D, Matern, Matern32
from test_torch_tan import inputs

BAR = 1e-13      # chip_smoke.py's bar on random bands (TOL_PARITY_ADJOINT)
BAR_JAX = 1e-12  # the float64 twisted route of the JAX package
TOL_MAIN = 1e-8  # chip_smoke.py's bar on the main paths' arguments
# csrc/chunk_scan.cuh and csrc/schur_walk.cuh: the partitions' constants
SMEM_LIMIT, MAX_CHUNKS, TILE, MIN_CHUNK, SCHUR_CHUNK = 232448, 256, 64, 64, 128


def chunk_cols(k, m):
    """(K5's, K6's) columns per chunk at (k, m), as ``chol_quad_chunk_cols``
    and ``tak_quad_chunk_cols`` give them for streams of h columns: K5's
    walk stages Kuu's dual triple, 2(k² + k(k+1)) doubles a chunk; K6's
    scan a map of (2D)² + 2D, 2D = k(k+1); at least 128 / 64 columns, at
    most 256 chunks and as many as fit, a multiple of the tile."""
    h = split_point(m, k)
    out = []
    for per, least in ((2 * (k * k + k * (k + 1)), SCHUR_CHUNK),
                       ((k * (k + 1)) ** 2 + k * (k + 1), MIN_CHUNK)):
        cap = min(MAX_CHUNKS, SMEM_LIMIT // (per * 8) + 1)
        lc = max(least, -(-h // cap))
        out.append(min(-(-lc // TILE) * TILE, h))
    return tuple(out)


# ---------------------------------------------------------------------------
# numbers: float64 arrays over a batch of chunks, or dual numbers of them
# ---------------------------------------------------------------------------


class Dual:
    """(value, tangent) of arrays: the forward-mode number K5 carries for
    the Kuu tangent."""

    def __init__(self, v, d):
        self.v, self.d = v, d

    def __neg__(self):
        return Dual(-self.v, -self.d)

    def __add__(self, o):
        o = lift(o)
        return Dual(self.v + o.v, self.d + o.d)

    def __sub__(self, o):
        return self + (-lift(o))

    def __mul__(self, o):
        o = lift(o)
        return Dual(self.v * o.v, self.v * o.d + self.d * o.v)


def lift(x):
    return x if isinstance(x, Dual) else Dual(x, 0.0 * x)


def rsqrt(x):
    if isinstance(x, Dual):
        r = 1.0 / np.sqrt(x.v)
        return Dual(r, -0.5 * r * r * r * x.d)
    return 1.0 / np.sqrt(x)


def zeros_like(x):
    return Dual(0.0 * x.v, 0.0 * x.v) if isinstance(x, Dual) else 0.0 * x


# ---------------------------------------------------------------------------
# schur_walk.cuh
# ---------------------------------------------------------------------------


def chol_small(f):
    """The lower factor of the k×k matrix in f's lower triangle (lists of
    numbers), by reciprocal square roots; returns (F, reciprocals)."""
    k = len(f)
    f = [row[:] for row in f]
    rd = [None] * k
    for j in range(k):
        dj = f[j][j]
        for p in range(j):
            dj = (-f[j][p]) * f[j][p] + dj
        rd[j] = rsqrt(dj)
        f[j][j] = dj * rd[j]
        for i in range(j + 1, k):
            x = f[i][j]
            for p in range(j):
                x = (-f[i][p]) * f[j][p] + x
            f[i][j] = x * rd[j]
        for i in range(j):
            f[i][j] = zeros_like(f[j][j])
    return f, rd


def v_row(g, rv, t, vw, pa, one):
    """Row t of V from g[p-1] = L[i, i-p] and rv = 1/L[i, i]; P += vn vnᵀ;
    V's window pushed.  Returns vn."""
    k = len(g)
    vn = []
    for f in range(k):
        acc = one if t == f else zeros_like(one)
        for p in range(1, k + 1):
            acc = (-g[p - 1]) * vw[p - 1][f] + acc
        vn.append(acc * rv)
    for f in range(k):
        for h in range(f, k):
            pa[f][h] = vn[f] * vn[h] + pa[f][h]
    vw.insert(0, vn)
    vw.pop()
    return vn


def triple(w, vw, pa):
    """(U, Q, R) of a chunk from its last window w[q-1][r] = L[e-q+r, e-q],
    V's last rows and P's upper triangle."""
    k = len(vw)
    u, _ = chol_small([[pa[h][f] if h <= f else None for h in range(k)] for f in range(k)])
    zero = zeros_like(pa[0][0])
    q = [[zero] * k for _ in range(k)]
    r = [[zero] * k for _ in range(k)]
    for f in range(k):
        for x in range(k):
            acc = zero
            for b in range(x, k):
                acc = vw[k - 1 - b][f] * w[k - 1 - b][k + x - b] + acc
            q[f][x] = acc
    for x in range(k):
        for y in range(x, k):
            acc = zero
            for b in range(y, k):
                acc = w[k - 1 - b][k + x - b] * w[k - 1 - b][k + y - b] + acc
            r[x][y] = r[y][x] = acc
    return u, q, r


def schur_step(W, u, q, r, beta=None, p0=None, r0=None):
    """W (and beta) through a chunk: W' = R + QᵀWQ + YᵀY, and for a solve
    beta' = r0 + (WQ)ᵀd + Yᵀz − Qᵀβ.  Returns (W', beta')."""
    k = len(W)
    zero = zeros_like(W[0][0])
    one = zero + 1.0
    wu = [[zero] * k for _ in range(k)]
    for x in range(k):
        for y in range(k):
            acc = zero
            for z in range(y, k):
                acc = W[x][z] * u[z][y] + acc
            wu[x][y] = acc
    f = [[None] * k for _ in range(k)]
    for x in range(k):
        for y in range(x + 1):
            acc = one if x == y else zero
            for z in range(x, k):
                acc = (-u[z][x]) * wu[z][y] + acc
            f[x][y] = acc
    f, rd = chol_small(f)
    yy = [[zero] * k for _ in range(k)]
    wq = [[zero] * k for _ in range(k)]
    for x in range(k):
        for y in range(k):
            acc, acq = zero, zero
            for z in range(k):
                acc = wu[z][x] * q[z][y] + acc
                acq = W[x][z] * q[z][y] + acq
            yy[x][y], wq[x][y] = acc, acq
    for x in range(k):
        for y in range(k):
            acc = yy[x][y]
            for z in range(x):
                acc = (-f[x][z]) * yy[z][y] + acc
            yy[x][y] = acc * rd[x]
    nb = None
    if beta is not None:
        ub = []
        for x in range(k):
            acc = zero
            for z in range(x, k):
                acc = u[z][x] * beta[z] + acc
            ub.append(acc)
        dv = []
        for x in range(k):
            acc = p0[x]
            for y in range(x + 1):
                acc = (-u[x][y]) * ub[y] + acc
            dv.append(acc)
        zz = []
        for x in range(k):
            acc = zero
            for z in range(k):
                acc = wu[z][x] * dv[z] + acc
            for z in range(x):
                acc = (-f[x][z]) * zz[z] + acc
            zz.append(acc * rd[x])
        nb = []
        for y in range(k):
            acc = r0[y]
            for z in range(k):
                acc = wq[z][y] * dv[z] + acc
                acc = yy[z][y] * zz[z] + acc
                acc = (-q[z][y]) * beta[z] + acc
            nb.append(acc)
    wn = [[zero] * k for _ in range(k)]
    for x in range(k):
        for y in range(x, k):
            acc = r[x][y]
            for z in range(k):
                acc = q[z][x] * wq[z][y] + acc
                acc = yy[z][x] * yy[z][y] + acc
            wn[x][y] = wn[y][x] = acc
    return wn, nb


# ---------------------------------------------------------------------------
# K5: chol_quad_solve_tan<K>
# ---------------------------------------------------------------------------


def chol_tan_col(w, tw, x, ac, tc, bc):
    """One column of ``chol_tan_step`` (keep = 1) on windows w, tw (k, k+1,
    B) and x (k, B); returns (w, tw, x, col, tcol, r, tiv, xi)."""
    k = w.shape[0]
    s = [0.0 * ac[0] for _ in range(k + 1)]
    ts = [0.0 * ac[0] for _ in range(k + 1)]
    sb = 0.0 * ac[0]
    for q in range(1, k + 1):
        g, tg = w[q - 1, q], tw[q - 1, q]
        sb = g * x[q - 1] + sb
        for j in range(k + 1 - q):
            s[j] = g * w[q - 1, q + j] + s[j]
            ts[j] = tg * w[q - 1, q + j] + (g * tw[q - 1, q + j] + ts[j])
    l0 = np.sqrt(ac[0] - s[0])
    r = 1.0 / l0
    col = np.stack([l0] + [(ac[j] - s[j]) * r for j in range(1, k + 1)])
    xi = (bc - sb) * r
    e = -0.5 * r * r * (tc[0] - ts[0])
    tcol = np.stack([(tc[j] - ts[j]) * r + col[j] * e for j in range(k + 1)])
    tiv = r * e
    w = np.concatenate([col[None], w[:-1]])
    tw = np.concatenate([tcol[None], tw[:-1]])
    x = np.concatenate([xi[None], x[:-1]])
    return w, tw, x, col, tcol, r, tiv, xi


def by_chunks(a, nc, lc, pad):
    """(rows, nc, lc) from a (rows, n) array, past column n-1 the column
    ``pad`` (the identity's for a band, 0 for a vector)."""
    rows, n = a.shape
    out = np.tile(np.asarray(pad, float)[:, None], (1, nc * lc))
    out[:, :n] = a
    return out.reshape(rows, nc, lc)


def k5_matrix(a, x, kuu_role, lc):
    """K5 on one matrix of one stream: a (k+1, n) its stream-local band,
    x the tangent band (Kuu) or b (P, (1, n)), chunks of lc columns.
    Returns (col, tcol, r, tiv, xi) by column (each (…, n)) and the
    walk's record {"w", "wdot", "beta", "sigma"}."""
    kp1, n = a.shape
    k = kp1 - 1
    nc = -(-n // lc)
    eye_col = [1.0] + [0.0] * k
    ach = by_chunks(a, nc, lc, eye_col)
    xch = by_chunks(x, nc, lc, [0.0] * x.shape[0])
    rec = {"w": 0.0, "wdot": 0.0, "beta": 0.0, "sigma": np.inf}
    win = [None] * nc  # incoming (W, Wdot or beta) of each chunk
    if nc > 1:
        # pass 1 over the full chunks 0..nc-2, batched
        b = nc - 1
        w = np.zeros((k, kp1, b))
        tw = np.zeros((k, kp1, b))
        xs = np.zeros((k, b))
        one = Dual(np.ones(b), np.zeros(b)) if kuu_role else np.ones(b)
        zero = zeros_like(one)
        vw = [[zero] * k for _ in range(k)]
        pa = [[zero] * k for _ in range(k)]
        p0 = [np.zeros(b) for _ in range(k)]
        for t in range(lc):
            ac = ach[:, :b, t]
            tc = xch[:, :b, t] if kuu_role else np.zeros((kp1, b))
            bc = np.zeros(b) if kuu_role else xch[0, :b, t]
            if kuu_role:
                g = [Dual(w[p - 1, p], tw[p - 1, p]) for p in range(1, k + 1)]
            else:
                g = [w[p - 1, p] for p in range(1, k + 1)]
            w, tw, xs, _, _, r, tiv, xi = chol_tan_col(w, tw, xs, ac, tc, bc)
            vn = v_row(g, Dual(r, tiv) if kuu_role else r, t, vw, pa, one)
            if not kuu_role:
                p0 = [vn[f] * xi + p0[f] for f in range(k)]
        wv = [[Dual(w[q, r], tw[q, r]) if kuu_role else w[q, r] for r in range(kp1)]
              for q in range(k)]
        u, q, rr = triple(wv, vw, pa)
        r0 = []
        for x0 in range(k):
            acc = np.zeros(b)
            for bb in range(x0, k):
                acc = w[k - 1 - bb, k + x0 - bb] * xs[k - 1 - bb] + acc
            r0.append(acc)
        # pass 2: the walk, chunk by chunk
        zero1 = Dual(np.zeros(1), np.zeros(1)) if kuu_role else np.zeros(1)
        W = [[zero1] * k for _ in range(k)]
        beta = None if kuu_role else [np.zeros(1) for _ in range(k)]
        for c in range(b):
            uc = [[pick(e, c) for e in row] for row in u]
            if c > 0:
                # sigma_min(I - U^T W U) of the chunk W meets
                wval = np.array([[lift(e).v[0] for e in row] for row in W])
                uval = np.array([[lift(e).v[0] for e in row] for row in uc])
                nmat = np.eye(k) - uval.T @ wval @ uval
                if np.isfinite(nmat).all():
                    rec["sigma"] = min(rec["sigma"], float(np.linalg.eigvalsh(nmat).min()))
            W, beta = schur_step(W, uc, [[pick(e, c) for e in row] for row in q],
                                 [[pick(e, c) for e in row] for row in rr], beta,
                                 None if kuu_role else [pick(e, c) for e in p0],
                                 None if kuu_role else [pick(e, c) for e in r0])
            win[c + 1] = (W, beta)
            wl = np.array([[lift(e).v[0] for e in row] for row in W])
            rec["w"] = max(rec["w"], float(np.abs(wl).max()))
            if kuu_role:
                wd = np.array([[e.d[0] for e in row] for row in W])
                rec["wdot"] = max(rec["wdot"], float(np.abs(wd).max()))
            else:
                rec["beta"] = max(rec["beta"], float(np.abs([e[0] for e in beta]).max()))
    # pass 3: every chunk from a zero window, W (Wdot, beta) subtracted
    ach, xch = ach.copy(), xch.copy()
    for c in range(1, nc):
        W, beta = win[c]
        for rr_ in range(min(k, lc)):
            for cc in range(k - rr_):
                ach[cc, c, rr_] -= lift(W[rr_][rr_ + cc]).v[0]
                if kuu_role:
                    xch[cc, c, rr_] -= W[rr_][rr_ + cc].d[0]
        if not kuu_role:
            for q_ in range(min(k, lc)):
                xch[0, c, q_] -= beta[q_][0]
    w = np.zeros((k, kp1, nc))
    tw = np.zeros((k, kp1, nc))
    xs = np.zeros((k, nc))
    outs = []
    for t in range(lc):
        tc = xch[:, :, t] if kuu_role else np.zeros((kp1, nc))
        bc = np.zeros(nc) if kuu_role else xch[0, :, t]
        w, tw, xs, col, tcol, r, tiv, xi = chol_tan_col(w, tw, xs, ach[:, :, t], tc, bc)
        outs.append((col, tcol, r, tiv, xi))
    # (…, nc, lc) -> (…, n)
    res = [np.stack([o[i] for o in outs], axis=-1) for i in range(5)]
    res = [x_.reshape(x_.shape[:-2] + (nc * lc,))[..., :n] for x_ in res]
    return res, rec


def pick(v, c):
    """Entry c of a batched number, as a batch of one."""
    return Dual(v.v[c:c + 1], v.d[c:c + 1]) if isinstance(v, Dual) else v[c:c + 1]


def stream_inputs(kuu, tanb, p, b):
    """Each stream's stream-local (Kuu, T, P, b), numpy float64."""
    k, m = kuu.shape[0] - 1, kuu.shape[1]
    h = split_point(m, k)
    g = m - h - k
    f = [t[:, :h].numpy() for t in (kuu, tanb, p)] + [b[None, :h].numpy()]
    r = [flip_band(t)[:, :g].numpy() for t in (kuu, tanb, p)] + [b.flip(0)[None, :g].numpy()]
    return (f, h), (r, g)


def partitioned_k5(kuu, tanb, p, b, lc):
    """K5's outputs as ``chol_quad_solve_tan_plain`` gives them, by the
    partition with chunks of lc columns, and the walks' records by
    matrix (F Kuu, F P, R Kuu, R P)."""
    k, m = kuu.shape[0] - 1, kuu.shape[1]
    h = split_point(m, k)
    l = np.zeros((4, k + 1, h))
    ldot = np.zeros((2, k + 1, h))
    iv = np.zeros((4, h))
    ivdot = np.zeros((2, h))
    y = np.zeros((2, h))
    recs = []
    with np.errstate(invalid="ignore", divide="ignore"):
        for s, ((a_k, t_k, a_p, bb), n) in enumerate(stream_inputs(kuu, tanb, p, b)):
            (col, tcol, r, tiv, _), rec_k = k5_matrix(a_k, t_k, True, lc)
            l[2 * s, :, :n], ldot[s, :, :n], iv[2 * s, :n], ivdot[s, :n] = col, tcol, r, tiv
            (col, _, r, _, xi), rec_p = k5_matrix(a_p, bb, False, lc)
            l[2 * s + 1, :, :n], iv[2 * s + 1, :n], y[s, :n] = col, r, xi
            recs += [rec_k, rec_p]
    return tuple(torch.from_numpy(t) for t in (l, ldot, iv, ivdot, y)), recs


# ---------------------------------------------------------------------------
# K6: tak_quad_solve_tan<K>
# ---------------------------------------------------------------------------


def slots(k):
    """The D read entries of the Takahashi window, cs[c][r], r < k - c,
    in the kernels' packing order."""
    return [(c, r) for c in range(k) for r in range(k - c)]


def tak_tan_col(cs, tcs, x, lc, tlc, d, td, bc, part, maps):
    """One column of ``tak_tan_step`` (keep = 1) on windows cs, tcs (k, k+1,
    B) and x (k, B); ``part`` scales the terms not linear in the windows
    (``maps``).  Returns (cs, tcs, x, col, tcol, uj)."""
    k = cs.shape[0]
    sb = 0.0 * d
    for q in range(1, k + 1):
        sb = lc[q] * x[q - 1] + sb
    uj = (part * bc - sb) * d if maps else (bc - sb) * d
    sq, tsq = [0.0 * d], [0.0 * d]
    for q in range(1, k + 1):
        acc, tacc = 0.0 * d, 0.0 * d
        for p in range(1, k + 1):
            lo, df = min(p, q), abs(q - p)
            acc = cs[lo - 1, df] * lc[p] + acc
            tacc = tcs[lo - 1, df] * lc[p] + (cs[lo - 1, df] * tlc[p] + tacc)
        sq.append(-d * acc)
        tsq.append(-(tacc * d + acc * td))
    ws, tws = 0.0 * d, 0.0 * d
    for q in range(1, k + 1):
        ws = lc[q] * sq[q] + ws
        tws = tlc[q] * sq[q] + (lc[q] * tsq[q] + tws)
    if maps:
        c0, t0 = part * (d * d) - d * ws, part * (2.0 * d * td) - (tws * d + ws * td)
    else:
        c0, t0 = d * d - d * ws, 2.0 * d * td - (tws * d + ws * td)
    col = np.stack([c0] + sq[1:])
    tcol = np.stack([t0] + tsq[1:])
    cs = np.concatenate([col[None], cs[:-1]])
    tcs = np.concatenate([tcol[None], tcs[:-1]])
    x = np.concatenate([uj[None], x[:-1]])
    return cs, tcs, x, col, tcol, uj


def seed_windows(zs, zd, x2, rev):
    """The windows K6 starts from, from the middle inverse (k, k)."""
    k = zs.shape[0]
    cs = np.zeros((k, k + 1))
    tcs = np.zeros((k, k + 1))
    x = np.zeros(k)
    for q in range(1, k + 1):
        x[q - 1] = x2[k - q] if rev else x2[q - 1]
        for r in range(k + 1):
            if q - 1 + r <= k - 1:
                zi = (k - q - r, k - q) if rev else (q - 1 + r, q - 1)
                cs[q - 1, r], tcs[q - 1, r] = zs[zi], zd[zi]
    return cs, tcs, x


def k6_matrix(lb, tlb, d, td, bc, seed, kuu_role, lc):
    """K6 on one matrix of one stream, walking its stream-local columns
    n-1..0: lb, tlb (k+1, n) its factor and tangent, d, td its reciprocal
    pivots, bc its lower solve (P).  Returns (col, tcol, uj) by column and
    the largest entry of the composed maps."""
    kp1, n = lb.shape
    k = kp1 - 1
    sl = slots(k)
    dd = len(sl)
    nc = -(-n // lc)
    lch = by_chunks(lb[:, ::-1], nc, lc, [1.0] + [0.0] * k)
    tch = by_chunks(tlb[:, ::-1], nc, lc, [0.0] * kp1)
    dch = by_chunks(d[None, ::-1], nc, lc, [1.0])[0]
    tdch = by_chunks(td[None, ::-1], nc, lc, [0.0])[0]
    bch = by_chunks(bc[None, ::-1], nc, lc, [0.0])[0]
    win = [seed] + [None] * (nc - 1)
    h_max = 0.0
    if nc > 1:
        # pass 1: chunks 0..nc-2, lanes 0..D-1 (window e_d) and D (particular)
        b = (nc - 1, dd + 1)
        cs, tcs, x = np.zeros((k, kp1) + b), np.zeros((k, kp1) + b), np.zeros((k,) + b)
        for e, (c, r) in enumerate(sl):
            cs[c, r, :, e] = 1.0
            if not kuu_role and e < k:
                x[e, :, e] = 1.0
        cs[..., 0, dd], tcs[..., 0, dd], x[:, 0, dd] = seed
        part = np.zeros(b)
        part[:, dd] = 1.0
        for t in range(lc):
            cs, tcs, x, _, _, _ = tak_tan_col(cs, tcs, x, lch[:, :-1, t, None],
                                              tch[:, :-1, t, None], dch[:-1, t, None],
                                              tdch[:-1, t, None], bch[:-1, t, None], part, True)
        sv = np.stack([cs[c, r] for c, r in sl])  # (D, nc-1, D+1)
        tv = np.stack([tcs[c, r] for c, r in sl])
        if kuu_role:
            hm = np.zeros((nc - 1, 2 * dd, 2 * dd))
            hm[:, :dd, :dd] = sv[:, :, :dd].transpose(1, 0, 2)
            hm[:, dd:, :dd] = tv[:, :, :dd].transpose(1, 0, 2)
            hm[:, dd:, dd:] = hm[:, :dd, :dd]
            ym = np.concatenate([sv[:, :, dd], tv[:, :, dd]]).T
        else:
            hm = np.zeros((nc - 1, 2 * dd, 2 * dd))
            hm[:, :dd, :dd] = sv[:, :, :dd].transpose(1, 0, 2)
            hm[:, dd:dd + k, dd:dd + k] = x[:, :, :k].transpose(1, 0, 2)
            ym = np.concatenate([sv[:, :, dd], x[:, :, dd], np.zeros((dd - k, nc - 1))]).T
        hm[0] = 0.0  # chunk 0's particular chain started from the seed
        h_max = float(np.abs(hm[1:]).max()) if nc > 2 else 0.0
        # pass 2: the scan, w_{j+1} = y_j + H_j w_j from 0
        wv = np.zeros(2 * dd)
        for j in range(nc - 1):
            wv = ym[j] + hm[j] @ wv
            cs0, tcs0, x0 = np.zeros((k, kp1)), np.zeros((k, kp1)), np.zeros(k)
            for e, (c, r) in enumerate(sl):
                cs0[c, r] = wv[e]
                if kuu_role:
                    tcs0[c, r] = wv[dd + e]
            if not kuu_role:
                x0 = wv[dd:dd + k].copy()
            win[j + 1] = (cs0, tcs0, x0)
    # pass 3: every chunk from its incoming windows
    cs = np.stack([w_[0] for w_ in win], axis=-1)
    tcs = np.stack([w_[1] for w_ in win], axis=-1)
    x = np.stack([w_[2] for w_ in win], axis=-1)
    outs = []
    for t in range(lc):
        cs, tcs, x, col, tcol, uj = tak_tan_col(cs, tcs, x, lch[:, :, t], tch[:, :, t], dch[:, t],
                                                tdch[:, t], bch[:, t], 1.0, False)
        outs.append((col, tcol, uj))
    res = [np.stack([o[i] for o in outs], axis=-1) for i in range(3)]
    res = [x_.reshape(x_.shape[:-2] + (nc * lc,))[..., :n][..., ::-1] for x_ in res]
    return res, h_max


def partitioned_k6(l, ldot, iv, ivdot, y, z, x2, m, lc):
    """K6's outputs (s_kuu, s_p, u, sdot) by the partition with chunks of
    lc columns, assembled as the kernel writes them; and the largest entry
    of the composed maps."""
    l, ldot, iv, ivdot, y, z, x2 = (t.numpy() for t in (l, ldot, iv, ivdot, y, z, x2))
    k, h = l.shape[1] - 1, l.shape[2]
    g = m - h - k
    s_kuu, s_p, sdot = np.zeros((k + 1, m)), np.zeros((k + 1, m)), np.zeros((k + 1, m))
    u = np.zeros(m)
    h_max = 0.0
    for s, n in ((0, h), (1, g)):
        rev = s == 1
        for role in (True, False):
            t = 2 * s + (0 if role else 1)
            zs = z[0] if role else z[1]
            seed = seed_windows(zs, z[2], x2, rev)
            if not role:
                seed = (seed[0], 0.0 * seed[1], seed[2])
            (col, tcol, uj), hm = k6_matrix(
                l[t, :, :n], ldot[s, :, :n] if role else np.zeros((k + 1, n)),
                iv[t, :n], ivdot[s, :n] if role else np.zeros(n),
                np.zeros(n) if role else y[s, :n], seed, role, lc)
            h_max = max(h_max, hm)
            out = s_kuu if role else s_p
            for r in range(k + 1):
                cols = (m - 1 - np.arange(n) - r) if rev else np.arange(n)
                out[r, cols] = col[r]
                if role:
                    sdot[r, cols] = tcol[r]
            if not role:
                u[(m - 1 - np.arange(n)) if rev else np.arange(n)] = uj
            if not rev:
                # the dense middle block
                for c in range(k):
                    for r in range(k - c):
                        out[r, h + c] = seed[0][c, r]
                        if role:
                            sdot[r, h + c] = seed[1][c, r]
                    if not role:
                        u[h + c] = x2[c]
    return tuple(torch.from_numpy(t) for t in (s_kuu, s_p, u, sdot)), h_max


# ---------------------------------------------------------------------------
# the emulation against the plain versions and the JAX package
# ---------------------------------------------------------------------------


def rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.nanmax(np.abs(got - want)) / np.nanmax(np.abs(want)))


def check_against_plain(bands, lc5, lc6, tol):
    """Both partitions against the plain versions at ``tol``; returns K5's
    walk records by matrix and the largest entry of K6's maps."""
    kuu, tanb, p, b = bands
    m = kuu.shape[1]
    k5, recs = partitioned_k5(kuu, tanb, p, b, lc5)
    want5 = twist.chol_quad_solve_tan_plain(kuu, tanb, p, b)
    for name, got, want in zip(("l", "ldot", "iv", "ivdot", "y"), k5, want5):
        assert rel(got, want) <= tol, name
    # K6 from the plain K5's outputs and their mid step, as the kernel's
    # parity checks feed it
    _, zp, x2p, _ = twist.mid_step(kuu, tanb, p, b, want5[0], want5[1], want5[4])
    k6p, h_max = partitioned_k6(*want5, zp, x2p, m, lc6)
    want6 = twist.tak_quad_solve_tan_plain(*want5, zp, x2p, m)
    for name, got, w6 in zip(("s_kuu", "s_p", "u", "sdot"), k6p, want6):
        assert rel(got, w6) <= tol, name
    return recs, h_max


# (m - k parity, R one chunk fewer, one chunk, a chunk edge at the middle):
# m = 2h + k - 1 gives g = h - 1, m = 2h + k gives g = h
def edge_ms(k, lc):
    return {"many, g = h - 1": 2 * (5 * lc + 3) + k - 1, "many, g = h": 2 * (5 * lc + 3) + k,
            "R a chunk fewer": 2 * (2 * lc + 1) + k - 1, "one chunk": 2 * lc + k,
            "edge at the middle": 2 * (4 * lc) + k}


@pytest.mark.parametrize("k", range(1, 7))
def test_partitioned_twist_matches_plain(k):
    """K5's and K6's partitions on random SPD bands (a random symmetric
    tangent band) against the plain versions at 1e-13 of the largest
    entry, with 8-column chunks (K6's too), at both parities of m - k, a
    reversed stream one chunk shorter, one chunk, and a chunk edge at the
    middle block."""
    lc = max(8, 2 * k)
    for case, m in edge_ms(k, lc).items():
        if not twist.twist_applicable(k, m):
            continue
        check_against_plain(inputs(k, m, 7 * k + m), lc, lc, BAR)


def test_first_chunk_is_the_one_chain_recursion():
    """Each stream's first chunk starts from nothing (K5: W = Ẇ = 0, β = 0;
    K6: the seed windows), so the partitioned run's first chunk equals the
    one-chain recursion (the same emulation with the stream in one chunk)
    bit for bit."""
    k, m, lc = 3, 2 * 40 + 3, 8
    bands = inputs(k, m, 11)
    h = split_point(m, k)
    g = m - h - k
    k5, _ = partitioned_k5(*bands, lc)
    one5, _ = partitioned_k5(*bands, h)
    for got, one in zip(k5, one5):
        assert np.array_equal(got[..., :lc].numpy(), one[..., :lc].numpy())
    # K6 on the same inputs, in chunks and in one
    _, z, x2, _ = twist.mid_step(*bands, one5[0], one5[1], one5[4])
    part6, _ = partitioned_k6(*one5, z, x2, m, lc)
    one6, _ = partitioned_k6(*one5, z, x2, m, h)
    for got, one in zip(part6, one6):
        got, one = got.numpy(), one.numpy()
        if got.ndim == 1:
            assert np.array_equal(got[h - lc: m - g + lc], one[h - lc: m - g + lc])
        else:
            assert np.array_equal(got[:, h - lc: h + k], one[:, h - lc: h + k])
            assert np.array_equal(got[:, m - g: m - g + lc - k], one[:, m - g: m - g + lc - k])


@pytest.mark.parametrize("k,m", [(2, 45), (3, 52)])
def test_assembled_partitions_match_jax_twisted_route(k, m):
    """K5 + mid step + K6 by the partitions (8-column chunks), assembled as
    ``twist.factor_takahashi_solve_tan_twist`` assembles them, against the
    JAX package's float64 twisted route (``twisted.twisted_inverse_band``,
    ``twisted_solve_core``; Ṡ by ``jax.jvp`` of the first in the direction
    T) at 1e-12."""
    bands = inputs(k, m, 3 * m)
    emulated = twist._twist(lambda *a: partitioned_k5(*a, 8)[0],
                            lambda *a: partitioned_k6(*a, 8)[0], *bands)
    kuu, tanb, p, b = (jnp.asarray(t.numpy()) for t in bands)
    ld_k, s_k = jax.jit(jtw.twisted_inverse_band)(kuu)
    ld_p, quad, u, s_p = jax.jit(jtw.twisted_solve_core)(p, b)
    sdot = jax.jit(lambda a, t: jax.jvp(lambda x: jtw.twisted_inverse_band(x)[1], (a,), (t,))[1])(
        kuu, tanb)
    for name, got, want in zip(("ld_kuu", "ld_p", "quad", "s_kuu", "s_p", "u", "sdot"),
                               emulated, (ld_k, ld_p, quad, s_k, s_p, u, sdot)):
        assert rel(got.numpy(), np.asarray(want)) <= BAR_JAX, name


def north_star_bands(ell_over_delta, m=320):
    """(Kuu, T = ∂Kuu/∂ℓ, P, Kuf·y) of GPR1D for B3 × Matérn-3/2 at
    ℓ = ell_over_delta/m on [0, 1], N = 100 m points, noise 0.1."""
    rng = np.random.RandomState(5)
    x = rng.uniform(0.005, 0.995, 100 * m)
    y = np.sin(140.8 * x) + 0.5 * np.sin(35.2 * x) + 0.3 * rng.randn(x.shape[0])
    basis = B3Spline(0.0, 1.0, m)
    model = GPR1D((x, y), Matern32(1.0, ell_over_delta / m), basis, noise_variance=0.1,
                  device="cpu")
    with torch.no_grad():
        ell = torch.tensor(ell_over_delta / m, dtype=torch.float64)
        var = torch.tensor(1.0, dtype=torch.float64)
        kuu, tanb = torch.func.jvp(lambda l_: make_kuu(Matern(var, l_, nu2=3), basis),
                                   (ell,), (torch.ones_like(ell),))
        p = model.kufkfu_band / 0.1 + kuu
    return kuu, tanb, p, model.kuf_y


@pytest.mark.parametrize("ell_over_delta", [10.0, 100.0])
def test_partitions_at_north_star_conditioning(ell_over_delta):
    """Kuu, T and P at the north star's ℓ/δ = 10 and at 100 (m = 320, B3,
    Matérn-3/2), 8-column chunks: both partitions hold the main paths' bar
    against the plain versions, and the walks' margins stay positive:
    σ_min(I − UᵀWU) > 0 on every matrix, W, Ẇ and β finite."""
    recs, h_max = check_against_plain(north_star_bands(ell_over_delta), 8, 8, TOL_MAIN)
    assert all(r["sigma"] > 0 and np.isfinite([r["w"], r["wdot"], r["beta"]]).all()
               for r in recs)
    assert np.isfinite(h_max)


def test_non_spd_band_gives_nan_from_the_failing_column():
    """A non-positive pivot in either stream of Kuu or P: K5's partition is
    finite before the failing column of that stream and NaN from it on, as
    the plain version is (N = I − UᵀWU loses definiteness with the chunk's
    true Schur complement, so the walk carries NaN to every later chunk);
    the other stream is unaffected."""
    k, m, lc = 3, 2 * 60 + 3, 8
    for fail_f, fail_r in ((5, 20), (16, 8), (30, 59)):
        kuu, tanb, p, b = inputs(k, m, fail_f)
        kuu[0, fail_f] = -1.0
        p[0, m - 1 - fail_r] = -1.0
        with np.errstate(invalid="ignore", divide="ignore"):
            got, _ = partitioned_k5(kuu, tanb, p, b, lc)
            want = twist.chol_quad_solve_tan_plain(kuu, tanb, p, b)
        for g_, w_ in zip(got, want):
            assert torch.equal(torch.isnan(g_), torch.isnan(w_))
            fin = ~torch.isnan(w_)
            assert rel(g_[fin].numpy(), w_[fin].numpy()) <= BAR
        l = got[0]
        for t, fail in ((0, fail_f), (3, fail_r)):
            assert torch.isnan(l[t, :, fail:]).any(0).all()
            assert not torch.isnan(l[t, :, :fail]).any()
        assert not torch.isnan(l[1]).any() and not torch.isnan(l[2]).any()


def test_chunk_cols_fit_the_walk_and_the_scan():
    """K5's chunks are 128 columns at m = 10⁴ at every k (40 a stream), K6's
    64 for k ≤ 3, then 128, 192, 320 (so that the scan's maps fit); every
    stream of any length fits the walk's and the scan's shared memory."""
    assert [chunk_cols(k, 10_000)[0] for k in range(1, 7)] == [128] * 6
    assert [chunk_cols(k, 10_000)[1] for k in range(1, 7)] == [64, 64, 64, 128, 192, 320]
    for k in range(1, 7):
        for m in (4 * k + 1, 300, 10_000, 100_001):
            h = split_point(m, k)
            for lc, per in zip(chunk_cols(k, m), (2 * (k * k + k * (k + 1)),
                                                  (k * (k + 1)) ** 2 + k * (k + 1))):
                maps = -(-h // lc) - 1
                assert maps * per * 8 <= SMEM_LIMIT and maps < MAX_CHUNKS
                assert lc == h or lc % TILE == 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA twisted sweeps have no CPU mode")
    return torch.device("cuda", 0)


def short_problem(bands, c):
    """The bands of a problem whose streams are the first c columns of each
    stream of ``bands``: F reads band columns < h and R the last g + k, so
    the first c columns and the last c + k (m' = 2c + k, h' = g' = c).
    K5 on it runs one pass, the one-chain recursion."""
    m = bands[0].shape[1]
    tail = c + bands[0].shape[0] - 1
    return [torch.cat([t[..., :c], t[..., m - tail:]], -1).contiguous() for t in bands]


# (k, m): both parities; R one 128-column chunk fewer (h = 129); one chunk;
# k = 6 at m = 10⁴ (K6's 320-column chunks)
CUDA_EDGES = [(1, 1000), (2, 1001), (3, 10_000), (3, 10_001), (2, 259), (3, 2 * 129 + 2),
              (4, 100), (5, 1000), (6, 10_000)]


@pytest.mark.cuda
@pytest.mark.parametrize("k, m", CUDA_EDGES)
def test_cuda_twist_sweeps_at_partition_edges(cuda_device, k, m):
    """K5 and K6 on the card against their plain versions at 1e-13, one
    count each per call, with ``core.twist_workspace``'s scratch; each
    stream's first 64 columns of K5 equal bit for bit to K5 on a problem
    whose streams are those columns alone (one pass)."""
    assert core.twist_workspace(k, m) >= 0
    bands = inputs(k, m, 60 + k)
    dev = cuda_device
    core.reset_counters()
    k5 = twist.chol_quad_solve_tan(*(t.to(dev) for t in bands))
    want5 = twist.chol_quad_solve_tan_plain(*bands)
    for got, want in zip(k5, want5):
        assert rel(got.cpu().numpy(), want.numpy()) <= BAR
    _, z, x2, _ = twist.mid_step(*bands, want5[0], want5[1], want5[4])
    k6 = twist.tak_quad_solve_tan(*(t.to(dev) for t in want5), z.to(dev), x2.to(dev), m)
    for got, want in zip(k6, twist.tak_quad_solve_tan_plain(*want5, z, x2, m)):
        assert rel(got.cpu().numpy(), want.numpy()) <= BAR
    torch.cuda.synchronize()
    assert {n: c for n, c in core.LAUNCHES.items() if c} == {"chol_quad_solve_tan": 1,
                                                            "tak_quad_solve_tan": 1}
    c = min(64, m - split_point(m, k) - k)
    short = short_problem(bands, c)
    one = twist.chol_quad_solve_tan(*(t.to(dev) for t in short))
    for got, o in zip(k5, one):
        assert torch.equal(got[..., :c], o[..., :c])
