"""Core banded linear-algebra ops and their plain-PyTorch recursions.

PyTorch counterpart of ``asvgp_tpu/banded/ops.py``.  Two layers:

* The plain recursions, ``*_plain``: Python loops over the m columns
  carrying a k-column window, each step a few small tensor ops vectorised
  over the (k+1) window.  The Cholesky (``cholesky_band_plain``), the
  Takahashi band of the inverse (``takahashi_inverse_band_plain``), the two
  triangular solves, and the explicit reverse-mode adjoints of the first two
  (``cholesky_band_bwd_plain``, ``takahashi_bwd_plain``).  Given a
  direction, the Cholesky and the Takahashi recursions also carry its
  forward tangent, and the Takahashi recursion can start from a seed window
  (the twisted streams).  They launch no kernel on any device: they are the
  plain versions that the hand-written GPU sweeps are held against.  The
  forward ones build no in-place state, so autograd can differentiate them.
* The public ops, which dispatch as the JAX package's ``ops`` does: a CPU
  tensor runs the plain recursion, a CUDA tensor its kernel.
  ``cholesky_band`` and ``takahashi_inverse_band`` are the differentiable
  ``single.CholeskyBand`` (K9 forward, K10 backward) and
  ``single.TakahashiInverseBand`` (K11, K12); ``cholesky_band_pair`` of two
  float64 bands of one shape is ``single.CholeskyBandPair`` (K15, backward
  K8 with a batch of two).  The solves are ``solve.SolveLowerBand`` (K13,
  backward K14) and ``solve.SolveUpperBandTranspose`` (K14, backward K13).
  ``collapsed_core`` is ``core.CollapsedCore`` (K1 + K2, backward K7 + K8)
  and ``banded_posterior`` runs K1 + K2.  ``collapsed_core_matern``
  dispatches the training core: the tangent-fused sweeps of banded/tan.py
  and banded/twist.py when a gradient is needed, ``collapsed_core``
  otherwise.
* The float32 route, as the JAX package's ``_use_pallas``: the Cholesky,
  Takahashi and solve Functions run the float32 forms of their kernels
  (K17–K22), and ``cholesky_band_pair``, ``collapsed_core``,
  ``collapsed_core_matern`` and ``banded_posterior`` take the composed
  route of single-matrix ops; no float64-only kernel (K1–K8, K15, K16,
  K23) takes a float32 tensor.
* Block cyclic reduction (banded/cyclic.py), the JAX package's "cr"
  backend: inside ``cr_scope(True)`` the collapsed core and the posterior
  run it on either device and in either dtype, batched library calls on
  k×k blocks in ⌈log₂(m/k)⌉ levels, and launch no kernel.

Band products and matvecs are parallel diagonal convolutions over static
offsets: plain tensor ops on any device, as in the JAX package.
"""

from __future__ import annotations

import torch

from asvgp_tpu_torch.banded.layout import mask_band, shift_cols


def _col_mask(i: int, k: int, m: int, like: torch.Tensor) -> torch.Tensor:
    """Mask (k+1,) of valid band rows for column i: row j valid iff i + j < m."""
    return (i + torch.arange(k + 1, device=like.device) < m).to(like.dtype)


def cholesky_band_plain(a_band: torch.Tensor, t_band: torch.Tensor | None = None):
    """Banded Cholesky: lower band of L with A = L L^T.

    Args:
      a_band: (k+1, m) lower band of a symmetric positive-definite matrix.
      t_band: optional (k+1, m) lower band of a symmetric direction T.
    Returns:
      (k+1, m) lower band of L, right-padding slots zeroed; with ``t_band``,
      (L, L̇) with L̇ = ∂_ε chol(A + εT) in the same layout.  Per column,
      with r = a − s, rv = 1/√r₀ and c = r·rv:
        ṙ = Ṫ_col − Σ_p [ġ_p W_p + g_p Ẇ_p],  e = −½ rv² ṙ₀,  ċ = rv·ṙ + c·e.
    """
    k = a_band.shape[0] - 1
    m = a_band.shape[1]
    tangent = t_band is not None
    if k == 0:
        l0 = torch.sqrt(a_band)
        return (l0, 0.5 * t_band / l0) if tangent else l0
    w = k + 1
    # window: win[(p-1)*w + r] = L[i-p+r, i-p] (band entry r of column i-p),
    # with one zero slot at the end for the entries beyond the band
    idx = torch.tensor(
        [[(p - 1) * w + p + j if p + j <= k else k * w for j in range(w)]
         for p in range(1, k + 1)],
        device=a_band.device,
    ).reshape(-1)
    zero = a_band.new_zeros(1)
    win = a_band.new_zeros(k * w + 1)
    twin = a_band.new_zeros(k * w + 1)
    cols, tcols = [], []
    t_cols = t_band.T.unbind(0) if tangent else None
    for i, a_col in enumerate(a_band.T.unbind(0)):
        # S[p-1, j] = L[i+j, i-p]; column 0 is g_p = L[i, i-p]
        S = win.index_select(0, idx).view(k, w)
        r = a_col - S[:, 0] @ S
        l0 = torch.sqrt(r[:1])
        col = torch.cat([l0, r[1:] / l0])
        if tangent:
            TS = twin.index_select(0, idx).view(k, w)
            tr = t_cols[i] - (TS[:, 0] @ S + S[:, 0] @ TS)
            rv = 1.0 / l0
            e = -0.5 * rv * rv * tr[:1]
            tcol = tr * rv + col * e
        if i + k >= m:
            mask = _col_mask(i, k, m, col)
            col = col * mask
            if tangent:
                tcol = tcol * mask
        cols.append(col)
        win = torch.cat([col, win[:(k - 1) * w], zero])
        if tangent:
            tcols.append(tcol)
            twin = torch.cat([tcol, twin[:(k - 1) * w], zero])
    l_band = torch.stack(cols, dim=1)
    return (l_band, torch.stack(tcols, dim=1)) if tangent else l_band


def cholesky_band_bwd_plain(l_band: torch.Tensor, cot: torch.Tensor) -> torch.Tensor:
    """Ā from L = chol(A) and L̄: the reverse-mode recursion of
    ``cholesky_band_plain``, written out (the plain version of K10 and K8).

    Columns i = m−1..0; P carries the adjoint that later columns sent to
    the k columns before them (P[r] for column i−1−r).  Per column, with
    l̄ = (cot + P[0])·mask and iv = 1/L[i, i]:
      ā₀ = ½·iv·(l̄₀ − iv·Σ_{r≥1} l̄_r L[i+r, i]),  ā_r = l̄_r·iv,  s̄ = −ā,
    and for p = 1..k, with g_p = L[i, i−p] and W_p[r] = L[i−p+r, i−p]:
      W̄_p[r] += s̄[r−p]·g_p (r ≥ p),  W̄_p[p] += Σ_j s̄_j W_p[p+j].
    Right-padding slots take no cotangent and get zero, as in the JAX VJP.
    """
    k = l_band.shape[0] - 1
    m = l_band.shape[1]
    if k == 0:
        return cot / (2.0 * l_band)
    w = k + 1
    dev = l_band.device
    mask = mask_band(torch.ones_like(l_band), k, 0)
    # column i-p of L at lpad[:, i + k - p]; zeros before column 0
    lpad = torch.cat([l_band.new_zeros((w, k)), l_band], dim=1)
    # flat window W (k, k+1) plus one zero slot: g[p-1] = W[p-1, p],
    # wsh[p-1, j] = W[p-1, p+j] (0 beyond the band)
    zero_slot = k * w
    g_idx = torch.tensor([(p - 1) * w + p for p in range(1, k + 1)], device=dev)
    wsh_idx = torch.tensor([[(p - 1) * w + p + j if p + j <= k else zero_slot for j in range(w)]
                            for p in range(1, k + 1)], device=dev).reshape(-1)
    # sbr[p-1, r] = s̄[r-p] for r >= p, else the zero slot w
    sb_idx = torch.tensor([[r - p if r >= p else w for r in range(w)]
                           for p in range(1, k + 1)], device=dev).reshape(-1)
    at_p = torch.zeros((k, w), dtype=l_band.dtype, device=dev)
    for p in range(1, k + 1):
        at_p[p - 1, p] = 1.0
    zero = l_band.new_zeros(1)
    P = l_band.new_zeros((k, w))
    cols = []
    for i in range(m - 1, -1, -1):
        lc = l_band[:, i]
        lb = (cot[:, i] + P[0]) * mask[:, i]
        iv = 1.0 / lc[0]
        t1 = lb[1:] @ lc[1:]
        db = (lb[0] - t1 * iv) * (0.5 * iv)
        ab = torch.cat([db[None], lb[1:] * iv])
        cols.append(ab)
        sb = torch.cat([-ab, zero])
        W = torch.cat([lpad[:, i: i + k].flip(1).T.reshape(-1), zero])
        g = W.index_select(0, g_idx)
        gbar = sb[:w] @ W.index_select(0, wsh_idx).view(k, w).T
        wbar = sb.index_select(0, sb_idx).view(k, w) * g[:, None] + gbar[:, None] * at_p
        P = torch.cat([P[1:], l_band.new_zeros((1, w))]) + wbar
    cols.reverse()
    return torch.stack(cols, dim=1)


def cholesky_band_pair(a_band: torch.Tensor, b_band: torch.Tensor):
    """Factor two independent banded SPD matrices, differentiable: for two
    float64 bands of one shape ``single.CholeskyBandPair`` (on a CUDA tensor
    one K15 launch forward, K8 with a batch of two backward), else two
    ``cholesky_band`` calls (in float32: K17 twice, backward K18 twice), as
    in the JAX package."""
    from asvgp_tpu_torch.banded import single

    if a_band.shape == b_band.shape and a_band.dtype == torch.float64:
        return single.CholeskyBandPair.apply(a_band, b_band)
    return cholesky_band(a_band), cholesky_band(b_band)


def cholesky_band(a_band: torch.Tensor) -> torch.Tensor:
    """Banded Cholesky, differentiable: the plain recursion on a CPU tensor,
    K9 (backward K10) on a CUDA tensor (``single.CholeskyBand``)."""
    from asvgp_tpu_torch.banded import single

    return single.CholeskyBand.apply(a_band)


def takahashi_inverse_band(l_band: torch.Tensor) -> torch.Tensor:
    """Band of A⁻¹ from the banded Cholesky factor L, differentiable: the
    plain recursion on a CPU tensor, K11 (backward K12) on a CUDA tensor
    (``single.TakahashiInverseBand``)."""
    from asvgp_tpu_torch.banded import single

    return single.TakahashiInverseBand.apply(l_band)


def solve_lower_band(l_band: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L x = b, b of shape (m,) or (m, r), differentiable in L and b:
    the plain recursion on a CPU tensor, K13 (float64) or K21 (float32) on
    a CUDA tensor, backward through the transposed solve
    (``solve.SolveLowerBand``)."""
    from asvgp_tpu_torch.banded import solve

    return solve.SolveLowerBand.apply(l_band, b)


def solve_upper_band_transpose(l_band: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve Lᵀ x = b, differentiable in L and b: the plain recursion on a
    CPU tensor, K14 (float64) or K22 (float32) on a CUDA tensor, backward
    through the lower solve (``solve.SolveUpperBandTranspose``)."""
    from asvgp_tpu_torch.banded import solve

    return solve.SolveUpperBandTranspose.apply(l_band, b)


def log_det_from_cholesky(l_band: torch.Tensor) -> torch.Tensor:
    """log|A| = 2 sum_i log L[i, i] given the banded Cholesky factor."""
    return 2.0 * torch.sum(torch.log(l_band[0]))


def solve_lower_band_plain(l_band: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L x = b for banded lower-triangular L (forward substitution).

    Args:
      l_band: (k+1, m) lower band of L.
      b: (m,) or (m, r) right-hand side.
    Returns:
      x with the same shape as b.
    """
    k = l_band.shape[0] - 1
    vec = b.ndim == 1
    b2 = b[:, None] if vec else b
    if k == 0:
        x = b2 / l_band[0][:, None]
        return x[:, 0] if vec else x
    # G[p-1, i] = L[i, i-p] = l_band[p, i-p]
    G = torch.stack([shift_cols(l_band[p], -p) for p in range(1, k + 1)], dim=0)
    X = b2.new_zeros((k, b2.shape[1]))  # X[p-1] = x[i-p]
    xs = []
    for g, l0, b_row in zip(G.T.unbind(0), l_band[0].unbind(0), b2.unbind(0)):
        xi = (b_row - g @ X) / l0
        xs.append(xi)
        X = torch.cat([xi[None], X[:-1]], dim=0)
    x = torch.stack(xs, dim=0)
    return x[:, 0] if vec else x


def solve_upper_band_transpose_plain(l_band: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L^T x = b for banded lower-triangular L (backward substitution)."""
    k = l_band.shape[0] - 1
    vec = b.ndim == 1
    b2 = b[:, None] if vec else b
    if k == 0:
        x = b2 / l_band[0][:, None]
        return x[:, 0] if vec else x
    X = b2.new_zeros((k, b2.shape[1]))  # X[p-1] = x[i+p]
    xs = []
    for l_col, b_row in zip(reversed(l_band.T.unbind(0)), reversed(b2.unbind(0))):
        xi = (b_row - l_col[1:] @ X) / l_col[0]
        xs.append(xi)
        X = torch.cat([xi[None], X[:-1]], dim=0)
    xs.reverse()
    x = torch.stack(xs, dim=0)
    return x[:, 0] if vec else x


def cholesky_solve_band(l_band: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b given the banded Cholesky factor L of A."""
    return solve_upper_band_transpose(l_band, solve_lower_band(l_band, b))


def takahashi_inverse_band_plain(l_band: torch.Tensor, ldot_band: torch.Tensor | None = None,
                                 seed: torch.Tensor | None = None,
                                 seed_dot: torch.Tensor | None = None):
    """Band of A^{-1} from the banded Cholesky factor L (Takahashi recursion).

    Computes the entries of S = A^{-1} on the band |i - j| <= k exactly
    (the sparse-inverse-subset recursion is exact on the sparsity pattern of
    L^T + L).

    Args:
      l_band: (k+1, m) lower band of L (right-padding must be zero, as
        produced by :func:`cholesky_band`).
      ldot_band: optional tangent L̇ of the factor (same layout).
      seed: optional (k, k+1) window, seed[p-1, r] = S[m-1+p+r, m-1+p]: the
        entries of S beyond the m columns given, from which the recursion
        starts (the seeded Takahashi of the twisted streams, whose factor
        columns spill into a middle block); nothing is masked then.
      seed_dot: the tangent of ``seed`` (zero if omitted).
    Returns:
      (k+1, m) lower band of A^{-1}; with ``ldot_band``, (S, Ṡ).  Per
      column, with aq = Σ_p CS·w_p, s_q = −aq·d, sj = d² − (Σ_q w_q s_q)·d:
        ȧq = Σ_p [ĊS·w_p + CS·ẇ_p],  ṡ_q = −(ȧq·d + aq·ḋ),
        ṡj = 2d·ḋ − (ẇs·d + ws·ḋ),  ẇs = Σ_q [ẇ_q s_q + w_q ṡ_q].
    """
    k = l_band.shape[0] - 1
    m = l_band.shape[1]
    tangent = ldot_band is not None
    if k == 0:
        s = 1.0 / (l_band * l_band)
        return (s, -2.0 * s * ldot_band / l_band) if tangent else s
    w = k + 1
    # window: cs[(p-1)*w + r] = S_band[r, j+p] (zeros beyond the end);
    # M[q-1, p-1] = S[j+max(p,q), j+min(p,q)] = S_band[|q-p|, j+min(p,q)]
    idx = torch.tensor(
        [[(min(p, q) - 1) * w + abs(q - p) for p in range(1, k + 1)]
         for q in range(1, k + 1)],
        device=l_band.device,
    ).reshape(-1)
    taper = seed is None
    cs = l_band.new_zeros(k * w) if seed is None else seed.reshape(-1)
    tcs = l_band.new_zeros(k * w) if seed_dot is None else seed_dot.reshape(-1)
    cols, tcols = [], []
    l_cols = l_band.T.unbind(0)
    t_cols = ldot_band.T.unbind(0) if tangent else None
    for j in range(m - 1, -1, -1):
        l_col = l_cols[j]
        d = 1.0 / l_col[:1]
        wv = l_col[1:]  # wv[p-1] = L[j+p, j]
        M = cs.index_select(0, idx).view(k, k)
        aq = M @ wv
        s = -d * aq  # off-diagonal S[j+q, j], q = 1..k
        ws = wv @ s
        col = torch.cat([d * d - d * ws, s])
        if tangent:
            t_col = t_cols[j]
            td = -d * d * t_col[:1]
            twv = t_col[1:]
            taq = tcs.index_select(0, idx).view(k, k) @ wv + M @ twv
            ts = -(taq * d + aq * td)
            tws = twv @ s + wv @ ts
            tcol = torch.cat([2.0 * d * td - (tws * d + ws * td), ts])
        if taper and j + k >= m:
            mask = _col_mask(j, k, m, col)
            col = col * mask
            if tangent:
                tcol = tcol * mask
        cols.append(col)
        cs = torch.cat([col, cs[:(k - 1) * w]])
        if tangent:
            tcols.append(tcol)
            tcs = torch.cat([tcol, tcs[:(k - 1) * w]])
    cols.reverse()
    s_band = torch.stack(cols, dim=1)
    if not tangent:
        return s_band
    tcols.reverse()
    return s_band, torch.stack(tcols, dim=1)


def takahashi_bwd_plain(l_band: torch.Tensor, s_band: torch.Tensor, cot: torch.Tensor,
                        iv: torch.Tensor | None = None) -> torch.Tensor:
    """L̄ from L, S = takahashi_inverse_band(L) and S̄: the reverse-mode
    recursion of ``takahashi_inverse_band_plain``, written out (the plain
    version of K12 and, given the reciprocal pivots ``iv`` = 1/diag(L), of
    K7, which then takes d from ``iv`` instead of dividing).

    Columns j = 0..m−1; Q carries the adjoint sent to the S columns
    j+1..j+k (Q[c] for column j+1+c).  Per column, with c̄ = (cot + Q[0])·mask,
    d = 1/L[j, j], w_q = L[j+q, j], s_q = S[j+q, j], t_q = −s_q·L[j, j],
    M[q, p] = S[j+max(p,q), j+min(p,q)] and m₁ = d·c̄₀:
      d̄ = 2m₁ − c̄₀·Σ w_q s_q − Σ s̄_q t_q,   s̄_q = c̄_q − m₁ w_q,
      t̄_q = −d s̄_q,  w̄_p = −m₁ s_p + Σ_q t̄_q M[q, p],  L̄[j, j] = −d̄ d²,
    and Q[min(p,q)−1][|q−p|] += t̄_q w_p.  Right-padding slots of S take no
    cotangent and those of L̄ come out zero, as in the JAX VJP.
    """
    k = l_band.shape[0] - 1
    m = l_band.shape[1]
    if k == 0:
        return -2.0 * cot * (iv ** 3 if iv is not None else 1.0 / l_band ** 3)
    w = k + 1
    dev = l_band.device
    mask = mask_band(torch.ones_like(l_band), k, 0)
    # S columns j+1..j+k at spad[:, j+1 : j+1+k]; zeros beyond the end
    spad = torch.cat([s_band, s_band.new_zeros((w, k))], dim=1)
    # gather of the flat window cs[c*w + r] = S_band[r, j+1+c] into M (k, k),
    # M[q-1, p-1] = cs[(min(p,q)-1)*w + |q-p|]; its transpose scatters back
    gather = torch.zeros((k * k, k * w), dtype=l_band.dtype, device=dev)
    for q in range(1, k + 1):
        for p in range(1, k + 1):
            gather[(q - 1) * k + (p - 1), (min(p, q) - 1) * w + abs(q - p)] = 1.0
    Q = l_band.new_zeros((k, w))
    cols = []
    for j in range(m):
        lc = l_band[:, j]
        l0 = lc[0]
        d = iv[j] if iv is not None else 1.0 / l0
        cb = (cot[:, j] + Q[0]) * mask[:, j]
        wv = lc[1:]
        sv = s_band[1:, j]
        t = -sv * l0
        m1 = d * cb[0]
        db = 2.0 * m1 - (wv @ sv) * cb[0]
        sbar = cb[1:] - m1 * wv
        db = db - sbar @ t
        tbar = -d * sbar
        M = (gather @ spad[:, j + 1: j + 1 + k].T.reshape(-1)).view(k, k)
        wbar = -m1 * sv + tbar @ M
        cols.append(torch.cat([(-db * d * d)[None], wbar]))
        csbar = (torch.outer(tbar, wv).reshape(-1) @ gather).view(k, w)
        Q = torch.cat([Q[1:], l_band.new_zeros((1, w))]) + csbar
    return torch.stack(cols, dim=1)


def band_frobenius(a_band: torch.Tensor, b_band: torch.Tensor) -> torch.Tensor:
    """trace(A @ B) for symmetric A, B given as lower bands:
    tr(AB) = sum_i a0_i b0_i + 2 sum_{j>=1,i} aj_i bj_i."""
    kw = min(a_band.shape[0], b_band.shape[0])
    a = a_band[:kw]
    b = b_band[:kw]
    return torch.sum(a[0] * b[0]) + 2.0 * torch.sum(a[1:] * b[1:])


def product_band_band(a_band: torch.Tensor, b_band: torch.Tensor, *, a_lower: int,
                      a_upper: int, b_lower: int, b_upper: int, out_lower: int,
                      out_upper: int) -> torch.Tensor:
    """C = A @ B restricted to the output band (out_lower, out_upper), all in
    general-band storage: a parallel diagonal convolution, no recursion."""
    m = a_band.shape[1]
    rows = []
    for c in range(-out_upper, out_lower + 1):
        row = a_band.new_zeros(m)
        for s in range(-b_upper, b_lower + 1):
            a_off = c - s
            if not -a_upper <= a_off <= a_lower:
                continue
            # C[j + c, j] += A[j + c, j + s] * B[j + s, j]
            row = row + shift_cols(a_band[a_off + a_upper], s) * b_band[s + b_upper]
        rows.append(row)
    return mask_band(torch.stack(rows, dim=0), out_lower, out_upper)


def matvec_band(band: torch.Tensor, x: torch.Tensor, *, lower: int, upper: int) -> torch.Tensor:
    """y = M x for M in general-band storage; x is (m,)."""
    y = torch.zeros_like(x)
    for r in range(lower + upper + 1):
        off = r - upper  # y[i + off] += band[r, i] * x[i]
        y = y + shift_cols(band[r] * x, -off)
    return y


def matvec_symmetric_band(lower_band: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = M x for symmetric M given as a lower band; x is (m,)."""
    k = lower_band.shape[0] - 1
    y = lower_band[0] * x
    for j in range(1, k + 1):
        row = lower_band[j]
        y = y + shift_cols(row * x, -j)  # lower part: y[i+j] += row[i] x[i]
        y = y + row * shift_cols(x, j)   # upper part: y[i] += row[i] x[i+j]
    return y


def collapsed_core(kuu_band, p_band, b, big_band):
    """(log|Kuu|, log|P|, bᵀP⁻¹b, tr(Kuu⁻¹ B)), differentiable in all four
    inputs: in float64 ``core.CollapsedCore`` (K1 + K2, backward K7 + K8);
    in float32 composed of the differentiable single-matrix ops, as the
    JAX package composes them outside its double-single route (ops.py
    ``collapsed_core``): the two Choleskys, the Takahashi band of Kuu⁻¹ and
    the lower solve (K17 ×2, K19, K21; backward K18 ×2, K20, K22).  Inside
    ``cr_scope(True)``, for bands of one shape and a vector ``b``, block
    cyclic reduction (banded/cyclic.py) in either dtype, no kernel."""
    from asvgp_tpu_torch.banded import core

    if kuu_band.shape == p_band.shape == big_band.shape and b.ndim == 1 and _cr_enabled():
        from asvgp_tpu_torch.banded import cyclic

        ld_p, u = cyclic.cr_logdet_solve(p_band, b)
        # tr(Kuu⁻¹B) = ⟨∇log|Kuu|, B⟩ from the same reduction as log|Kuu|
        ld_kuu, trace = cyclic.cr_logdet_trace(kuu_band, big_band)
        return ld_kuu, ld_p, torch.dot(b, u), trace
    if kuu_band.dtype == torch.float32:
        l_kuu, l_p = cholesky_band_pair(kuu_band, p_band)
        s_kuu = takahashi_inverse_band(l_kuu)
        c0 = solve_lower_band(l_p, b)
        return (
            log_det_from_cholesky(l_kuu),
            log_det_from_cholesky(l_p),
            torch.sum(torch.square(c0)),
            band_frobenius(s_kuu, big_band),
        )
    return core.collapsed_core(kuu_band, p_band, b, big_band)


# twisted (two-ended) sweeps for the Matérn collapsed core: on by default,
# as in the JAX package; scoped, so a caller can force either route
_TWIST_SCOPE: list = []


class twist_scope:
    """Context manager: force the twisted dispatch of
    ``collapsed_core_matern`` on or off inside the block.  ``enabled=None``
    is a no-op (the default: on)."""

    def __init__(self, enabled):
        self.enabled = enabled

    def __enter__(self):
        if self.enabled is not None:
            _TWIST_SCOPE.append(bool(self.enabled))
        return self

    def __exit__(self, *exc):
        if self.enabled is not None:
            _TWIST_SCOPE.pop()
        return False


def _twist_enabled() -> bool:
    return _TWIST_SCOPE[-1] if _TWIST_SCOPE else True


# block cyclic reduction (banded/cyclic.py) for the collapsed core and the
# posterior: off by default, as in the JAX package, where it is the "cr"
# backend; scoped like the twisted dispatch
_CR_SCOPE: list = []


class cr_scope:
    """Context manager: route ``collapsed_core``, ``collapsed_core_matern``
    and ``banded_posterior`` through block cyclic reduction inside the
    block (``True``) or not (``False``).  ``enabled=None`` is a no-op (the
    default: off)."""

    def __init__(self, enabled):
        self.enabled = enabled

    def __enter__(self):
        if self.enabled is not None:
            _CR_SCOPE.append(bool(self.enabled))
        return self

    def __exit__(self, *exc):
        if self.enabled is not None:
            _CR_SCOPE.pop()
        return False


def _cr_enabled() -> bool:
    return _CR_SCOPE[-1] if _CR_SCOPE else False


def collapsed_core_matern(kuu_fn, var, ell, p_band, b, big_band):
    """``collapsed_core`` with the Matérn hyperparameter structure exposed:
    Kuu = kuu_fn(var, ell), and kuu_fn(var, ell) = var⁻¹·G(ell) (true of
    every Matérn RKHS Gram band, ``make_kuu``).

    When a gradient is needed it runs the tangent-fused sweeps with their
    elementwise backward: the twisted K5 + K6 (banded/twist.py) where
    ``twist_applicable`` holds and ``twist_scope`` is on, the single-ended
    K3 + K4 (banded/tan.py) otherwise.  Without a gradient it is the value
    path of ``collapsed_core`` (K1 + K2), as in the JAX package's primal.
    Inside ``cr_scope(True)`` it is ``collapsed_core`` on the assembled
    band, by cyclic reduction, as the JAX package steps aside for "cr".
    """
    from asvgp_tpu_torch.banded import tan, twist

    k = p_band.shape[0] - 1
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (var, ell, p_band, b, big_band)
    )
    if not needs_grad or k < 1 or p_band.dtype == torch.float32 or _cr_enabled():
        return collapsed_core(kuu_fn(var, ell), p_band, b, big_band)
    if _twist_enabled() and twist.twist_applicable(k, p_band.shape[1]):
        return twist.collapsed_core_matern(kuu_fn, var, ell, p_band, b, big_band)
    return tan.collapsed_core_matern(kuu_fn, var, ell, p_band, b, big_band)


def banded_posterior(kuu_band, p_band, b):
    """(band of Kuu⁻¹, band of P⁻¹, P⁻¹ b) — the prediction-time posterior
    quantities: in float64 from the same two sweeps (K1 + K2); in float32
    composed as in the JAX package: the two Choleskys, both Takahashi bands
    and ``cholesky_solve_band`` (K17 ×2, K19 ×2, K21, K22).  Inside
    ``cr_scope(True)``, for bands of one shape and a vector ``b``, block
    cyclic reduction: both bands as gradients of the log-determinants."""
    from asvgp_tpu_torch.banded import core

    if kuu_band.shape == p_band.shape and b.ndim == 1 and _cr_enabled():
        from asvgp_tpu_torch.banded import cyclic

        s_p, u = cyclic.cr_inverse_band_solve(p_band, b)
        return cyclic.cr_inverse_band(kuu_band), s_p, u
    if kuu_band.dtype == torch.float32:
        l_kuu, l_p = cholesky_band_pair(kuu_band, p_band)
        return (takahashi_inverse_band(l_kuu), takahashi_inverse_band(l_p),
                cholesky_solve_band(l_p, b))
    _, _, s_kuu, s_p, _, u, _ = core.factor_takahashi_solve(kuu_band, p_band, b)
    return s_kuu, s_p, u
