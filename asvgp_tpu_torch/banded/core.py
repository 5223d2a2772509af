"""The banded core of the collapsed ELBO and the posterior, and its adjoint.

PyTorch counterpart of ``asvgp_tpu/banded/pallas_ds_core.py``.
``factor_takahashi_solve`` runs

  K1 ``chol_pair_solve`` (forward sweep): banded Cholesky of Kuu and of P,
     the lower solve L_P c₀ = b, and the reciprocal pivots of both;
  K2 ``tak_pair_solve`` (reverse sweep): Takahashi bands of Kuu⁻¹ and P⁻¹
     and the upper solve u = P⁻¹ b, divide-free from K1's pivots;

as hand-written CUDA kernels (csrc/banded_core.cu) on CUDA tensors, and as
their plain-PyTorch versions (``*_plain``, composed from banded/ops.py) on
CPU tensors.  Each kernel cuts its walk over the columns into chunks run in
parallel, one matrix a block: K1 joins them by a Schur-complement walk (with
the solve's coupling on P), K2 by a scan over their affine maps; three
launches, scratch from here (``core_workspace``), a call counts one launch.
For a CUDA tensor a wrapper launches its kernel or raises; it never falls
back.  Everything the ELBO value and the posterior need is
elementwise in the outputs: log|Kuu| and log|P| from the factor diagonals,
bᵀP⁻¹b = ‖c₀‖², tr(Kuu⁻¹B) = band-Frobenius(S_Kuu, B).

``CollapsedCore`` makes those four scalars differentiable, as
``collapsed_core_ds`` does: its backward is elementwise in the saved bands
except for the trace term, which runs

  K7 ``tak_bwd_vec``: the Takahashi adjoint L̄ from (L, S, S̄) and K1's
     reciprocal pivots (csrc/banded_adjoint.cu ``tak_bwd<K>``);
  K8 ``chol_bwd_pair``: the Cholesky adjoint K̄uu from (L, L̄), batched and
     called on one matrix (``chol_bwd<K>``).

Both adjoint kernels cut their walk over the columns into chunks (three
launches: the chunks' affine maps, a scan over them, the outputs), with
scratch from here (``carry_workspace``); a call counts one launch.

``tak_bwd_pair`` (K23) is K7 for two matrices in one launch.

``LAUNCHES`` counts the kernel launches of each wrapper and
``PLAIN_CALLS`` the calls of the plain versions by device type, so that a
run can show which path it took.
"""

from __future__ import annotations

import functools

import torch

from asvgp_tpu_torch.banded import _build, ops

# one count per kernel: K1, K2, K7, K8, K23 here; K3, K4 in banded/tan.py;
# K5, K6 in banded/twist.py; K9-K12, K15 and their float32 forms K17-K20 in
# banded/single.py; K13, K14 and their float32 forms K21, K22 in
# banded/solve.py; K16 in banded/dense_block.py; K24 in
# banded/block_window.py.  K7, K12 and K23 share one CUDA kernel, K8 and
# K10 another, K9 and K15 a third: each wrapper keeps its own count, and
# each dtype route its own
LAUNCHES = {
    "chol_pair_solve": 0,
    "tak_pair_solve": 0,
    "chol_pair_solve_tan": 0,
    "tak_pair_solve_tan": 0,
    "chol_quad_solve_tan": 0,
    "tak_quad_solve_tan": 0,
    "tak_bwd_vec": 0,
    "chol_bwd_pair": 0,
    "chol_fwd": 0,
    "chol_bwd": 0,
    "tak_fwd": 0,
    "tak_bwd": 0,
    "chol_fwd_pair": 0,
    "tak_bwd_pair": 0,
    "chol_inv_dense": 0,
    "solve_lower": 0,
    "solve_upper_t": 0,
    "chol_fwd_f32": 0,
    "chol_bwd_f32": 0,
    "tak_fwd_f32": 0,
    "tak_bwd_f32": 0,
    "solve_lower_f32": 0,
    "solve_upper_t_f32": 0,
    "block_window_quad": 0,
}
PLAIN_CALLS = {"cpu": 0, "cuda": 0}

MAX_K = 6


def reset_counters() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for key in d:
            d[key] = 0


def _count_plain(t: torch.Tensor) -> None:
    PLAIN_CALLS[t.device.type] = PLAIN_CALLS.get(t.device.type, 0) + 1


def _check_shapes(bands, vecs):
    """(k, m) of same-shape (k+1, m) bands with (m,) vectors, all on one device."""
    kp1, m = bands[0].shape
    for t in bands:
        if t.ndim != 2 or tuple(t.shape) != (kp1, m):
            raise ValueError(f"bands must all be (k+1, m) = {(kp1, m)}, got {tuple(t.shape)}")
    for t in vecs:
        if tuple(t.shape) != (m,):
            raise ValueError(f"vectors must be (m,) = ({m},), got {tuple(t.shape)}")
    devices = {t.device for t in (*bands, *vecs)}
    if len(devices) != 1:
        raise ValueError(f"all operands must lie on one device, got {sorted(map(str, devices))}")
    return kp1 - 1, m


def _check_cuda(k: int, tensors, dtypes=(torch.float64,)) -> None:
    """Raise on what the CUDA kernels do not take: every tensor on one CUDA
    device and of one dtype among ``dtypes`` (float64 alone for the kernels
    that have no float32 form in the JAX package either)."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"banded sweeps run on 'cpu' or 'cuda' tensors, got {dev}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"the CUDA sweeps take bandwidth k in 1..{MAX_K}, got k={k}")
    names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
    for t in tensors:
        if t.dtype not in dtypes or t.dtype != tensors[0].dtype:
            raise TypeError(f"this CUDA sweep takes {names} tensors of one dtype, got "
                            f"{sorted({str(u.dtype) for u in tensors})}")
        if not t.is_contiguous():
            raise ValueError("the CUDA sweeps take contiguous tensors")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "a banded sweep on the GPU is not differentiable by itself: differentiate "
            "through the autograd Functions that run it (banded.collapsed_core, "
            "cholesky_band, takahashi_inverse_band, collapsed_core_matern), or call "
            "it under torch.no_grad()"
        )


@functools.lru_cache(maxsize=64)
def carry_workspace(k: int, m: int, nb: int) -> int:
    """Elements of scratch the chunk maps of a linear sweep (the Takahashi
    band K11, K19 and the adjoints K7, K8, K10, K12, K18, K20, K23) need
    for nb (k+1, m) bands (0 when the columns form one chunk), asked of the
    kernels' library once per shape."""
    return _build.load().asvgp_carry_workspace(k, m, nb)


@functools.lru_cache(maxsize=64)
def schur_workspace(k: int, m: int, nb: int) -> int:
    """Elements of scratch the chunk triples and walked Schur-complement
    updates of the Cholesky sweep (K9, K15, K17) need for nb (k+1, m)
    bands (0 when the columns form one chunk), asked of the kernels'
    library once per shape."""
    return _build.load().asvgp_schur_workspace(k, m, nb)


@functools.lru_cache(maxsize=64)
def twist_workspace(k: int, m: int) -> int:
    """Elements of float64 scratch the twisted sweeps (K5's chunk triples
    and walked Schur-complement updates, K6's chunk maps) need at (k, m),
    for the four matrices of both streams (0 when every stream is one
    chunk), asked of the kernels' library once per shape."""
    return _build.load().asvgp_twist_workspace(k, m)


@functools.lru_cache(maxsize=64)
def core_workspace(k: int, m: int) -> int:
    """Elements of float64 scratch the serving sweeps (K1's chunk triples
    and walked Schur-complement updates, K2's chunk maps) need at (k, m),
    for both matrices (0 when the columns form one chunk), asked of the
    kernels' library once per shape."""
    return _build.load().asvgp_core_workspace(k, m)


@functools.lru_cache(maxsize=64)
def tan_workspace(k: int, m: int) -> int:
    """Elements of float64 scratch the single-ended tangent sweeps (K3's
    chunk triples and walked Schur-complement updates, K4's chunk maps)
    need at (k, m), for both matrices (0 when the columns form one chunk),
    asked of the kernels' library once per shape."""
    return _build.load().asvgp_tan_workspace(k, m)


def chosen_chunk_cols(sweep: str, *factors, m: int | None = None) -> int:
    """The chunk length the named sweep takes on the card for these factors,
    as its rule chooses it there (``banded/chunk_rule.py``): ``"linear"``
    (the Takahashi band and the adjoints; one (nb, k+1, m) or (k+1, m)
    factor of either dtype), ``"core"`` (K2: l_kuu, l_p), ``"tan"`` (K4:
    l_kuu, l_p) or ``"twist"`` (K6: K5's (4, k+1, h) stream factors, and
    ``m``).  It reads the length back to the host: for reporting, never
    inside a sweep."""
    lib = _build.load()
    f = factors[0]
    k = f.shape[-2] - 1
    with torch.cuda.device(f.device):
        stream = torch.cuda.current_stream().cuda_stream
        if sweep == "linear":
            nb = 1 if f.ndim == 2 else f.shape[0]
            n = f.shape[-1]
            ws = f.new_empty(carry_workspace(k, n, nb))
            rc = lib.asvgp_linear_chunk_cols(k, n, nb, f.data_ptr(),
                                             int(f.dtype == torch.float32), ws.data_ptr(),
                                             stream)
        elif sweep in ("core", "tan"):
            n = f.shape[-1]
            size = core_workspace(k, n) if sweep == "core" else tan_workspace(k, n)
            ws = f.new_empty(size)
            entry = lib.asvgp_core_tak_chunk_cols if sweep == "core" else lib.asvgp_tan_tak_chunk_cols
            rc = entry(k, n, f.data_ptr(), factors[1].data_ptr(), ws.data_ptr(), stream)
        elif sweep == "twist":
            ws = f.new_empty(twist_workspace(k, m))
            rc = lib.asvgp_twist_tak_chunk_cols(k, m, f.shape[-1], f.data_ptr(), ws.data_ptr(),
                                                stream)
        else:
            raise ValueError(f"unknown sweep {sweep!r}")
    if rc < 1:
        raise RuntimeError(f"the chunk-length rule of {sweep!r} failed ({rc})")
    return rc


def _launch(counter: str, entry: str, device: torch.device, *args) -> None:
    """Call the C entry point ``entry`` with ``args`` and the current stream
    of ``device``, raise on its error code, and count the launch."""
    lib = _build.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, entry)(*args, stream)
    _build.check(lib, rc, counter)
    LAUNCHES[counter] += 1


# ---------------------------------------------------------------------------
# K1: forward sweep
# ---------------------------------------------------------------------------


def chol_pair_solve_plain(kuu_band, p_band, b):
    """Plain version of K1: (l_kuu, l_p, iv (2, m), c0)."""
    _count_plain(kuu_band)
    l_kuu, l_p = ops.cholesky_band_plain(kuu_band), ops.cholesky_band_plain(p_band)
    iv = torch.stack([1.0 / l_kuu[0], 1.0 / l_p[0]], dim=0)
    c0 = ops.solve_lower_band_plain(l_p, b)
    return l_kuu, l_p, iv, c0


def chol_pair_solve(kuu_band, p_band, b):
    """K1 on CUDA tensors, its plain version on CPU tensors.

    Returns (l_kuu, l_p, iv, c0): the Cholesky bands of Kuu and P, their
    reciprocal pivots iv = [1/diag(L_Kuu); 1/diag(L_P)] and c0 = L_P⁻¹ b."""
    k, m = _check_shapes((kuu_band, p_band), (b,))
    if kuu_band.device.type == "cpu":
        return chol_pair_solve_plain(kuu_band, p_band, b)
    _check_cuda(k, (kuu_band, p_band, b))
    l_kuu = torch.empty_like(kuu_band)
    l_p = torch.empty_like(p_band)
    iv = kuu_band.new_empty((2, m))
    c0 = kuu_band.new_empty((m,))
    ws = kuu_band.new_empty(core_workspace(k, m))
    _launch("chol_pair_solve", "asvgp_chol_pair_solve", kuu_band.device, k, m,
            *(t.data_ptr() for t in (kuu_band, p_band, b, l_kuu, l_p, iv, c0, ws)))
    return l_kuu, l_p, iv, c0


# ---------------------------------------------------------------------------
# K2: reverse sweep
# ---------------------------------------------------------------------------


def tak_pair_solve_plain(l_kuu, l_p, iv, c0):
    """Plain version of K2: (s_kuu, s_p, u).  ``iv`` is implied by the
    factors' diagonals and is not read."""
    _count_plain(l_kuu)
    s_kuu = ops.takahashi_inverse_band_plain(l_kuu)
    s_p = ops.takahashi_inverse_band_plain(l_p)
    u = ops.solve_upper_band_transpose_plain(l_p, c0)
    return s_kuu, s_p, u


def tak_pair_solve(l_kuu, l_p, iv, c0):
    """K2 on CUDA tensors, its plain version on CPU tensors.

    Takes K1's outputs; returns (s_kuu, s_p, u): the bands of Kuu⁻¹ and
    P⁻¹ and u = L_P⁻ᵀ c0 = P⁻¹ b."""
    k, m = _check_shapes((l_kuu, l_p), (c0,))
    if tuple(iv.shape) != (2, m) or iv.device != l_kuu.device:
        raise ValueError(f"iv must be (2, m) = (2, {m}) on {l_kuu.device}")
    if l_kuu.device.type == "cpu":
        return tak_pair_solve_plain(l_kuu, l_p, iv, c0)
    _check_cuda(k, (l_kuu, l_p, iv, c0))
    s_kuu = torch.empty_like(l_kuu)
    s_p = torch.empty_like(l_p)
    u = c0.new_empty((m,))
    ws = l_kuu.new_empty(core_workspace(k, m))
    _launch("tak_pair_solve", "asvgp_tak_pair_solve", l_kuu.device, k, m,
            *(t.data_ptr() for t in (l_kuu, l_p, iv, c0, s_kuu, s_p, u, ws)))
    return s_kuu, s_p, u


# ---------------------------------------------------------------------------
# the two sweeps together
# ---------------------------------------------------------------------------


def _assemble(k1_out, k2_out):
    l_kuu, l_p, iv, c0 = k1_out
    s_kuu, s_p, u = k2_out
    return l_kuu, l_p, s_kuu, s_p, c0, u, iv[0]


def factor_takahashi_solve(kuu_band, p_band, b):
    """Run sweeps K1 and K2: returns (l_kuu, l_p, s_kuu, s_p, c0, u, iv_kuu),
    where c0 = L_P⁻¹ b, u = P⁻¹ b and iv_kuu = 1/diag(L_Kuu), all float64.

    The kernels on CUDA tensors, the plain versions on CPU tensors."""
    k1 = chol_pair_solve(kuu_band, p_band, b)
    return _assemble(k1, tak_pair_solve(*k1))


def factor_takahashi_solve_plain(kuu_band, p_band, b):
    """The plain version of ``factor_takahashi_solve``, on any device."""
    k1 = chol_pair_solve_plain(kuu_band, p_band, b)
    return _assemble(k1, tak_pair_solve_plain(*k1))


# ---------------------------------------------------------------------------
# K7: Takahashi adjoint from K1's reciprocal pivots
# ---------------------------------------------------------------------------


def tak_bwd_vec_plain(l_band, s_band, cot, iv):
    """Plain version of K7: L̄ from (L, S, S̄, 1/diag L)."""
    _count_plain(l_band)
    return ops.takahashi_bwd_plain(l_band, s_band, cot, iv)


def tak_bwd_vec(l_band, s_band, cot, iv):
    """K7 on CUDA tensors, its plain version on CPU tensors.

    L̄ from L, S = its Takahashi band, S̄ and iv = 1/diag(L) (K1's
    reciprocal pivots): the Takahashi adjoint with no divide.  It shares the
    CUDA kernel ``tak_bwd<K>`` with K12, which divides instead."""
    k, m = _check_shapes((l_band, s_band, cot), (iv,))
    if l_band.device.type == "cpu":
        return tak_bwd_vec_plain(l_band, s_band, cot, iv)
    _check_cuda(k, (l_band, s_band, cot, iv))
    l_bar = torch.empty_like(l_band)
    ws = l_band.new_empty(carry_workspace(k, m, 1))
    _launch("tak_bwd_vec", "asvgp_tak_bwd", l_band.device, k, m, 1, l_band.data_ptr(),
            s_band.data_ptr(), cot.data_ptr(), iv.data_ptr(), l_bar.data_ptr(), ws.data_ptr())
    return l_bar


def tak_bwd_pair_plain(l_band, s_band, cot, iv):
    """Plain version of K23: K7's recursion on each of the two matrices."""
    _count_plain(l_band)
    return torch.stack([ops.takahashi_bwd_plain(l, s, c, v)
                        for l, s, c, v in zip(l_band, s_band, cot, iv)])


def tak_bwd_pair(l_band, s_band, cot, iv):
    """K23 on CUDA tensors, its plain version on CPU tensors.

    K7 for two matrices in one launch (``takahashi_bwd_pair_ds``): L̄ from
    (2, k+1, m) stacks of L, S and S̄ and the (2, m) reciprocal pivots of
    the two factors, one chain per matrix of ``tak_bwd<K>``."""
    if l_band.ndim != 3 or l_band.shape[0] != 2:
        raise ValueError(f"L must be a (2, k+1, m) pair of bands, got {tuple(l_band.shape)}")
    k, m = _check_shapes((l_band[0], s_band[0], cot[0]), (iv[0],))
    if not (l_band.shape == s_band.shape == cot.shape) or tuple(iv.shape) != (2, m):
        raise ValueError("L, S and S̄ must be (2, k+1, m) and iv (2, m)")
    if l_band.device.type == "cpu":
        return tak_bwd_pair_plain(l_band, s_band, cot, iv)
    _check_cuda(k, (l_band, s_band, cot, iv))
    l_bar = torch.empty_like(l_band)
    ws = l_band.new_empty(carry_workspace(k, m, 2))
    _launch("tak_bwd_pair", "asvgp_tak_bwd", l_band.device, k, m, 2, l_band.data_ptr(),
            s_band.data_ptr(), cot.data_ptr(), iv.data_ptr(), l_bar.data_ptr(), ws.data_ptr())
    return l_bar


# ---------------------------------------------------------------------------
# K8: Cholesky adjoint, batched (the collapsed core calls it on one matrix)
# ---------------------------------------------------------------------------


def chol_bwd_pair_plain(l_band, l_bar):
    """Plain version of K8: Ā from (L, L̄), per matrix of the batch."""
    _count_plain(l_band)
    if l_band.ndim == 2:
        return ops.cholesky_band_bwd_plain(l_band, l_bar)
    return torch.stack([ops.cholesky_band_bwd_plain(l, c) for l, c in zip(l_band, l_bar)])


def chol_bwd_pair(l_band, l_bar):
    """K8 on CUDA tensors, its plain version on CPU tensors.

    Ā from L = chol(A) and L̄, for one (k+1, m) band or a batch (n, k+1, m)
    of them, one chain per matrix.  The JAX package runs two matrices in
    one pass and feeds the collapsed core's one with a dead second lane;
    here the batch is one.  It shares the CUDA kernel ``chol_bwd<K>`` with
    K10."""
    if l_band.ndim not in (2, 3) or l_band.shape != l_bar.shape:
        raise ValueError(f"L and L̄ must be one (k+1, m) or (n, k+1, m) shape, got "
                         f"{tuple(l_band.shape)} and {tuple(l_bar.shape)}")
    k, m = _check_shapes((l_band, l_bar) if l_band.ndim == 2 else (l_band[0], l_bar[0]), ())
    if l_band.device.type == "cpu":
        return chol_bwd_pair_plain(l_band, l_bar)
    _check_cuda(k, (l_band, l_bar))
    a_bar = torch.empty_like(l_band)
    nb = 1 if l_band.ndim == 2 else l_band.shape[0]
    ws = l_band.new_empty(carry_workspace(k, m, nb))
    _launch("chol_bwd_pair", "asvgp_chol_bwd", l_band.device, k, m, nb, l_band.data_ptr(),
            l_bar.data_ptr(), a_bar.data_ptr(), ws.data_ptr())
    return a_bar


# ---------------------------------------------------------------------------
# the collapsed core: K1 + K2 forward, K7 + K8 backward
# ---------------------------------------------------------------------------


class CollapsedCore(torch.autograd.Function):
    """(log|Kuu|, log|P|, bᵀP⁻¹b, tr(Kuu⁻¹B)), differentiable in Kuu, P, b
    and B (banded Kuf·Kufᵀ): ``collapsed_core_ds`` with its ``_cc_fwd`` and
    ``_cc_bwd``, term by term.

    The forward runs K1 + K2 and keeps (L_Kuu, S_Kuu, S_P, u = P⁻¹b, B,
    1/diag L_Kuu).  The backward, with w = 2 − δ_{j0}:
      P̄ = g_ldp·(w∘S_P) − g_quad·(w∘band(uuᵀ)),  b̄ = 2·g_quad·u,
      B̄ = g_tr·(w∘S_Kuu),
      K̄uu = K8(L_Kuu, K7(L_Kuu, S_Kuu, g_tr·(w∘B), iv)) + g_ldk·(w∘S_Kuu):
    the trace term through the Takahashi adjoint (K7) and the Cholesky
    adjoint (K8), the log-det in closed form.  A missing output cotangent
    counts as zero.  On CPU tensors the plain versions of all four kernels
    run, so the CPU exercises the same wiring.
    """

    @staticmethod
    def forward(ctx, kuu_band, p_band, b, big_band):
        l_kuu, l_p, s_kuu, s_p, c0, u, iv_kuu = factor_takahashi_solve(kuu_band, p_band, b)
        ctx.save_for_backward(l_kuu, s_kuu, s_p, u, big_band, iv_kuu)
        return (
            ops.log_det_from_cholesky(l_kuu),
            ops.log_det_from_cholesky(l_p),
            torch.sum(torch.square(c0)),
            ops.band_frobenius(s_kuu, big_band),
        )

    @staticmethod
    def backward(ctx, g_ldk, g_ldp, g_quad, g_tr):
        from asvgp_tpu_torch.banded.tan import band_weights, outer_band

        l_kuu, s_kuu, s_p, u, big_band, iv_kuu = ctx.saved_tensors
        g_ldk, g_ldp, g_quad, g_tr = (
            torch.zeros_like(u[0]) if g is None else g for g in (g_ldk, g_ldp, g_quad, g_tr)
        )
        k, m = l_kuu.shape[0] - 1, l_kuu.shape[1]
        w = band_weights(k, m, l_kuu)
        need_kuu, need_p, need_b, need_big = ctx.needs_input_grad
        p_bar = g_ldp * (w * s_p) - g_quad * (w * outer_band(u, k)) if need_p else None
        b_bar = (2.0 * g_quad) * u if need_b else None
        big_bar = g_tr * (w * s_kuu) if need_big else None
        kuu_bar = None
        if need_kuu:
            l_bar = tak_bwd_vec(l_kuu, s_kuu, g_tr * (w * big_band), iv_kuu)
            kuu_bar = chol_bwd_pair(l_kuu, l_bar) + g_ldk * (w * s_kuu)
        return kuu_bar, p_bar, b_bar, big_bar


def collapsed_core(kuu_band, p_band, b, big_band):
    """(log|Kuu|, log|P|, bᵀP⁻¹b, tr(Kuu⁻¹ B)), differentiable in all four
    inputs (``CollapsedCore``).

    ``big_band`` is B = banded Kuf·Kufᵀ (same lower bandwidth as Kuu)."""
    return CollapsedCore.apply(kuu_band, p_band, b, big_band)
