"""Twisted (two-ended) tangent-fused collapsed-core sweeps.

PyTorch counterpart of ``asvgp_tpu/banded/pallas_ds_twist.py``.  The
tangent-fused sweeps of banded/tan.py walk all m columns in one serial
chain.  The twisted factorization of banded/twisted.py halves that depth:
one stream factors the matrix forward from column 0, the other factors the
index-reversed matrix (``flip_band``) from its column 0, and they meet at a
k×k dense middle block.  The streams are independent, so one kernel runs
both:

  K5 ``chol_quad_solve_tan``: on each stream, the Cholesky of Kuu and P,
     the lower solve of b, the Cholesky tangent of Kuu in the direction T
     (K3 on columns 0..h-1 of the bands and on columns 0..g-1 of the
     flipped bands, h = split_point(m, k), g = m - h - k), untapered: the
     last k columns of each stream keep their rows in the middle block;
  mid step (``mid_step``, PyTorch ops on the device): the k×k Schur
     complements of Kuu and P, their Cholesky, log-det and inverse Z, the
     tangent Ż_Kuu = −Z·Ṡ·Z, and the middle solve x2 = S22⁻¹ b2ᶜ;
  K6 ``tak_quad_solve_tan``: K4's recursion running outward from the
     middle on both streams, seeded with Z, Ż and x2, writing the bands of
     Kuu⁻¹, P⁻¹, their tangent and u = P⁻¹b in the (k+1, m) layout.

Same contract and elementwise backward as banded/tan.py (``MaternCore``).
On CPU tensors the kernels' plain versions run; on CUDA tensors the
kernels (csrc/banded_tan.cu) launch or the wrapper raises.  On the card
each stream is cut into chunks run in parallel (three launches a kernel,
scratch from ``core.twist_workspace``, one count per call): K5 joined by
the k×k Schur-complement update of each chunk's first rows (with its
tangent, or the lower solve's coupling), K6 by the affine maps of its
windows and a scan over them.
"""

from __future__ import annotations

import torch

from asvgp_tpu_torch.banded import _build, core, ops
from asvgp_tpu_torch.banded.tan import MaternCore
from asvgp_tpu_torch.banded.twisted import (
    _assemble_band,
    _lower_tail_dense,
    _middle_dense,
    _seed_from_mid,
    _solve_upper_seeded,
    flip_band,
    split_point,
)

LAUNCHES = core.LAUNCHES


def twist_applicable(k: int, m: int) -> bool:
    """Both streams need at least 2k columns (the JAX package's rule: k
    real columns plus headroom for its seed columns)."""
    if k < 1:
        return False
    h = split_point(m, k)
    g = m - h - k
    return h >= 2 * k and g >= 2 * k


def _split(kuu_band) -> tuple[int, int, int, int]:
    k = kuu_band.shape[0] - 1
    m = kuu_band.shape[1]
    if not twist_applicable(k, m):
        raise ValueError(f"the twisted sweeps need twist_applicable(k, m); got k={k}, m={m}")
    h = split_point(m, k)
    return k, m, h, m - h - k


def _pad(x: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-pad the last axis to n."""
    if x.shape[-1] == n:
        return x
    return torch.cat([x, x.new_zeros(x.shape[:-1] + (n - x.shape[-1],))], dim=-1)


# ---------------------------------------------------------------------------
# K5: both streams' forward sweeps with the Kuu tangent
# ---------------------------------------------------------------------------


def chol_quad_solve_tan_plain(kuu_band, tan_band, p_band, b):
    """Plain version of K5.

    Returns, over the h columns of the forward stream F and the g ≤ h
    columns of the reversed stream R (R's column h-1 is zero when g < h):
      l (4, k+1, h)      factors [F Kuu, F P, R Kuu, R P], untapered;
      ldot (2, k+1, h)   Kuu factor tangents [F, R];
      iv (4, h), ivdot (2, h)  reciprocal pivots and their Kuu tangents;
      y (2, h)           lower solves of the P factors [F: b, R: b reversed].
    """
    core._count_plain(kuu_band)
    k, m, h, g = _split(kuu_band)
    ls, ldots, ivs, ivdots, ys = [], [], [], [], []
    for n, (kb, tb, pb, bb) in (
        (h, (kuu_band, tan_band, p_band, b)),
        (g, (flip_band(kuu_band), flip_band(tan_band), flip_band(p_band), b.flip(0))),
    ):
        # the factor of the first n+k columns is untapered on its first n
        l_k, ld = (t[:, :n] for t in ops.cholesky_band_plain(kb[:, : n + k], tb[:, : n + k]))
        l_p = ops.cholesky_band_plain(pb[:, : n + k])[:, :n]
        iv_k, iv_p = 1.0 / l_k[0], 1.0 / l_p[0]
        ls += [_pad(l_k, h), _pad(l_p, h)]
        ldots.append(_pad(ld, h))
        ivs += [_pad(iv_k, h), _pad(iv_p, h)]
        ivdots.append(_pad(-iv_k * iv_k * ld[0], h))
        ys.append(_pad(ops.solve_lower_band_plain(l_p, bb[:n]), h))
    return (torch.stack(ls), torch.stack(ldots), torch.stack(ivs),
            torch.stack(ivdots), torch.stack(ys))


def chol_quad_solve_tan(kuu_band, tan_band, p_band, b):
    """K5 on CUDA tensors, its plain version on CPU tensors; returns
    (l, ldot, iv, ivdot, y) as ``chol_quad_solve_tan_plain`` documents."""
    k, m = core._check_shapes((kuu_band, tan_band, p_band), (b,))
    if kuu_band.device.type == "cpu":
        return chol_quad_solve_tan_plain(kuu_band, tan_band, p_band, b)
    core._check_cuda(k, (kuu_band, tan_band, p_band, b))
    _, _, h, _ = _split(kuu_band)
    lib = _build.load()
    l = kuu_band.new_empty((4, k + 1, h))
    ldot = kuu_band.new_empty((2, k + 1, h))
    iv = kuu_band.new_empty((4, h))
    ivdot = kuu_band.new_empty((2, h))
    y = kuu_band.new_empty((2, h))
    ws = kuu_band.new_empty(core.twist_workspace(k, m))
    with torch.cuda.device(kuu_band.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.asvgp_chol_quad_solve_tan(
            k, m, h, kuu_band.data_ptr(), tan_band.data_ptr(), p_band.data_ptr(),
            b.data_ptr(), l.data_ptr(), ldot.data_ptr(), iv.data_ptr(),
            ivdot.data_ptr(), y.data_ptr(), ws.data_ptr(), stream,
        )
    _build.check(lib, rc, "chol_quad_solve_tan")
    LAUNCHES["chol_quad_solve_tan"] += 1
    return l, ldot, iv, ivdot, y


# ---------------------------------------------------------------------------
# mid step: k×k Schur complements, inverses, the Kuu tangent, x2
# ---------------------------------------------------------------------------


def mid_step(kuu_band, tan_band, p_band, b, l, ldot, y):
    """The meeting point of the two streams (``_mid_logdet_inv`` of the JAX
    package, with its tangent written out).

    Returns (ld_mid (2,) = log|S22| of [Kuu, P], z (3, k, k) = [Z_Kuu, Z_P,
    Ż_Kuu], x2 (k,) = S22_P⁻¹ b2ᶜ, b2c (k,))."""
    k = kuu_band.shape[0] - 1
    m = kuu_band.shape[1]
    h = l.shape[2]
    g = m - h - k
    # L21 of [F Kuu, F P, R Kuu, R P] and the tangents of [F Kuu, R Kuu]
    l21 = _lower_tail_dense(torch.cat([l[:2, :, h - k: h], l[2:, :, g - k: g]]))
    tl21 = _lower_tail_dense(torch.stack([ldot[0, :, h - k: h], ldot[1, :, g - k: g]]))
    mids = _middle_dense(torch.stack([kuu_band, p_band, tan_band]), h)
    lf, lr = l21[:2], l21[2:]
    s = mids[:2] - lf @ lf.mT - (lr @ lr.mT).flip(-2, -1)
    dcf = tl21[0] @ lf[0].T
    dcr = tl21[1] @ lr[0].T
    sdot = mids[2] - (dcf + dcf.T) - (dcr + dcr.T).flip(0, 1)
    c, info = torch.linalg.cholesky_ex(s)
    # NaN for a middle block that is not positive definite, as the JAX
    # package's cholesky gives; no host sync
    c = torch.where((info == 0)[:, None, None], c, torch.full_like(c, float("nan")))
    ld_mid = 2.0 * torch.sum(torch.log(torch.diagonal(c, dim1=-2, dim2=-1)), dim=-1)
    eye = torch.eye(k, dtype=c.dtype, device=c.device).expand(2, k, k)
    z = torch.cholesky_solve(eye, c)
    zdot = -(z[0] @ sdot @ z[0])
    b2c = b[h: h + k] - lf[1] @ y[0, h - k: h] - (lr[1] @ y[1, g - k: g]).flip(0)
    x2 = torch.cholesky_solve(b2c[:, None], c[1])[:, 0]
    return ld_mid, torch.cat([z, zdot[None]]), x2, b2c


# ---------------------------------------------------------------------------
# K6: both streams' seeded reverse sweeps with the Takahashi tangent
# ---------------------------------------------------------------------------


def tak_quad_solve_tan_plain(l, ldot, iv, ivdot, y, z, x2, m: int):
    """Plain version of K6: (s_kuu, s_p, u, sdot_kuu), bands (k+1, m) and
    u (m,), assembled from both streams and the middle block.  The
    reciprocal pivots and their tangents are implied by the factors and not
    read."""
    core._count_plain(l)
    k = l.shape[1] - 1
    h = l.shape[2]
    g = m - h - k
    z_kuu, z_p, zdot = z
    tak = ops.takahashi_inverse_band_plain
    sF_k, tF = tak(l[0, :, :h], ldot[0, :, :h], seed=_seed_from_mid(z_kuu),
                   seed_dot=_seed_from_mid(zdot))
    sF_p = tak(l[1, :, :h], seed=_seed_from_mid(z_p))
    sR_k, tR = tak(l[2, :, :g], ldot[1, :, :g], seed=_seed_from_mid(z_kuu.flip(0, 1)),
                   seed_dot=_seed_from_mid(zdot.flip(0, 1)))
    sR_p = tak(l[3, :, :g], seed=_seed_from_mid(z_p.flip(0, 1)))
    x1 = _solve_upper_seeded(l[1, :, :h], y[0, :h], x2)
    x3 = _solve_upper_seeded(l[3, :, :g], y[1, :g], x2.flip(0))
    u = torch.cat([x1, x2, x3.flip(0)])
    return (_assemble_band(sF_k, sR_k, z_kuu, m), _assemble_band(sF_p, sR_p, z_p, m), u,
            _assemble_band(tF, tR, zdot, m))


def tak_quad_solve_tan(l, ldot, iv, ivdot, y, z, x2, m: int):
    """K6 on CUDA tensors, its plain version on CPU tensors.

    Takes K5's outputs, the mid step's z = [Z_Kuu, Z_P, Ż_Kuu] and x2, and
    the matrix size m; returns (s_kuu, s_p, u, sdot_kuu)."""
    if l.ndim != 3 or l.shape[0] != 4:
        raise ValueError(f"l must be (4, k+1, h), got {tuple(l.shape)}")
    k, h = l.shape[1] - 1, l.shape[2]
    expect = {"ldot": (ldot, (2, k + 1, h)), "iv": (iv, (4, h)), "ivdot": (ivdot, (2, h)),
              "y": (y, (2, h)), "z": (z, (3, k, k)), "x2": (x2, (k,))}
    for name, (t, shape) in expect.items():
        if tuple(t.shape) != shape or t.device != l.device:
            raise ValueError(f"{name} must be {shape} on {l.device}, got {tuple(t.shape)} on {t.device}")
    if h != split_point(m, k) or not twist_applicable(k, m):
        raise ValueError(f"l of {h} columns does not split m={m} at k={k}")
    if l.device.type == "cpu":
        return tak_quad_solve_tan_plain(l, ldot, iv, ivdot, y, z, x2, m)
    core._check_cuda(k, (l, ldot, iv, ivdot, y, z, x2))
    lib = _build.load()
    s_kuu = l.new_empty((k + 1, m))
    s_p = l.new_empty((k + 1, m))
    u = l.new_empty((m,))
    sdot = l.new_empty((k + 1, m))
    ws = l.new_empty(core.twist_workspace(k, m))
    with torch.cuda.device(l.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.asvgp_tak_quad_solve_tan(
            k, m, h, l.data_ptr(), ldot.data_ptr(), iv.data_ptr(), ivdot.data_ptr(),
            y.data_ptr(), z.data_ptr(), x2.data_ptr(),
            s_kuu.data_ptr(), s_p.data_ptr(), u.data_ptr(), sdot.data_ptr(),
            ws.data_ptr(), stream,
        )
    _build.check(lib, rc, "tak_quad_solve_tan")
    LAUNCHES["tak_quad_solve_tan"] += 1
    return s_kuu, s_p, u, sdot


# ---------------------------------------------------------------------------
# K5 + mid + K6
# ---------------------------------------------------------------------------


def _twist(k5, k6, kuu_band, tan_band, p_band, b):
    m = kuu_band.shape[1]
    l, ldot, iv, ivdot, y = k5(kuu_band, tan_band, p_band, b)
    k, h = l.shape[1] - 1, l.shape[2]
    g = m - h - k
    ld_mid, z, x2, b2c = mid_step(kuu_band, tan_band, p_band, b, l, ldot, y)
    quad = torch.sum(y[0, :h] ** 2) + torch.sum(y[1, :g] ** 2) + torch.dot(b2c, x2)
    # log-dets of [Kuu, P]: three-part sums, not factor-diagonal folds
    ld = (2.0 * torch.sum(torch.log(l[:2, 0, :h]), dim=-1)
          + 2.0 * torch.sum(torch.log(l[2:, 0, :g]), dim=-1) + ld_mid)
    s_kuu, s_p, u, sdot = k6(l, ldot, iv, ivdot, y, z.contiguous(), x2.contiguous(), m)
    return ld[0], ld[1], quad, s_kuu, s_p, u, sdot


def factor_takahashi_solve_tan_twist(kuu_band, tan_band, p_band, b):
    """K5 + mid step + K6: (ld_kuu, ld_p, quad, s_kuu, s_p, u, sdot_kuu),
    the same quantities as ``tan.factor_takahashi_solve_tan`` with the
    log-dets and bᵀP⁻¹b as scalars."""
    return _twist(chol_quad_solve_tan, tak_quad_solve_tan, kuu_band, tan_band, p_band, b)


def factor_takahashi_solve_tan_twist_plain(kuu_band, tan_band, p_band, b):
    """The plain version of ``factor_takahashi_solve_tan_twist``."""
    return _twist(chol_quad_solve_tan_plain, tak_quad_solve_tan_plain,
                  kuu_band, tan_band, p_band, b)


def collapsed_core_matern(kuu_fn, var, ell, p_band, b, big_band):
    """Twisted ``MaternCore``: same contract and backward as
    ``tan.collapsed_core_matern``."""
    return MaternCore.apply(kuu_fn, factor_takahashi_solve_tan_twist, var, ell,
                            p_band, b, big_band)
