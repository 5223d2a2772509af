"""The banded core of the collapsed ELBO and the posterior: two sweeps.

PyTorch counterpart of ``asvgp_tpu/banded/pallas_ds_core.py`` (its value
path).  ``factor_takahashi_solve`` runs

  K1 ``chol_pair_solve`` (forward sweep): banded Cholesky of Kuu and of P,
     the lower solve L_P c₀ = b, and the reciprocal pivots of both;
  K2 ``tak_pair_solve`` (reverse sweep): Takahashi bands of Kuu⁻¹ and P⁻¹
     and the upper solve u = P⁻¹ b, divide-free from K1's pivots;

as hand-written CUDA kernels (csrc/banded_core.cu) on CUDA tensors, and as
their plain-PyTorch versions (``*_plain``, composed from banded/ops.py) on
CPU tensors.  For a CUDA tensor a wrapper launches its kernel or raises;
it never falls back.  Everything the ELBO value and the posterior need is
elementwise in the outputs: log|Kuu| and log|P| from the factor diagonals,
bᵀP⁻¹b = ‖c₀‖², tr(Kuu⁻¹B) = band-Frobenius(S_Kuu, B).

``LAUNCHES`` counts the kernel launches of each wrapper and
``PLAIN_CALLS`` the calls of the plain versions by device type, so that a
run can show which path it took.
"""

from __future__ import annotations

import torch

from asvgp_tpu_torch.banded import _build, ops

# one count per kernel: K1, K2 here; K3, K4 in banded/tan.py; K5, K6 in
# banded/twist.py
LAUNCHES = {
    "chol_pair_solve": 0,
    "tak_pair_solve": 0,
    "chol_pair_solve_tan": 0,
    "tak_pair_solve_tan": 0,
    "chol_quad_solve_tan": 0,
    "tak_quad_solve_tan": 0,
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


def _check_cuda(k: int, tensors) -> None:
    """Raise on what the CUDA kernels do not take."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"banded sweeps run on 'cpu' or 'cuda' tensors, got {dev}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"the CUDA sweeps take bandwidth k in 1..{MAX_K}, got k={k}")
    for t in tensors:
        if t.dtype != torch.float64:
            raise TypeError(f"the CUDA sweeps take float64 tensors, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the CUDA sweeps take contiguous tensors")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "the banded sweeps on the GPU are not differentiable themselves: GPR1D "
            "training differentiates through banded.collapsed_core_matern (tangent "
            "sweeps with an elementwise backward); the gradient of the generic "
            "collapsed_core needs the adjoint kernels K7/K8, which are not ported "
            "yet; evaluate it under torch.no_grad()"
        )


# ---------------------------------------------------------------------------
# K1: forward sweep
# ---------------------------------------------------------------------------


def chol_pair_solve_plain(kuu_band, p_band, b):
    """Plain version of K1: (l_kuu, l_p, iv (2, m), c0)."""
    _count_plain(kuu_band)
    l_kuu, l_p = ops.cholesky_band_pair(kuu_band, p_band)
    iv = torch.stack([1.0 / l_kuu[0], 1.0 / l_p[0]], dim=0)
    c0 = ops.solve_lower_band(l_p, b)
    return l_kuu, l_p, iv, c0


def chol_pair_solve(kuu_band, p_band, b):
    """K1 on CUDA tensors, its plain version on CPU tensors.

    Returns (l_kuu, l_p, iv, c0): the Cholesky bands of Kuu and P, their
    reciprocal pivots iv = [1/diag(L_Kuu); 1/diag(L_P)] and c0 = L_P⁻¹ b."""
    k, m = _check_shapes((kuu_band, p_band), (b,))
    if kuu_band.device.type == "cpu":
        return chol_pair_solve_plain(kuu_band, p_band, b)
    _check_cuda(k, (kuu_band, p_band, b))
    lib = _build.load()
    l_kuu = torch.empty_like(kuu_band)
    l_p = torch.empty_like(p_band)
    iv = kuu_band.new_empty((2, m))
    c0 = kuu_band.new_empty((m,))
    with torch.cuda.device(kuu_band.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.asvgp_chol_pair_solve(
            k, m, kuu_band.data_ptr(), p_band.data_ptr(), b.data_ptr(),
            l_kuu.data_ptr(), l_p.data_ptr(), iv.data_ptr(), c0.data_ptr(), stream,
        )
    _build.check(lib, rc, "chol_pair_solve")
    LAUNCHES["chol_pair_solve"] += 1
    return l_kuu, l_p, iv, c0


# ---------------------------------------------------------------------------
# K2: reverse sweep
# ---------------------------------------------------------------------------


def tak_pair_solve_plain(l_kuu, l_p, iv, c0):
    """Plain version of K2: (s_kuu, s_p, u).  ``iv`` is implied by the
    factors' diagonals and is not read."""
    _count_plain(l_kuu)
    s_kuu = ops.takahashi_inverse_band(l_kuu)
    s_p = ops.takahashi_inverse_band(l_p)
    u = ops.solve_upper_band_transpose(l_p, c0)
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
    lib = _build.load()
    s_kuu = torch.empty_like(l_kuu)
    s_p = torch.empty_like(l_p)
    u = c0.new_empty((m,))
    with torch.cuda.device(l_kuu.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.asvgp_tak_pair_solve(
            k, m, l_kuu.data_ptr(), l_p.data_ptr(), iv.data_ptr(), c0.data_ptr(),
            s_kuu.data_ptr(), s_p.data_ptr(), u.data_ptr(), stream,
        )
    _build.check(lib, rc, "tak_pair_solve")
    LAUNCHES["tak_pair_solve"] += 1
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


def collapsed_core(kuu_band, p_band, b, big_band):
    """(log|Kuu|, log|P|, bᵀP⁻¹b, tr(Kuu⁻¹ B)), value only.

    ``big_band`` is B = banded Kuf·Kufᵀ (same lower bandwidth as Kuu)."""
    l_kuu, l_p, s_kuu, _, c0, _, _ = factor_takahashi_solve(kuu_band, p_band, b)
    return (
        ops.log_det_from_cholesky(l_kuu),
        ops.log_det_from_cholesky(l_p),
        torch.sum(torch.square(c0)),
        ops.band_frobenius(s_kuu, big_band),
    )
