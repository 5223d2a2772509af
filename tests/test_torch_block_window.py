"""K24, the window quadratic form of GPRKron's predictive variance in the
block band of P⁻¹ (banded/block_window.py; this file imports no JAX).

On the CPU the plain version against a direct dense evaluation kusᵀ S kus,
S the dense expansion of a random SPD block band, for D = 2 spline orders
(1, 1), (2, 3), (4, 4), (6, 6) and two D = 3 shapes, (2, 2, 1) with T = 6
and (2, 3, 3) with T = 16 (the kernel's run-time T, above 7), with points
in the first and last cells of every dimension; one plain call a predicted
chunk; the wrapper's shape and device checks; a prediction on the CPU is
differentiable in its inputs.

The ``cuda``-marked tests run the kernel and skip without a card: against
the plain version (1e-13 of the largest value), bit-equal launch to launch,
one launch a chunk and no plain call on the card, the wrapper's refusals,
GPRKron ``predict_f`` in padded chunks against the CPU model at D = 2 and
at D = 3 (T = 9 and 16), and a prediction on the card refusing inputs
that require grad (K24 has no backward).
"""

import numpy as np
import pytest
import torch

from asvgp_tpu_torch.banded import block, core
from asvgp_tpu_torch.banded.block_window import block_window_quad, block_window_quad_plain
from asvgp_tpu_torch.basis import BSplineBasis
from asvgp_tpu_torch.features.spline_features import make_kuf
from asvgp_tpu_torch.models import GPRKron, Matern32

# spline orders and features a dimension
CASES = {
    "o11": ((1, 1), (4, 5)),
    "o23": ((2, 3), (6, 8)),
    "o44": ((4, 4), (10, 10)),
    "o66": ((6, 6), (14, 14)),
    "o221": ((2, 2, 1), (6, 6, 4)),
    "o233": ((2, 3, 3), (6, 8, 8)),
}


def _bases(case):
    orders, ms = CASES[case]
    return [BSplineBasis(0.0, 1.0, m, o) for o, m in zip(orders, ms)]


def _points(D, n, seed):
    """n points in the unit cube, the first four in the first and last cells
    of every dimension."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(0.0, 1.0, (n, D))
    x[0], x[1], x[2] = 1e-9, 1.0 - 1e-9, 0.5
    x[3] = [1e-9] + [1.0 - 1e-9] * (D - 1)
    return torch.from_numpy(x)


def _windows(bases, x):
    """(v1, c1, v_t, r_t) as ``PosteriorKron._predict_chunk`` forms them."""
    v1, c1 = make_kuf(bases[0], x[:, 0])
    n = v1.shape[0]
    v_t = r_t = None
    for d in range(1, len(bases)):
        vd, cd = make_kuf(bases[d], x[:, d])
        rd = cd[:, None] + torch.arange(bases[d].order + 1, device=cd.device)[None, :]
        if v_t is None:
            v_t, r_t = vd, rd
        else:
            r_t = (r_t[:, :, None] * bases[d].m + rd[:, None, :]).reshape(n, -1)
            v_t = (v_t[:, :, None] * vd[:, None, :]).reshape(n, -1)
    return v1, c1, v_t, r_t


def _spd_band(bases, seed):
    """The block band (k₁+1, m₁, M₂, M₂) of a random SPD matrix."""
    m1, M2 = bases[0].m, int(np.prod([b.m for b in bases[1:]]))
    rng = np.random.RandomState(seed)
    a = torch.from_numpy(rng.randn(m1 * M2, m1 * M2))
    s = a @ a.T + m1 * M2 * torch.eye(m1 * M2, dtype=torch.float64)
    return block.dense_to_block_band(s, bases[0].order, M2).contiguous()


def _dense_quad(sp, bases, x):
    """kus_iᵀ S kus_i with kus_i the dense tensor-product feature vector."""
    dense = block.block_band_to_dense(sp)
    kus = None
    for d, b in enumerate(bases):
        kd = b.evaluate_basis_dense(x[:, d]).T
        kus = kd if kus is None else (kus[:, :, None] * kd[:, None, :]).reshape(x.shape[0], -1)
    return torch.einsum("ni,ij,nj->n", kus, dense, kus)


def rel(got, want):
    return float((got.cpu() - want.cpu()).abs().max() / want.cpu().abs().max())


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_dense_quadratic_form(case):
    bases = _bases(case)
    x = _points(len(bases), 60, 1)
    sp = _spd_band(bases, 2)
    got = block_window_quad_plain(sp, *_windows(bases, x))
    assert rel(got, _dense_quad(sp, bases, x)) <= 1e-13


# GPRKron's cases: spline orders and features a dimension (T = 5, 9, 16)
KRON_CASES = {"o34": ((3, 4), (9, 10)), "o222": ((2, 2, 2), (7, 6, 6)),
              "o333": ((3, 3, 3), (10, 9, 8))}


def _kron_model(device, case="o34"):
    orders, ms = KRON_CASES[case]
    D = len(orders)
    rng = np.random.RandomState(0)
    X = rng.uniform(0.02, 0.98, (300, D))
    y = (np.sin(6 * X[:, 0] + 2 * X[:, 1:].sum(1)) + 0.1 * rng.randn(300)).reshape(-1, 1)
    kernels = [Matern32(lengthscales=ell) for ell in (0.3, 0.2, 0.25)[:D]]
    return GPRKron((X, y), kernels, [BSplineBasis(0.0, 1.0, m, o) for o, m in zip(orders, ms)],
                   noise_variance=0.1, device=device)


def test_plain_counts_one_call_a_chunk():
    post = _kron_model("cpu").posterior()
    x = _points(2, 100, 3)
    core.reset_counters()
    post.predict_f(x, batch=30)  # 4 chunks, the last one padded
    assert core.PLAIN_CALLS == {"cpu": 4, "cuda": 0}
    assert not any(core.LAUNCHES.values())


def test_wrapper_checks_shapes_and_devices():
    bases = _bases("o23")
    x = _points(2, 10, 4)
    sp = _spd_band(bases, 5)
    v1, c1, v_t, r_t = _windows(bases, x)
    with pytest.raises(ValueError, match="sp must be"):
        block_window_quad(sp[0], v1, c1, v_t, r_t)
    with pytest.raises(ValueError, match="v1 must be"):
        block_window_quad(sp, v1[:, 1:], c1, v_t, r_t)
    with pytest.raises(ValueError, match="r_t must be"):
        block_window_quad(sp, v1, c1, v_t, r_t[:5])
    with pytest.raises(ValueError, match="one device"):
        block_window_quad(sp.to("meta"), v1, c1, v_t, r_t)


def test_cpu_prediction_is_differentiable():
    post = _kron_model("cpu").posterior()
    x = _points(2, 20, 11).requires_grad_(True)
    _, var = post.predict_f(x)
    (grad,) = torch.autograd.grad(var.sum(), x)
    assert grad.shape == x.shape and bool(torch.isfinite(grad).all())
    assert float(grad.abs().max()) > 0.0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K24 is a CUDA kernel with no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_cuda_kernel_matches_plain(cuda_device, case):
    bases = _bases(case)
    x = _points(len(bases), 2000, 6)
    sp = _spd_band(bases, 7)
    args = _windows(bases, x)
    want = block_window_quad_plain(sp, *args)
    dev_args = [t.to(cuda_device) for t in (sp, *args)]
    core.reset_counters()
    got = block_window_quad(*dev_args)
    again = block_window_quad(*dev_args)
    torch.cuda.synchronize()
    assert got.is_cuda and got.dtype == torch.float64 and got.shape == want.shape
    assert rel(got, want) <= 1e-13
    assert torch.equal(got, again)
    assert core.LAUNCHES["block_window_quad"] == 2 and core.PLAIN_CALLS["cuda"] == 0


@pytest.mark.cuda
def test_cuda_wrapper_refuses(cuda_device):
    bases = _bases("o44")
    x = _points(2, 50, 8)
    sp = _spd_band(bases, 9).to(cuda_device)
    v1, c1, v_t, r_t = (t.to(cuda_device) for t in _windows(bases, x))
    with pytest.raises(TypeError, match="float64"):
        block_window_quad(sp.float(), v1, c1, v_t, r_t)
    with pytest.raises(TypeError, match="float64"):
        block_window_quad(sp, v1, c1, v_t.float(), r_t)
    with pytest.raises(TypeError, match="int64"):
        block_window_quad(sp, v1, c1.int(), v_t, r_t)
    strided = sp.transpose(2, 3)
    assert not strided.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        block_window_quad(strided, v1, c1, v_t, r_t)
    with pytest.raises(ValueError, match="one device"):
        block_window_quad(sp, v1.cpu(), c1, v_t, r_t)
    assert core.PLAIN_CALLS["cuda"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", KRON_CASES)
def test_cuda_kron_predict_matches_cpu(cuda_device, case):
    cpu, gpu = _kron_model("cpu", case).posterior(), _kron_model(cuda_device, case).posterior()
    x = _points(len(KRON_CASES[case][0]), 100, 10)
    core.reset_counters()
    gm, gv = gpu.predict_f(x, batch=30)  # 4 chunks, the last one padded
    torch.cuda.synchronize()
    assert core.LAUNCHES["block_window_quad"] == 4 and core.PLAIN_CALLS["cuda"] == 0
    cm, cv = cpu.predict_f(x)
    assert rel(gm, cm) <= 1e-10 and rel(gv, cv) <= 1e-10


@pytest.mark.cuda
def test_cuda_prediction_refuses_grad(cuda_device):
    post = _kron_model(cuda_device).posterior()
    x = _points(2, 20, 11).to(cuda_device).requires_grad_(True)
    with pytest.raises(NotImplementedError, match="no backward"):
        post.predict_f(x)
    with torch.no_grad():
        _, var = post.predict_f(x)
    assert bool(torch.isfinite(var).all())
