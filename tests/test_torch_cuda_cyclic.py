"""Block cyclic reduction on the card (``cuda``-marked: they skip without
one; this file imports no JAX).

- ``cr_logdet_solve`` and ``cr_inverse_band`` on CUDA tensors against the
  plain recursions on the CPU (log-det 1e-12, solve 1e-11, inverse band
  1e-10 relative, the bars of tests/test_torch_cyclic.py), launching none
  of the port's kernels, at the north star's m = 10⁴ among others.
- A ``GPR1D(..., backend="cr")`` value-and-grad step and posterior under
  ``torch.cuda.set_sync_debug_mode("error")``: no host synchronisation.
"""

import numpy as np
import pytest
import torch

from asvgp_tpu_torch.banded import core, cyclic, ops
from asvgp_tpu_torch.banded.layout import dense_to_lower_band, lower_band_to_dense
from asvgp_tpu_torch.basis import B3Spline
from asvgp_tpu_torch.models import GPR1D, Matern32


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: this checks cyclic reduction on the card")
    return torch.device("cuda", 0)


def spd_band(m, k, seed):
    rng = np.random.RandomState(seed)
    l0 = 0.3 * rng.randn(k + 1, m)
    l0[0] = 2.0 + rng.rand(m)
    for j in range(1, k + 1):
        l0[j, m - j:] = 0.0
    L = lower_band_to_dense(torch.from_numpy(l0))
    return dense_to_lower_band(L @ L.T, k)


def rel(got, want):
    return float((got.cpu() - want).abs().max() / want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("m,k", [(129, 3), (10_000, 3), (1000, 6)])
def test_cuda_cr_matches_plain(cuda_device, m, k):
    a = spd_band(m, k, m + k)
    b = torch.from_numpy(np.random.RandomState(m).randn(m))
    l = ops.cholesky_band_plain(a)
    pld = ops.log_det_from_cholesky(l)
    px = ops.solve_upper_band_transpose_plain(l, ops.solve_lower_band_plain(l, b))
    pinv = ops.takahashi_inverse_band_plain(l)
    ad, bd = a.to(cuda_device), b.to(cuda_device)
    core.reset_counters()
    ld, x = cyclic.cr_logdet_solve(ad, bd)
    inv = cyclic.cr_inverse_band(ad)
    assert x.is_cuda and inv.is_cuda
    assert rel(ld, pld) <= 1e-12 and rel(x, px) <= 1e-11 and rel(inv, pinv) <= 1e-10
    torch.cuda.synchronize()
    assert not any(core.LAUNCHES.values()) and core.PLAIN_CALLS["cuda"] == 0


@pytest.mark.cuda
def test_cuda_cr_step_does_not_sync(cuda_device):
    """A CR value-and-grad step and a CR posterior on the card wait for the
    device nowhere (after one warm-up step that puts the basis tables on
    the card)."""
    rng = np.random.RandomState(0)
    x = rng.uniform(0.01, 0.99, 500)
    y = np.sin(12.0 * x) + 0.3 * rng.randn(500)
    model = GPR1D((x, y), Matern32(lengthscales=0.2), B3Spline(0.0, 1.0, 32),
                  noise_variance=0.1, device=cuda_device, backend="cr")
    model.training_loss().backward()
    model.posterior()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        model.zero_grad(set_to_none=True)
        model.training_loss().backward()
        model.posterior()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.isfinite(model.raw_lengthscales.grad)
