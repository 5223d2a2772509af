"""The float32 trainers and data parallelism on the card (``cuda``-marked:
they skip without one; this file imports no JAX).

- ``fit_lbfgs`` of a float32 GPR1D and ``fit_adam_minibatch(...,
  dtype=torch.float32)``: every evaluation and every step launches the
  float32 route (K17 ×2, K19, K21; backward K18 ×2, K20, K22) and nothing
  else, no plain version on the card, and the parameters stay float32.
- A world of one NCCL rank on cuda:0 (``dryrun_multirank(1,
  backend="nccl")``): the dry run's two steps of each family finite, within
  1e-9 of the same dry run on one gloo rank on the CPU.
"""

import math
import pathlib

import numpy as np
import pytest
import torch

from asvgp_tpu_torch.banded import core
from asvgp_tpu_torch.basis import B3Spline
from asvgp_tpu_torch.models import GPR1D, Matern32
from asvgp_tpu_torch.models.gpr1d import default_params
from asvgp_tpu_torch.parallel import dryrun_multirank
from asvgp_tpu_torch.train import fit_adam_minibatch, fit_lbfgs

SNELSON = pathlib.Path(__file__).resolve().parents[1] / "data" / "snelson"
F32_STEP = {"chol_fwd_f32": 2, "tak_fwd_f32": 1, "solve_lower_f32": 1,
            "chol_bwd_f32": 2, "tak_bwd_f32": 1, "solve_upper_t_f32": 1}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA sweeps have no CPU mode")
    return torch.device("cuda", 0)


def launched():
    torch.cuda.synchronize()
    return {k: v for k, v in core.LAUNCHES.items() if v}


@pytest.mark.cuda
def test_cuda_f32_fit_lbfgs_launches_the_f32_route(cuda_device):
    X = np.loadtxt(SNELSON / "train_inputs").reshape(-1, 1)
    y = np.loadtxt(SNELSON / "train_outputs").reshape(-1, 1)
    model = GPR1D((X, y), Matern32(), B3Spline(-3.5, 10.5, 100), device=cuda_device,
                  dtype=torch.float32)
    core.reset_counters()
    info = {}
    params, loss, iters = fit_lbfgs(model.training_loss, model.params(), max_iters=5, info=info)
    assert launched() == {k: n * info["ls_evals"] for k, n in F32_STEP.items()}
    assert core.PLAIN_CALLS["cuda"] == 0 and iters == 5 and math.isfinite(loss)
    assert all(t.dtype == torch.float32 and t.is_cuda
               for d in params.values() for t in d.values())


@pytest.mark.cuda
def test_cuda_f32_adam_launches_the_f32_route(cuda_device):
    rng = np.random.RandomState(0)
    x = rng.uniform(0.005, 0.995, 20_000)
    y = np.sin(4400.0 * x) + 0.3 * rng.randn(20_000)
    core.reset_counters()
    params, losses = fit_adam_minibatch(B3Spline(0.0, 1.0, 500), 3, x, y,
                                        default_params(Matern32(1.0, 1e-3), 0.1),
                                        batch_size=1024, steps=3, device=cuda_device,
                                        dtype=torch.float32)
    assert launched() == {k: 3 * n for k, n in F32_STEP.items()}
    assert core.PLAIN_CALLS["cuda"] == 0
    assert losses.dtype == torch.float32 and bool(torch.isfinite(losses).all())


@pytest.mark.cuda
def test_cuda_nccl_world_of_one_dryrun(cuda_device):
    card = dryrun_multirank(1, backend="nccl", timeout=600)
    cpu = dryrun_multirank(1, backend="gloo", timeout=600)
    assert card["ok"] and card["jax_imported"] == [False]
    for name, losses in card["losses"].items():
        assert all(abs(a - b) <= 1e-9 * abs(b) for a, b in zip(losses, cpu["losses"][name]))
