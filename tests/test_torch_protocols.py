"""The torch legs of the experiment protocols on the CPU, against the JAX
package.

- Snelson (``experiments/snelson/example_torch.py``), in-process at
  m = 40: the exact GP's and ASVGP's fitted objectives equal the JAX
  package's fits of the same models (1e-8, the same iteration counts), and
  the ELBO lower-bounds log Z.
- Large regression (``experiments/large_regression/synthetic_1m_torch.py``):
  ``run_split`` at n = 2500, m = 32 with every baseline, its row's keys
  those of the JAX script's rows, its GPR1D's loss at init the JAX
  GPR1D's on the same split (1e-10); ``load_data`` on files written
  here: arrays named x and y required in an ``.npz``, a constant x or y
  refused.
"""

import argparse
import importlib.util
import pathlib

import jax
import numpy as np
import pytest
import torch

from asvgp_tpu.basis import BSplineBasis as JBSpline
from asvgp_tpu.models import GPR1D as JGPR1D
from asvgp_tpu.models import ExactGPR as JExactGPR
from asvgp_tpu.models import Matern32 as JMatern32
from asvgp_tpu.models import Matern52 as JMatern52
from asvgp_tpu.train import fit_lbfgs as jfit_lbfgs

ROOT = pathlib.Path(__file__).resolve().parents[1]


def load(rel_path, name):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel_path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


snelson = load("experiments/snelson/example_torch.py", "example_torch")
large = load("experiments/large_regression/synthetic_1m_torch.py", "synthetic_1m_torch")

# the keys of a row of experiments/large_regression/synthetic_1m.py with
# every baseline
ROW_KEYS = {
    "elbo", "nlpd", "mse", "t_precompute", "t_opt", "t_pred", "iters", "grad_norm",
    "converged", "restarts", "ls_evals", "evals_per_iter", "stopping_rule", "noise_variance",
    "t_adam", "nlpd_adam", "t_svgp", "t_svgp_pred", "nlpd_svgp", "mse_svgp", "noise_svgp",
    "svgp_elbo_tail_drop", "t_vff_precompute", "t_vff_opt", "t_vff_pred", "elbo_vff",
    "nlpd_vff", "mse_vff",
}


def rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def test_snelson_leg_matches_jax():
    gp, (_, loss, it), model, (_, lossf, itf), _ = snelson.run(m=40, device="cpu")
    X, y = snelson.load()
    jgp = JExactGPR((X, y), JMatern32())
    _, jloss, jit_ = jfit_lbfgs(jax.jit(jgp.training_loss), jgp.init_params())
    jm = JGPR1D((X, y), JMatern32(), JBSpline(-3.5, 10.5, 40, 3))
    _, jlossf, jitf = jfit_lbfgs(jax.jit(jm.training_loss), jm.init_params())
    assert rel(loss, jloss) <= 1e-8 and int(it) == int(jit_)
    assert rel(lossf, jlossf) <= 1e-8 and int(itf) == int(jitf)
    # the ELBO lower-bounds log Z
    assert -float(lossf) <= -float(loss)
    assert rel(model.training_loss(), lossf) <= 1e-12
    assert rel(gp.training_loss(), loss) <= 1e-12


def protocol_args(**over):
    args = large.parser().parse_args([])
    for key, value in dict(n=2500, m=32, iters=5, restarts=0, adam_baseline=True,
                           adam_steps=5, batch=256, svgp_baseline=True, svgp_steps=10,
                           vff_baseline=True, vff_frequencies=8, device="cpu").items():
        setattr(args, key, value)
    for key, value in over.items():
        setattr(args, key, value)
    return args


def test_run_split_rows_and_loss_at_init():
    args = protocol_args()
    record, stages = {}, []

    class Stage:
        def __init__(self, name):
            stages.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    idx = {"adam": np.random.RandomState(2).randint(0, 2375, size=(5, 256))}
    row = large.run_split(args, 0, indices=idx, stage=Stage, record=record)
    assert set(row) == ROW_KEYS, set(row) ^ ROW_KEYS
    assert stages == ["precompute", "fit", "predict", "adam", "svgp", "svgp_predict",
                      "vff_precompute", "vff_fit", "vff_predict"]
    assert all(np.isfinite(row[k]) for k in ROW_KEYS if isinstance(row[k], float))
    assert row["iters"] == 5 and np.asarray(record["adam_losses"]).shape == (5,)
    # the GPR1D's loss at init, against the JAX GPR1D on the same split
    x, y = large.make_data(2500, 0)
    xtr, ytr = x[125:], y[125:]
    jm = JGPR1D((xtr, ytr), JMatern52(lengthscales=0.05), JBSpline(0.0, 1.0, 32, 3))
    p0 = jm.init_params()
    want = float(jm.training_loss(p0))
    model = record["model"]
    got = model.training_loss(jax.tree.map(lambda v: torch.as_tensor(np.asarray(v)), p0))
    assert rel(got, want) <= 1e-10
    # the same split without baselines gives the same fit
    plain = large.run_split(protocol_args(adam_baseline=False, svgp_baseline=False,
                                          vff_baseline=False), 0)
    assert plain["elbo"] == row["elbo"] and "t_vff_opt" not in plain
    assert set(large.summarize([row, row])) >= {"elbo", "nlpd", "mse", "elbo_vff"}


def test_load_data_requires_named_arrays_and_variation(tmp_path):
    rng = np.random.RandomState(3)
    x, y = rng.uniform(5.0, 9.0, 50), rng.randn(50)
    good = tmp_path / "good.npz"
    np.savez(good, y=y, x=x)
    gx, gy = large.load_data(str(good))
    assert gx.min() > 0.0 and gx.max() < 1.0 and np.argmin(gx) == np.argmin(x)
    assert abs(gy.mean()) < 1e-12 and abs(gy.std() - 1.0) < 1e-12
    csv = tmp_path / "d.csv"
    np.savetxt(csv, np.stack([x, y], 1), delimiter=",")
    assert np.allclose(large.load_data(str(csv))[0], gx)
    unnamed = tmp_path / "unnamed.npz"
    np.savez(unnamed, target=y, time=x)
    with pytest.raises(ValueError, match="'x' and 'y'"):
        large.load_data(str(unnamed))
    flat_x = tmp_path / "flat_x.npz"
    np.savez(flat_x, x=np.full(50, 2.0), y=y)
    with pytest.raises(ValueError, match="x is constant"):
        large.load_data(str(flat_x))
    flat_y = tmp_path / "flat_y.npy"
    np.save(flat_y, np.stack([x, np.full(50, 1.5)], 1))
    with pytest.raises(ValueError, match="y is constant"):
        large.load_data(str(flat_y))


def test_legs_default_to_the_card():
    args = protocol_args(device=None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            large.run_split(args, 0)
        with pytest.raises(RuntimeError, match="CUDA"):
            snelson.run(m=40)
    assert isinstance(large.parser().parse_args([]), argparse.Namespace)
