"""The trainers on a float32 model: ``fit_lbfgs`` of a float32 GPR1D and
``fit_adam_minibatch(..., dtype=torch.float32)``, against the JAX package's
float32 runs (x64 off, ``set_impl("scan")``) on the CPU.

A float32 fit is determined only as far as one float32 rounding of its
inputs leaves it: ``tools/f32_fit_anchors.py --spread`` moves the JAX
run's float32 statistics and initial parameters by one rounding
(each entry times 1 ± 2⁻²⁴) and records how far each quantity moves.  The
port is held to the JAX float32 run within max(10 × that spread, 1e-6)
relative, its iteration count and ``converged`` where the spread left them
fixed, and its final loss within 10 × the JAX float32 run's own distance
from the JAX float64 run (PERF.md §2).  The spreads below are this file's
cut, from

    python tools/f32_fit_anchors.py --n 20000 --m 500 --adam-batch 1024 \\
        --adam-steps 5 --snelson-iters 30 --spread 16 --runs snelson,adam

- Snelson (B3, m = 100, Matérn-3/2, the defaults), 30 iterations: loss
  spread 2.19e-3; parameters (raw ℓ, σ², noise) 0.123, 0.145, 1.11e-2; 30
  iterations and ``converged`` False in every repeat, evaluations 125-179
  (not held); the float64 fit's loss at 30 iterations 60.83561779750357;
- Adam at bench.py's data, n = 20000, m = 500, batch 1024, 5 steps on
  ``RandomState(2)`` indices: step-1 and step-5 losses 9.64e-7 and
  5.17e-7; final parameters 6.95e-8, 1.82e-7, 1.08e-7 (bars 1e-6, 1.82e-6,
  1.08e-6); the float64 step-5 loss 45359.28504274701.

The float32 controller stays float32: the pairs S and Y, ρ and x after
every evaluation, the value, the gradient norm and the returned
parameters.  tests/test_torch_cuda_trainers_dp.py runs both trainers on
the card with exact launch counts of the float32 route.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from asvgp_tpu_torch.basis import B3Spline
from asvgp_tpu_torch.models import GPR1D, Matern32
from asvgp_tpu_torch.models.gpr1d import default_params
from asvgp_tpu_torch.train import fit_adam_minibatch, fit_lbfgs
from asvgp_tpu_torch.train.fused_lbfgs import make_fused_run

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("f32_fit_anchors",
                                               ROOT / "tools" / "f32_fit_anchors.py")
anchors = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(anchors)

SNELSON_ITERS = 30
SNELSON_SPREAD = {"loss": 2.19e-3, "params": (0.123, 0.145, 1.11e-2)}
SNELSON_F64_LOSS = 60.83561779750357
ADAM = {"n": 20_000, "m": 500, "batch": 1024, "steps": 5}
ADAM_SPREAD = {"loss_1": 9.64e-7, "loss_last": 5.17e-7, "params": (6.95e-8, 1.82e-7, 1.08e-7)}
ADAM_F64_LOSS_LAST = 45359.28504274701


def bar(spread):
    return max(10.0 * spread, 1e-6)


def rel(a, b):
    return abs(a - b) / abs(b)


def raw_params(params):
    return [float(params[g][k]) for g, k in anchors.PARAM_PATHS]


@pytest.fixture(scope="module", autouse=True)
def scan_route():
    """The JAX runs on the scan recursions, as the anchors; restored after."""
    with anchors.ops.impl_scope("scan"):
        yield


def snelson_model():
    X, y = anchors.snelson_data()
    return GPR1D((X, y), Matern32(), B3Spline(-3.5, 10.5, 100), device="cpu",
                 dtype=torch.float32)


def test_f32_snelson_fit_matches_jax_within_spread():
    want = anchors.fit(anchors.snelson_model(True), True, max_iters=SNELSON_ITERS)
    model = snelson_model()
    p0 = model.init_params()
    assert all(v.dtype == np.float32 for d in p0.values() for v in d.values())
    info = {}
    params, loss, iters = fit_lbfgs(model.training_loss, p0, max_iters=SNELSON_ITERS, info=info)
    assert all(t.dtype == torch.float32 for d in params.values() for t in d.values())
    assert rel(loss, want["loss"]) <= bar(SNELSON_SPREAD["loss"])
    for got, w, s in zip(raw_params(params), want["params"], SNELSON_SPREAD["params"]):
        assert rel(got, w) <= bar(s)
    assert iters == want["iters"] == SNELSON_ITERS
    assert info["converged"] == want["converged"]
    # the sanity hold: as close to float64 as 10× the JAX float32 run is
    assert rel(loss, SNELSON_F64_LOSS) <= 10 * rel(want["loss"], SNELSON_F64_LOSS)
    # the fitted parameters load into the float32 model
    model.load_jax_params(params)
    assert torch.isfinite(model.training_loss()) and model.raw_variance.dtype == torch.float32


def test_f32_adam_matches_jax_within_spread():
    want = anchors.adam(ADAM["n"], ADAM["m"], ADAM["steps"], ADAM["batch"], True)
    x, y = anchors.bench_data(ADAM["n"], 0)
    idx = anchors.index_stream(anchors.ADAM_INDEX_SEED, ADAM["steps"], ADAM["batch"], ADAM["n"])
    params, losses = fit_adam_minibatch(
        B3Spline(0.0, 1.0, ADAM["m"]), 3, x, y, default_params(Matern32(1.0, 1e-3), 0.1),
        batch_size=ADAM["batch"], steps=ADAM["steps"], learning_rate=anchors.ADAM_LR,
        indices=idx, device="cpu", dtype=torch.float32)
    assert losses.dtype == torch.float32
    assert all(t.dtype == torch.float32 for d in params.values() for t in d.values())
    assert rel(float(losses[0]), want["loss_1"]) <= bar(ADAM_SPREAD["loss_1"])
    assert rel(float(losses[-1]), want["loss_last"]) <= bar(ADAM_SPREAD["loss_last"])
    for got, w, s in zip(raw_params(params), want["params"], ADAM_SPREAD["params"]):
        assert rel(got, w) <= bar(s)
    assert rel(float(losses[-1]), ADAM_F64_LOSS_LAST) <= \
        10 * rel(want["loss_last"], ADAM_F64_LOSS_LAST)
    with pytest.raises(ValueError, match="dtype"):
        fit_adam_minibatch(B3Spline(0.0, 1.0, 20), 3, x, y, {}, device="cpu",
                           dtype=torch.float16)


def test_controller_stays_float32():
    """float32 in, float32 throughout, float32 out: the memory (S, Y, ρ),
    the point, the value and the slope after every evaluation (on the
    Rosenbrock function, which takes more than 8 iterations)."""
    seen = []

    def value_and_grad(q):
        assert q.dtype == np.float32
        a, b = q[0], q[1]
        value = (1 - a) ** 2 + 100 * (b - a * a) ** 2
        grad = np.array([-2 * (1 - a) - 400 * a * (b - a * a), 200 * (b - a * a)], np.float32)
        return value, grad

    def on_step(st):
        seen.append(st["k"])
        for key in ("x", "g_x", "d", "S", "Y", "rho", "safe_g"):
            assert st[key].dtype == np.float32, key
        for key in ("f_x", "slope0", "t", "guess", "low", "high", "safe_t"):
            assert np.asarray(st[key]).dtype == np.float32, key

    run = make_fused_run(value_and_grad, max_iters=8, tol=1e-8, memory_size=20,
                         on_step=on_step)
    x, iters, value, gnorm, evals = run(np.array([-1.2, 1.0], np.float32))
    assert x.dtype == np.float32 and np.asarray(value).dtype == np.float32
    assert np.asarray(gnorm).dtype == np.float32
    assert iters == 8 and evals == len(seen) and max(seen) == 8
    with pytest.raises(TypeError, match="float64 or float32"):
        run(np.zeros(2, np.int64))
