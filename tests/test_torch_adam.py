"""Minibatch Adam on the stochastic collapsed bound (train/adam.py) against
the JAX package's ``fit_adam_minibatch``.

Both run on the same index stream: the test draws JAX's minibatch indices
with the same ``split``/``randint`` calls as the JAX loop and hands them to
the port as ``indices``.  Losses must agree per step to 1e-10 relative and
the final parameters to 1e-9: the same float64 steps, with the banded core
by explicit adjoints in the port and by autodiff through scans in the JAX
package, and Adam's update in two orders of rounding.  On the CPU the
core's kernels run their plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asvgp_tpu.basis import B3Spline as JB3Spline
from asvgp_tpu.models import Matern32 as JMatern32
from asvgp_tpu.models.gpr1d import default_params
from asvgp_tpu.train import fit_adam_minibatch as jfit_adam_minibatch
from asvgp_tpu_torch.banded import core
from asvgp_tpu_torch.basis import B3Spline
from asvgp_tpu_torch.train import fit_adam_minibatch
from asvgp_tpu_torch.train.adam import minibatch_loss

N, M, BATCH, STEPS = 512, 24, 64, 10
PATHS = (("kernel", "raw_lengthscales"), ("kernel", "raw_variance"), ("likelihood", "raw_variance"))


def data():
    rng = np.random.RandomState(0)
    x = rng.uniform(0.02, 0.98, N)
    return x, np.sin(8 * x) + 0.1 * rng.randn(N)


def jax_indices(seed, steps, batch, n):
    """The JAX loop's minibatch indices: split the key once per step and
    draw from the subkey."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.randint(sub, (batch,), 0, n)))
    return np.stack(out)


def init_params():
    return default_params(JMatern32(0.8, 0.3), 0.15)


def leaf(tree, path):
    for key in path:
        tree = tree[key]
    return float(np.asarray(tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree))


def test_fit_adam_minibatch_matches_jax():
    x, y = data()
    want_params, want_losses = jfit_adam_minibatch(
        JB3Spline(0.0, 1.0, M), 3, jnp.asarray(x), jnp.asarray(y),
        jax.tree.map(jnp.asarray, init_params()), batch_size=BATCH, steps=STEPS,
        learning_rate=1e-2, seed=0)
    core.reset_counters()
    params, losses = fit_adam_minibatch(
        B3Spline(0.0, 1.0, M), 3, x, y, init_params(), batch_size=BATCH, steps=STEPS,
        learning_rate=1e-2, device="cpu", indices=jax_indices(0, STEPS, BATCH, N))
    assert losses.shape == (STEPS,) and losses.dtype == torch.float64
    want = np.asarray(want_losses)
    assert float(np.max(np.abs(losses.numpy() - want) / np.abs(want))) <= 1e-10
    for path in PATHS:
        got, ref = leaf(params, path), leaf(want_params, path)
        assert abs(got - ref) / abs(ref) <= 1e-9, path
    # each step: K1 + K2 forward, K7 + K8 backward, all plain on the CPU
    assert core.PLAIN_CALLS == {"cpu": 4 * STEPS, "cuda": 0}
    assert sum(core.LAUNCHES.values()) == 0


def test_minibatch_loss_and_grad_match_jax():
    """Step 1 alone: the loss and its gradient in the raw parameters, by
    ``jax.value_and_grad`` of the JAX loop's loss on the same minibatch."""
    from asvgp_tpu.features.spline_features import make_kuu
    from asvgp_tpu.models.gpr1d import collapsed_elbo_banded, params_to_kernel, params_to_likelihood
    from asvgp_tpu.stats.sufficient import SufficientStats, _stats_local

    x, y = data()
    idx = jax_indices(3, 1, BATCH, N)[0]
    jbasis = JB3Spline(0.0, 1.0, M)

    def jloss(p):  # the loss of asvgp_tpu/train/adam.py, written out
        stats = _stats_local(jbasis, jnp.asarray(x[idx]), jnp.asarray(y[idx]))
        scale = N / stats.n
        stats = SufficientStats(kuf_y=stats.kuf_y * scale, kufkfu_band=stats.kufkfu_band * scale,
                                yty=stats.yty * scale, n=stats.n * scale)
        kernel, lik = params_to_kernel(p, 3), params_to_likelihood(p)
        return -collapsed_elbo_banded(stats, make_kuu(kernel, jbasis), lik.variance,
                                      stats.n * kernel.variance)

    value, grad = jax.jit(jax.value_and_grad(jloss))(jax.tree.map(jnp.asarray, init_params()))
    params = {g: {k: torch.tensor(float(v), dtype=torch.float64, requires_grad=True)
                  for k, v in d.items()} for g, d in init_params().items()}
    loss = minibatch_loss(B3Spline(0.0, 1.0, M), 3, N, params, torch.from_numpy(x[idx]),
                          torch.from_numpy(y[idx]))
    loss.backward()
    assert abs(float(loss.detach()) - float(value)) / abs(float(value)) <= 1e-12
    for path in PATHS:
        got = float(params[path[0]][path[1]].grad)
        assert abs(got - leaf(grad, path)) / abs(leaf(grad, path)) <= 1e-10, path


def test_draws_follow_the_seed_and_indices_are_checked(capsys):
    x, y = data()
    basis = B3Spline(0.0, 1.0, M)
    runs = [fit_adam_minibatch(basis, 3, x, y, init_params(), batch_size=16, steps=3,
                               seed=seed, device="cpu", log_every=2)[1] for seed in (5, 5, 6)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    # log_every=2 over 3 steps: one line per run, at step 2
    assert capsys.readouterr().out.count("step 2: loss") == 3
    with pytest.raises(ValueError, match="indices"):
        fit_adam_minibatch(basis, 3, x, y, init_params(), batch_size=16, steps=3,
                           device="cpu", indices=np.zeros((3, 8), dtype=np.int64))


def test_device_defaults_to_the_card():
    x, y = data()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card, tested on the GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        fit_adam_minibatch(B3Spline(0.0, 1.0, M), 3, x, y, init_params(), steps=1)


@pytest.mark.cuda
def test_cuda_fit_adam_minibatch_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA sweeps have no CPU mode")
    x, y = data()
    idx = jax_indices(0, STEPS, BATCH, N)
    basis = B3Spline(0.0, 1.0, M)
    want_params, want = fit_adam_minibatch(basis, 3, x, y, init_params(), batch_size=BATCH,
                                           steps=STEPS, device="cpu", indices=idx)
    core.reset_counters()
    params, losses = fit_adam_minibatch(basis, 3, x, y, init_params(), batch_size=BATCH,
                                        steps=STEPS, indices=idx)
    torch.cuda.synchronize()
    assert {k: v for k, v in core.LAUNCHES.items() if v} == dict.fromkeys(
        ("chol_pair_solve", "tak_pair_solve", "tak_bwd_vec", "chol_bwd_pair"), STEPS)
    assert core.PLAIN_CALLS["cuda"] == 0
    assert float(torch.max(torch.abs(losses - want) / torch.abs(want))) <= 1e-10
    for path in PATHS:
        assert params[path[0]][path[1]].is_cuda
        assert abs(leaf(params, path) - leaf(want_params, path)) <= 1e-9 * abs(leaf(want_params, path))
