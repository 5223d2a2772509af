"""Adam on minibatches: the stochastic collapsed bound, and the loop that
``fit_svgp`` shares.

PyTorch counterpart of ``asvgp_tpu/train/adam.py``.  Each step draws a
minibatch, assembles its sufficient statistics rescaled by N/B (the
stochastic collapsed bound) and takes one Adam step on the
hyperparameters.  The data move to the device once, the minibatches are
drawn there (``torch.randint`` from a ``torch.Generator`` on that device),
and the loss history stays there until one host copy at the end.  The
JAX package draws with ``jax.random``, which gives other indices from the
same seed; ``indices`` replaces the draws with a given index stream, so
that the two packages can be compared step by step.

On a CUDA device the loss's banded core is ``banded.collapsed_core``: K1 +
K2 forward and K7 + K8 backward, once each per step.
"""

from __future__ import annotations

import torch

from asvgp_tpu_torch.features.spline_features import make_kuu
from asvgp_tpu_torch.models.gpr1d import collapsed_elbo_banded, resolve_device
from asvgp_tpu_torch.models.kernels import Matern
from asvgp_tpu_torch.models.parameters import positive
from asvgp_tpu_torch.stats.sufficient import SufficientStats, compute_stats
from asvgp_tpu_torch.train.lbfgs import _leaves, _unflatten

_F64 = torch.float64


def minibatch_loss(basis, nu2, n_total: int, params, xb, yb):
    """−(stochastic collapsed ELBO) of the minibatch (xb, yb): its statistics
    scaled by N/B, then the collapsed bound at ``params`` (JAX layout)."""
    stats = compute_stats(basis, xb, yb)
    scale = torch.as_tensor(float(n_total), dtype=xb.dtype, device=xb.device) / stats.n
    stats = SufficientStats(
        kuf_y=stats.kuf_y * scale,
        kufkfu_band=stats.kufkfu_band * scale,
        yty=stats.yty * scale,
        n=stats.n * scale,
    )
    kernel = Matern(positive(params["kernel"]["raw_variance"]),
                    positive(params["kernel"]["raw_lengthscales"]), nu2=nu2)
    sigma2 = positive(params["likelihood"]["raw_variance"])
    kuu = make_kuu(kernel, basis)
    return -collapsed_elbo_banded(stats, kuu, sigma2, stats.n * kernel.variance)


def adam_loop(loss_fn, x, y, params, *, batch_size: int, steps: int, learning_rate: float,
              seed: int, indices=None, log_every: int = 0):
    """``steps`` Adam steps of ``loss_fn(params, xb, yb)`` on minibatches of
    the device tensors (x, y).

    Adam with optax's defaults (β₁ = 0.9, β₂ = 0.999, ε = 1e-8, no ε inside
    the root).  ``indices`` (steps, batch_size) replaces the draws.
    ``log_every`` > 0 prints the loss every that many steps (one host sync
    each).  Returns (params in the JAX layout, on the device; losses
    (steps,) on the CPU)."""
    device = x.device
    n = x.shape[0]
    leaves = [torch.as_tensor(v, dtype=_F64, device=device).detach().clone().requires_grad_()
              for v in _leaves(params)]
    opt = torch.optim.Adam(leaves, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    if indices is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    else:
        indices = torch.as_tensor(indices, dtype=torch.int64, device=device)
        if tuple(indices.shape) != (steps, batch_size):
            raise ValueError(f"indices must be (steps, batch_size) = {(steps, batch_size)}, "
                             f"got {tuple(indices.shape)}")
    losses = x.new_empty(steps)
    for step in range(steps):
        if indices is None:
            idx = torch.randint(0, n, (batch_size,), generator=gen, device=device)
        else:
            idx = indices[step]
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(_unflatten(params, iter(leaves)), x[idx], y[idx])
        loss.backward()
        opt.step()
        losses[step] = loss.detach()
        if log_every and (step + 1) % log_every == 0:
            print(f"step {step + 1}: loss {float(loss):.10g}", flush=True)
    return _unflatten(params, (p.detach() for p in leaves)), losses.cpu()


def fit_adam_minibatch(basis, nu2, X, y, params, *, batch_size=1024, steps=1000,
                       learning_rate=1e-2, seed=0, log_every=0, device=None, indices=None):
    """Minibatch Adam on the stochastic collapsed ELBO of the 1-D model.

    ``params`` is a params pytree in the JAX package's layout (numpy arrays
    or tensors); ``device`` defaults to the CUDA device and raises without
    one (pass ``device="cpu"`` for the CPU).  Returns (params, losses
    (steps,)): the parameters as tensors on the device, the losses on the
    CPU."""
    device = resolve_device(device)
    x = torch.as_tensor(X, dtype=_F64, device=device).reshape(-1)
    yf = torch.as_tensor(y, dtype=_F64, device=device).reshape(-1)
    n_total = x.shape[0]

    def loss_fn(p, xb, yb):
        return minibatch_loss(basis, nu2, n_total, p, xb, yb)

    return adam_loop(loss_fn, x, yf, params, batch_size=batch_size, steps=steps,
                     learning_rate=learning_rate, seed=seed, indices=indices,
                     log_every=log_every)
