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
K2 forward and K7 + K8 backward, once each per step.  ``fit_adam_minibatch(...,
dtype=torch.float32)`` is the JAX package's loop with x64 off: data,
parameters, each batch's statistics and Adam's moments in float32, the core
on the float32 route (K17 ×2, K19, K21 forward; K18 ×2, K20, K22 backward).
"""

from __future__ import annotations

import torch

from asvgp_tpu_torch.features.spline_features import make_kuu
from asvgp_tpu_torch.models.gpr1d import collapsed_elbo_banded, resolve_device
from asvgp_tpu_torch.models.kernels import Matern
from asvgp_tpu_torch.models.parameters import positive
from asvgp_tpu_torch.stats.sufficient import SufficientStats, compute_stats, rescale_stats
from asvgp_tpu_torch.train.lbfgs import _leaves, _unflatten, tree_map


class Adam:
    """``optax.adam`` as a functional optimizer over a params pytree (dicts,
    lists and tuples of tensors): ``init(params)`` gives the state (the step
    count and the two moments, trees like ``params``), ``update(grads,
    state)`` the updates and the next state, ``apply(params, updates)`` the
    next parameters.  The arithmetic is optax's, in its order: the moments
    (1 − β₁)·g + β₁·m and (1 − β₂)·g² + β₂·v, the bias corrections 1 − βᵗ in
    float64 on the host, then −lr · m̂ / (√v̂ + ε)."""

    def __init__(self, learning_rate: float = 1e-2, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.learning_rate, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps

    def init(self, params) -> dict:
        def zeros(p):
            return torch.zeros_like(torch.as_tensor(p))

        return {"count": 0, "mu": tree_map(zeros, params), "nu": tree_map(zeros, params)}

    def update(self, grads, state):
        b1, b2, eps, lr = self.b1, self.b2, self.eps, self.learning_rate
        count = state["count"] + 1
        mu = _map2(lambda g, m: (1 - b1) * g + b1 * m, grads, state["mu"])
        nu = _map2(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads, state["nu"])
        c1, c2 = 1 - b1 ** count, 1 - b2 ** count
        updates = _map2(lambda m, v: (m / c1) / (torch.sqrt(v / c2) + eps) * (-lr), mu, nu)
        return updates, {"count": count, "mu": mu, "nu": nu}

    @staticmethod
    def apply(params, updates):
        return _map2(lambda p, u: p + u, params, updates)


def _map2(fn, a, b):
    """``fn`` applied to the paired leaves of two pytrees of one layout."""
    return _unflatten(a, (fn(x, y) for x, y in zip(_leaves(a), _leaves(b), strict=True)))


def collapsed_loss(basis, nu2, params, stats: SufficientStats):
    """−(collapsed ELBO) of the 1-D model from its statistics at ``params``
    (JAX layout), as the JAX package's minibatch and data-parallel losses."""
    kernel = Matern(positive(params["kernel"]["raw_variance"]),
                    positive(params["kernel"]["raw_lengthscales"]), nu2=nu2)
    sigma2 = positive(params["likelihood"]["raw_variance"])
    kuu = make_kuu(kernel, basis)
    return -collapsed_elbo_banded(stats, kuu, sigma2, stats.n * kernel.variance)


def minibatch_loss(basis, nu2, n_total: int, params, xb, yb):
    """−(stochastic collapsed ELBO) of the minibatch (xb, yb): its statistics
    scaled by N/B, then the collapsed bound at ``params`` (JAX layout)."""
    return collapsed_loss(basis, nu2, params, rescale_stats(compute_stats(basis, xb, yb), n_total))


def adam_loop(loss_fn, x, y, params, *, batch_size: int, steps: int, learning_rate: float,
              seed: int, indices=None, log_every: int = 0, on_step=None):
    """``steps`` Adam steps of ``loss_fn(params, xb, yb)`` on minibatches of
    the device tensors (x, y).

    ``Adam(learning_rate)`` with optax's defaults (β₁ = 0.9, β₂ = 0.999,
    ε = 1e-8, no ε inside the root), in the dtype of the data ``x``: the
    parameters are cast to it.  ``indices`` (steps, batch_size) replaces the
    draws.  ``log_every`` > 0 prints the loss every that many steps (one
    host sync each).  ``on_step(step, loss, params, grads)``, if given, sees
    each step's loss and gradient (at the parameters before the step) and
    the parameters after it.  Returns (params in the JAX layout, on the
    device; losses (steps,) on the CPU)."""
    device = x.device
    n = x.shape[0]
    leaves = [torch.as_tensor(v).to(device=device, dtype=x.dtype).detach().clone()
              for v in _leaves(params)]
    opt = Adam(learning_rate)
    state = opt.init(leaves)
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
        leaves = [p.requires_grad_() for p in leaves]
        loss = loss_fn(_unflatten(params, iter(leaves)), x[idx], y[idx])
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            updates, state = opt.update(list(grads), state)
            leaves = opt.apply([p.detach() for p in leaves], updates)
        losses[step] = loss.detach()
        if on_step is not None:
            on_step(step, loss.detach(), _unflatten(params, iter(leaves)),
                    _unflatten(params, iter(grads)))
        if log_every and (step + 1) % log_every == 0:
            print(f"step {step + 1}: loss {float(losses[step]):.10g}", flush=True)
    return _unflatten(params, iter(leaves)), losses.cpu()


def fit_adam_minibatch(basis, nu2, X, y, params, *, batch_size=1024, steps=1000,
                       learning_rate=1e-2, seed=0, log_every=0, device=None, indices=None,
                       dtype=None):
    """Minibatch Adam on the stochastic collapsed ELBO of the 1-D model.

    ``params`` is a params pytree in the JAX package's layout (numpy arrays
    or tensors); ``device`` defaults to the CUDA device and raises without
    one (pass ``device="cpu"`` for the CPU).  ``dtype`` (``None``: float64;
    ``torch.float32``) stands in for the JAX package's x64 switch: X, y and
    the parameters are cast to it, and each batch's statistics, the loss and
    Adam's state are computed in it.  Returns (params, losses (steps,)): the
    parameters as tensors on the device, the losses on the CPU."""
    device = resolve_device(device)
    if dtype not in (None, torch.float64, torch.float32):
        raise ValueError(f"dtype must be None, torch.float64 or torch.float32, got {dtype}")
    dtype = dtype or torch.float64
    x = torch.as_tensor(X).to(device=device, dtype=dtype).reshape(-1)
    yf = torch.as_tensor(y).to(device=device, dtype=dtype).reshape(-1)
    n_total = x.shape[0]

    def loss_fn(p, xb, yb):
        return minibatch_loss(basis, nu2, n_total, p, xb, yb)

    return adam_loop(loss_fn, x, yf, params, batch_size=batch_size, steps=steps,
                     learning_rate=learning_rate, seed=seed, indices=indices,
                     log_every=log_every)
