"""Full-batch L-BFGS training.

PyTorch counterpart of ``asvgp_tpu/train/lbfgs.py`` ``fit_lbfgs`` with its
default engine (train/fused_lbfgs.py): L-BFGS with a zoom line search, the
equivalent of ``gpflow.optimizers.Scipy`` in the reference experiments.

The objective is evaluated on the device of the parameters it is given;
the optimizer itself runs on the host (fused_lbfgs.py says why).  Each
evaluation copies the query point to the device once, runs the objective
and its gradient there, and reads value and gradient back in one copy: one
host synchronisation per evaluation.
"""

from __future__ import annotations

import numpy as np
import torch

from asvgp_tpu_torch.train.fused_lbfgs import make_fused_run


def _leaves(tree):
    """The leaves of a pytree of dicts, lists and tuples in the order in
    which JAX flattens it (dict keys sorted, list and tuple items in index
    order, ``None`` a node without leaves), so that dot products over the
    flat vector sum alike."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key])
    elif isinstance(tree, (list, tuple)):
        for item in tree:
            yield from _leaves(item)
    else:
        yield tree


def _unflatten(tree, values):
    """A pytree shaped like ``tree`` whose leaves are taken from the
    iterator ``values`` in ``_leaves`` order; dicts come back with sorted
    keys, lists and tuples as lists and tuples, ``None`` as ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {key: _unflatten(tree[key], values) for key in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(item, values) for item in tree)
    return next(values)


def tree_map(fn, tree):
    """``fn`` applied to each leaf of a pytree of dicts, lists and tuples,
    in the layout ``_unflatten`` gives."""
    return _unflatten(tree, (fn(v) for v in _leaves(tree)))


def fit_lbfgs(loss_fn, params, *, max_iters: int = 500, tol: float = 1e-8,
              memory_size: int = 20, info: dict | None = None, restarts: int = 0,
              max_linesearch_steps: int = 30, curv_rtol: float = 0.9,
              ls_guess: str = "keep"):
    """Minimize ``loss_fn(params)`` over the ``params`` pytree (nested dicts,
    lists and tuples of tensors or numpy arrays) with L-BFGS and a zoom line
    search.  Returns (params, final_loss, num_iters): the parameters in the
    same tree, as tensors on the device of the given ones (the CPU for
    numpy), the loss as a float.

    The fit runs in the parameters' dtype, as the JAX package's runs in
    ``ravel_pytree``'s: all float32 leaves give a float32 fit (evaluation
    point, gradient, controller and result), anything else float64.

    ``info``: optional dict; records ``grad_norm`` (final gradient norm),
    ``converged`` (grad_norm < tol), ``restarts`` (restarts used),
    ``ls_evals`` (objective evaluations), ``evals_per_iter`` and
    ``stopping_rule``.

    ``restarts``: rerun the loop (fresh L-BFGS memory and line-search state,
    same point) up to this many extra times while unconverged; a restart is
    kept only if it lowers the loss, and the first one that does not ends
    the fit.

    ``curv_rtol`` trades Wolfe strictness for fewer evaluations: 0.9 is the
    classical strong-Wolfe setting; values above 1 + |slope cap| switch the
    curvature test off (the large-scale protocols pass 10.0).
    """
    leaves = list(_leaves(params))
    tensors = [v for v in leaves if isinstance(v, torch.Tensor)]
    devices = {t.device for t in tensors}
    if len(devices) > 1:
        raise ValueError(f"all parameters must lie on one device, got {sorted(map(str, devices))}")
    device = devices.pop() if devices else torch.device("cpu")
    host = [np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v) for v in leaves]
    dtype = np.float32 if all(a.dtype == np.float32 for a in host) else np.float64
    tdtype = torch.float32 if dtype == np.float32 else torch.float64
    shapes = [a.shape for a in host]
    sizes = [a.size for a in host]
    flat0 = np.concatenate([a.reshape(-1).astype(dtype) for a in host])

    def to_tree(vec: torch.Tensor):
        parts = torch.split(vec, sizes)
        return _unflatten(params, iter([p.view(s) for p, s in zip(parts, shapes)]))

    def value_and_grad(q: np.ndarray):
        x = torch.tensor(q, dtype=tdtype, device=device, requires_grad=True)
        with torch.enable_grad():
            value = loss_fn(to_tree(x))
            (grad,) = torch.autograd.grad(value, x)
        # one device-to-host copy for value and gradient together
        out = torch.cat([value.detach().reshape(1), grad]).cpu().numpy()
        return out[0], out[1:]

    run = make_fused_run(
        value_and_grad, max_iters=max_iters, tol=tol, memory_size=memory_size,
        max_linesearch_steps=max_linesearch_steps, curv_rtol=curv_rtol,
        ls_guess=ls_guess,
    )

    x, iters, final_loss, grad_norm, evals = run(flat0)
    used = 0
    rejected_iters = 0
    for _ in range(restarts):
        if grad_norm < tol:
            break
        x2, it2, l2, g2, e2 = run(x)
        used += 1
        # accept only improvements: a non-improving restart means further
        # ones will not help either
        if l2 < final_loss:
            iters += it2
            evals += e2
            x, final_loss, grad_norm = x2, l2, g2
        else:
            rejected_iters += it2
            break

    if info is not None:
        info["grad_norm"] = float(grad_norm)
        info["converged"] = bool(grad_norm < tol)
        info["restarts"] = used
        info["ls_evals"] = evals
        if iters:
            info["evals_per_iter"] = round(evals / iters, 2)
        if rejected_iters:
            info["rejected_restart_iters"] = rejected_iters
        info["stopping_rule"] = (
            f"grad_norm<{tol:g} or {max_iters} iters/run; up to "
            f"{restarts} accept-only-if-better restarts; zoom ls "
            f"(c1=1e-4, curv_rtol={curv_rtol:g}, guess={ls_guess})"
        )
    params_out = to_tree(torch.as_tensor(x, dtype=tdtype).to(device))
    return params_out, float(final_loss), int(iters)
