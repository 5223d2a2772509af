"""Checkpoint and resume of parameter pytrees.

PyTorch counterpart of ``asvgp_tpu/train/checkpoint.py``, in its file
format: a pickle of ``{"leaves": [numpy arrays], "treedef": str}``, with the
leaves in the order in which JAX flattens the tree (dict keys sorted, list
and tuple items in order, ``None`` an empty node) and the structure
rendered as JAX renders a ``PyTreeDef``.  A checkpoint written by either
package loads in the other.

Save a model's parameters with ``save_pytree(path, model.params())`` and
restore them with ``model.load_jax_params(load_pytree(path,
model.params()))``.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch

from asvgp_tpu_torch.train.lbfgs import _leaves, _unflatten


def _structure(tree) -> str:
    """``tree``'s structure as JAX prints its ``PyTreeDef``: ``*`` a leaf,
    ``None``, ``[...]``, ``(...)`` (``(*,)`` for one item), ``{key: ...}``
    with sorted keys."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{key!r}: {_structure(tree[key])}" for key in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_structure(item) for item in tree) + "]"
    if isinstance(tree, tuple):
        items = [_structure(item) for item in tree]
        return "(" + ", ".join(items) + ("," if len(items) == 1 else "") + ")"
    return "*"


def _tree_flatten(tree) -> tuple[list, str]:
    """(leaves, structure string) of a pytree of dicts, lists, tuples and
    ``None``, as ``jax.tree.flatten`` gives them (the string is
    ``str(treedef)``)."""
    return list(_leaves(tree)), f"PyTreeDef({_structure(tree)})"


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(path: str, tree) -> None:
    """Write ``tree``'s leaves (copied to the host as numpy arrays) and its
    structure to ``path``."""
    leaves, treedef = _tree_flatten(tree)
    payload = {"leaves": [_host(leaf) for leaf in leaves], "treedef": treedef}
    with open(path, "wb") as f:
        pickle.dump(payload, f)


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else np.shape(leaf)


def _like(saved, leaf) -> torch.Tensor:
    """``saved`` as a tensor of ``leaf``'s dtype, on its device (a numpy or
    Python leaf: its numpy dtype, on the CPU)."""
    if isinstance(leaf, torch.Tensor):
        return torch.as_tensor(np.asarray(saved)).to(dtype=leaf.dtype, device=leaf.device)
    return torch.as_tensor(np.asarray(saved, dtype=np.asarray(leaf).dtype))


def load_pytree(path: str, like):
    """Load leaves saved by ``save_pytree`` into the structure of ``like``:
    tensors with the dtype and device of ``like``'s leaves.

    The stored structure must match ``like``'s exactly: a silent positional
    restore into a differently shaped pytree would scramble parameters."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    leaves, treedef = _tree_flatten(like)
    saved = payload["leaves"]
    if len(saved) != len(leaves):
        raise ValueError(f"checkpoint has {len(saved)} leaves, expected {len(leaves)}")
    saved_def = payload.get("treedef")
    if saved_def is not None and saved_def != treedef:
        raise ValueError(
            "checkpoint pytree structure does not match the target:\n"
            f"  saved:  {saved_def}\n  target: {treedef}"
        )
    shapes = [(np.shape(s), _shape(l)) for s, l in zip(saved, leaves)]
    bad = [i for i, (a, b) in enumerate(shapes) if a != b]
    if bad:
        raise ValueError(
            f"checkpoint leaf shapes differ at indices {bad}: {[shapes[i] for i in bad]}"
        )
    return _unflatten(like, iter([_like(s, l) for s, l in zip(saved, leaves)]))
