"""Profiling helpers: a synchronised timer and a torch.profiler trace.

PyTorch counterpart of ``asvgp_tpu/utils/profiling.py``: ``timed``
synchronises the CUDA devices of a call's result before it stops the clock
(the counterpart of ``jax.block_until_ready``), and ``trace_to`` writes a
Chrome trace of the CPU and, with a card, of its kernels.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


def _devices(tree, found: set) -> set:
    """The CUDA devices of the tensors in a result (nested dicts, lists,
    tuples and objects with tensor attributes)."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            found.add(tree.device)
    elif isinstance(tree, dict):
        for value in tree.values():
            _devices(value, found)
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            _devices(value, found)
    elif hasattr(tree, "__dict__"):
        for value in vars(tree).values():
            if isinstance(value, (torch.Tensor, dict, list, tuple)):
                _devices(value, found)
    return found


def _ready(result):
    for device in _devices(result, set()):
        torch.cuda.synchronize(device)
    return result


def timed(fn, *args, reps: int = 5, warmup: int = 1, **kwargs):
    """Median wall time of ``fn(*args, **kwargs)`` over ``reps`` calls after
    ``warmup`` calls, each stopped once every CUDA device that holds a
    tensor of the result has finished.  Returns (median_seconds,
    last_result)."""
    import numpy as np

    result = None
    for _ in range(warmup):
        result = _ready(fn(*args, **kwargs))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        result = _ready(fn(*args, **kwargs))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), result


@contextlib.contextmanager
def trace_to(logdir: str):
    """torch.profiler context tracing the CPU and, when a card is present,
    CUDA; on exit it writes a Chrome trace (``trace_<pid>_<ns>.json``, view
    with chrome://tracing or Perfetto) into ``logdir``.  Yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
