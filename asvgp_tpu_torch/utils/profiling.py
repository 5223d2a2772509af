"""Profiling helpers: a synchronised timer, a torch.profiler trace, and the
port's spans and counters.

PyTorch counterpart of ``asvgp_tpu/utils/profiling.py``: ``timed``
synchronises the CUDA devices of a call's result before it stops the clock
(the counterpart of ``jax.block_until_ready``), and ``trace_to`` writes a
Chrome trace of the CPU and, with a card, of its kernels.

``span(name)`` marks a phase of the port's hot paths.  It does nothing
unless a torch.profiler session is active; under one, the phase shows as a
``record_function`` range in the trace, and its host and device times and
the counts of its root (the outermost span) are kept in memory for
``span_records()``.  ``host_value`` is the one way a hot path reads a
device value on the host, and ``to_device`` the one way it puts host data
on the device: each is a synchronisation on the card, and the roots count
them.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time

import torch
from torch.autograd import profiler as _autograd_profiler


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


MAX_ROOTS = 1024
_ROOTS = collections.deque(maxlen=MAX_ROOTS)  # each root's spans, the root first
_OPEN = []  # the spans now open, outermost first
_OFF = contextlib.nullcontext()
_host_syncs = 0


def host_value(t) -> float:
    """``float(t)``, counted as a host synchronisation when ``t`` is a
    tensor: on a CUDA device the read waits for the device.  Every read of
    a device value on the port's hot paths goes through it."""
    global _host_syncs
    if isinstance(t, torch.Tensor):
        _host_syncs += 1
    return float(t)


def to_device(value, dtype, device) -> torch.Tensor:
    """``torch.as_tensor(value, dtype=dtype, device=device)``, counted as a
    host synchronisation unless ``value`` is a tensor on a device of that
    type already: torch waits for its copy of host data to a CUDA device.
    Every transfer of host data on the port's hot paths goes through it."""
    global _host_syncs
    if not (isinstance(value, torch.Tensor) and value.device.type == torch.device(device).type):
        _host_syncs += 1
    return torch.as_tensor(value, dtype=dtype, device=device)


def _cuda(device):
    """The CUDA device of a root span's work, or None off the card
    (``None`` stands for the current CUDA device, as at the entry points)."""
    if device is None:
        return torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available() \
            else None
    device = torch.device(device)
    return device if device.type == "cuda" else None


def _counts(cuda) -> dict:
    from asvgp_tpu_torch.banded import core

    allocs = (torch.cuda.memory_stats_as_nested_dict(cuda).get("num_device_alloc", 0)
              if cuda is not None else None)
    return {"launches": sum(core.LAUNCHES.values()), "host_syncs": _host_syncs,
            "device_allocs": allocs}


class _Span:
    __slots__ = ("rec", "group", "range", "cuda")

    def __init__(self, name, device):
        parent = _OPEN[-1] if _OPEN else None
        if parent is None:
            self.cuda, self.group, up = _cuda(device), [], None
        else:
            self.cuda, self.group, up = parent.cuda, parent.group, parent.rec["index"]
        self.rec = {"name": name, "parent": up, "index": len(self.group)}
        self.range = torch.profiler.record_function(name)

    def _event(self):
        if self.cuda is None:
            return None
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(self.cuda))
        return event

    def __enter__(self):
        rec = self.rec
        self.group.append(rec)
        _OPEN.append(self)
        if rec["parent"] is None:
            if self.cuda is not None:
                # anchors the root's events to the host clock
                torch.cuda.synchronize(self.cuda)
            rec["counts"] = _counts(self.cuda)
        # the clocks inside the range's own cost, so that siblings abut
        rec["t0"] = time.perf_counter_ns()
        rec["event0"] = self._event()
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        self.range.__exit__(*exc)
        rec["event1"] = self._event()
        rec["t1"] = time.perf_counter_ns()
        _OPEN.pop()
        if rec["parent"] is None:
            end = _counts(self.cuda)
            rec["counts"] = {k: None if v is None else end[k] - v
                             for k, v in rec["counts"].items()}
            _ROOTS.append(self.group)
        return False


def span(name: str, device=None):
    """A context manager around one phase of a hot path, named ``name``.

    With no torch.profiler session active it is one shared no-op.  Under
    one it enters ``torch.profiler.record_function(name)``, takes the host
    clock and, when the work runs on a CUDA device, a CUDA event on the
    current stream at entry and exit.  A root (no span open) synchronises
    ``device`` (``None``: the current CUDA device) at entry, and records
    the change over it of the port's kernel launches (``core.LAUNCHES``),
    of the synchronisations of ``host_value`` and ``to_device`` and of the
    device's ``cudaMalloc`` calls; a
    span opened inside a root takes the root's device."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, device)


def span_records() -> list:
    """The last ``MAX_ROOTS`` roots, oldest first: for each, the list of its
    spans in the order they opened, the root first.  A span is a dict of
    ``name``, ``parent`` (the index of its parent in the list, None for the
    root), ``host_ms`` and ``device_ms`` (None off the card); a root has
    ``launches``, ``host_syncs`` and ``device_allocs`` too (the last None
    off the card).  Waits for the device to reach each root's end."""
    out = []
    for group in _ROOTS:
        root = group[0]
        if root["event1"] is not None:
            root["event1"].synchronize()
        spans = []
        for rec in group:
            item = {"name": rec["name"], "parent": rec["parent"],
                    "host_ms": 1e-6 * (rec["t1"] - rec["t0"]),
                    "device_ms": (rec["event0"].elapsed_time(rec["event1"])
                                  if rec["event0"] is not None else None)}
            spans.append(item)
        spans[0].update(root["counts"])
        out.append(spans)
    return out


def clear_spans() -> None:
    """Forget the recorded roots."""
    _ROOTS.clear()
