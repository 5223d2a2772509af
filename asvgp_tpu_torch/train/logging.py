"""Structured metrics logging: step metrics as JSONL and the wall-time split
of precompute, optimize and predict that the reference reports.

PyTorch counterpart of ``asvgp_tpu/train/logging.py``.  ``WallClock``
takes a device: on a CUDA device each section synchronises the device
where it starts and ends, so the host clock covers the work the section
queued there and nothing queued before it.
"""

from __future__ import annotations

import json
import time

import torch


class MetricsLogger:
    """Append step metric dicts to a JSONL file (or collect them in memory)."""

    def __init__(self, path: str | None = None):
        self.path = path
        self.rows = []
        self._fh = open(path, "a") if path else None

    def log(self, step: int, **metrics):
        row = {"step": step, "time": time.time(), **{
            k: (float(v) if hasattr(v, "__float__") else v) for k, v in metrics.items()
        }}
        self.rows.append(row)
        if self._fh:
            self._fh.write(json.dumps(row) + "\n")
            self._fh.flush()
        return row

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None


class WallClock:
    """Seconds per named section, summed over the section's uses (the
    reference's precompute/opt/pred bracket, eNATL60.py:85-102)."""

    def __init__(self, device=None):
        self.times = {}
        self.device = torch.device(device) if device is not None else None

    def _sync(self):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def section(self, name: str):
        clock = self

        class _Section:
            def __enter__(self):
                clock._sync()
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                clock._sync()
                clock.times[name] = clock.times.get(name, 0.0) + time.perf_counter() - self.t0
                return False

        return _Section()

    def summary(self):
        return {**self.times, "total": sum(self.times.values())}
