"""The traced part of a window: torch.profiler over the first items of a
traced run, reduced to what the per-layer readers and the breakdown need.

``busy_s`` is the union of the device's operation intervals (kernels,
copies, sets; not the annotations of host ranges) inside the profiled window, ``window_s`` that window's
length; an idle gap is a stretch of the window in which the device ran
nothing, named by the innermost host operation that covers its middle.
"""

from __future__ import annotations

from collections import defaultdict

import torch

TOP = 10
MARK = "benchmark_window"


class Profiled:
    def __init__(self, device):
        self.device = torch.device(device)
        self.prof = None
        self.mark = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.mark = record_function(MARK)
        self.mark.__enter__()

    def stop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.mark.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)

    def reduce(self) -> dict:
        from torch.autograd import DeviceType

        events = list(self.prof.events())
        marks = [e for e in events if e.name == MARK and e.device_type == DeviceType.CPU]
        lo = min(e.time_range.start for e in marks)
        hi = max(e.time_range.end for e in marks)
        dev, host = [], []
        for e in events:
            if getattr(e, "is_user_annotation", False) or e.name == MARK:
                continue
            if e.device_type == DeviceType.CUDA:
                dev.append((e.time_range.start, e.time_range.end, e.name))
            elif not e.is_async:
                host.append((e.time_range.start, e.time_range.end, e.name))
        dev = [(max(s, lo), min(t, hi), n) for s, t, n in dev if t > lo and s < hi]
        dev.sort()
        by_name = defaultdict(lambda: [0.0, 0])
        for s, t, n in dev:
            by_name[n][0] += (t - s) * 1e-6
            by_name[n][1] += 1
        busy, gaps, end = 0.0, [], lo
        for s, t, _ in dev:
            if s > end:
                gaps.append((end, s))
            if t > end:
                busy += t - max(s, end)
                end = t
        if hi > end:
            gaps.append((end, hi))
        gaps.sort(key=lambda g: g[0] - g[1])
        host.sort()
        idle = []
        for g0, g1 in gaps[:TOP]:
            mid = 0.5 * (g0 + g1)
            covering = [h for h in host if h[0] <= mid <= h[1]]
            name = max(covering, key=lambda h: h[0])[2] if covering else "host (no operation)"
            idle.append([name[:96], (g1 - g0) * 1e-6])
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
        return {
            "window_s": (hi - lo) * 1e-6,
            "busy_s": busy * 1e-6,
            "device_ops": len(dev),
            "kernels": {n: {"seconds": v[0], "count": v[1]} for n, v in by_name.items()},
            "top_ops": [[n[:96], v[0]] for n, v in top],
            "idle_gaps": idle,
        }


class View:
    """What a per-layer reader sees: the run's config, traffic, arithmetic,
    spans and counters, and the reduced profile of its first ``items``
    items."""

    def __init__(self, run):
        self.config = run.config
        self.traffic = run.traffic
        self.arith = run.arith
        self.spans = run.spans
        self.counters = run.counters
        self.profile = run.profile
        self.items = run.profiled_items

    def kernel(self, part: str):
        """(seconds, launches) of the profiled device operations whose name
        holds ``part``; None without a profile or without such operations."""
        if not self.profile:
            return None
        hits = [v for n, v in self.profile["kernels"].items() if part in n]
        if not hits:
            return None
        return sum(v["seconds"] for v in hits), sum(v["count"] for v in hits)

    def device_s(self):
        """Device seconds of the profiled items (the union of the device's
        operation intervals); None where the device ran nothing."""
        if not self.profile or self.profile["busy_s"] <= 0:
            return None
        return self.profile["busy_s"]

    def idle_share(self):
        busy = self.device_s()
        if busy is None:
            return None
        return 100.0 * (1.0 - busy / self.profile["window_s"])
