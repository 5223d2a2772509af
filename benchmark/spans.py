"""The program's own spans and counters over a traced window's items, for
the per-layer readers in ``metrics/``.

The program keeps, while a torch.profiler session is active, one record a
root span (a request's ``predict_f``, a build's ``kron.init``) with its
child spans' host and device times and the root's counts
(``asvgp_tpu_torch.utils.profiling.span_records``).  A reader takes the
last ``items`` roots of its name, which are the profiled items.  Where the
program keeps no such record (a checkout that predates it), or the device
ran nothing (a run on the CPU), it finds nothing and reads None.
"""

from __future__ import annotations


def roots(v, name: str):
    """The span lists of the profiled items' roots named ``name``, oldest
    first; None without a device profile or without one root an item."""
    if v.device_s() is None or not v.items:
        return None
    try:
        from asvgp_tpu_torch.utils.profiling import span_records
    except ImportError:
        return None
    found = [spans for spans in span_records() if spans[0]["name"] == name]
    return found[-v.items:] if len(found) >= v.items else None


def phase_ms(v, root: str, phase: str, clock: str = "device_ms"):
    """The mean over the profiled items of the summed ``clock`` (device_ms
    or host_ms) of the spans named ``phase`` under the roots named
    ``root``; None where an item has no such span or no such time."""
    items = roots(v, root)
    if items is None:
        return None
    total = 0.0
    for spans in items:
        times = [s[clock] for s in spans if s["name"] == phase]
        if not times or None in times:
            return None
        total += sum(times)
    return total / len(items)


def root_count(v, root: str, count: str):
    """The mean over the profiled items of the root's ``count``
    (launches, host_syncs, device_allocs); None where a root lacks it."""
    items = roots(v, root)
    if items is None:
        return None
    values = [spans[0].get(count) for spans in items]
    if None in values:
        return None
    return sum(values) / len(values)
