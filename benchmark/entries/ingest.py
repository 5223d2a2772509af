"""The ``ingest`` loop: the model built on snapshot after snapshot, which is
the statistics build (for kron: the sort by joint cell and the fixed-order
prefix sums of Kuf·y, KufKfu's multiband, yᵀy and n).

Set-up draws a pool of ``pool`` snapshots of the config's ``n_train``
points on the device from the seed and warms up one build.  The window
builds the family's model (for kron, ``GPRKron(snapshot, kernels, bases,
noise_variance=..., device=...)``) on the snapshots round-robin, a synchronise after each;
``stats_pts_per_s`` counts the points of the builds completed over the
window.  The check recomputes the statistics of a sample of the builds,
drawn from the seed, by the family's plain reference.  Traffic keys: ``pool``,
``sample``, ``trace_items``.
"""

from __future__ import annotations

import sys
import time

from benchmark.core import Sample


def setup(run) -> dict:
    pool = [run.data(stream=10 + i) for i in range(int(run.traffic["pool"]))]
    run.mark("data")
    parts = run.family.parts(run.config)
    run.family.build(run.config, parts, *pool[0], run.device)
    return {"pool": pool, "parts": parts, "sample": Sample(int(run.traffic["sample"]), run.seed)}


def window(run, st: dict) -> dict:
    pool, parts, fam = st["pool"], st["parts"], run.family
    done, failed, first, last = 0, 0, None, None
    while True:
        i = (done + failed) % len(pool)
        with run.item(done + failed):
            t0 = time.perf_counter()
            try:
                model = fam.build(run.config, parts, *pool[i], run.device)
                run.sync()
                done += 1
            except (RuntimeError, ValueError) as exc:
                failed += 1
                print(f"build failed: {exc}", file=sys.stderr, flush=True)
                model = None
            t1 = time.perf_counter()
        first = t0 if first is None else first
        last = t1
        if model is not None:
            st["sample"].offer(lambda m=model, i=i: {"snapshot": i, **fam.stats(m)})
            if run.trace:
                run.spans["build"].append(t1 - t0)
        del model
        if t1 - first >= run.seconds:
            break
    n = int(run.config["n_train"])
    return {"attempted": done + failed, "failed": failed,
            "e2e": {"stats_pts_per_s": n * done / (last - first)}}


def release(st: dict) -> None:
    st["parts"] = None


def outputs(st: dict) -> list:
    return st["sample"].items


def reference(run, st: dict, dtype) -> list:
    """The plain statistics of each sampled build's snapshot, in ``dtype``."""
    cache, out = {}, []
    for item in st["sample"].items:
        i = item["snapshot"]
        if i not in cache:
            cache[i] = run.family.ref_stats(run.config, *st["pool"][i], dtype)
        out.append({"snapshot": i, **cache[i]})
    return out


def compare(run, got: list, ref: list) -> dict:
    """The family's gaps, the worst over the sampled builds; ``builds``,
    which has no limit, where no build was sampled."""
    if not got or len(got) != len(ref):
        return {"builds": float("inf")}
    out = {}
    for g, r in zip(got, ref):
        for k, v in run.family.compare_stats(g, r).items():
            out[k] = max(out.get(k, 0.0), v)
    return out
