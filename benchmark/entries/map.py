"""The ``map`` loop: one client predicting whole maps from a posterior,
closed loop.

Set-up builds the model from the seed's data and its posterior at the
configuration's initial parameters (the work does not depend on their
values), then warms up one request.  A request is a ``grid`` × ``grid``
map over the first two inputs on (lo, hi)², shifted by a fraction of a
grid step drawn from the seed, with every further input held at one value
drawn from the seed (a time slice); at D = 1 it is ``grid``² points along
the line, shifted alike.  ``post.predict_f(X)`` in one call, then a
synchronise.  ``map_pts_per_s`` counts the points of the requests
completed over the window, ``map_p95_ms`` is the 95th percentile of all
their latencies.  The check predicts a sample of the requests, drawn from
the seed, with the family's plain reference posterior.  Traffic keys:
``grid``, ``lo``, ``hi``, ``sample``, ``trace_items``.
"""

from __future__ import annotations

import statistics
import sys
import time

import torch

from benchmark import compare as cmp
from benchmark.core import Sample


def request(run, draw: torch.Tensor) -> torch.Tensor:
    """The request's points on the run's device from its draw (D values in
    [0, 1): two grid shifts, then one value per further input)."""
    g, lo, hi = int(run.traffic["grid"]), float(run.traffic["lo"]), float(run.traffic["hi"])
    D = len(run.config["dims"])
    if D == 1:
        line = torch.arange(g * g, dtype=torch.float64, device=run.device)
        return (lo + (line + float(draw[0])) * (hi - lo) / (g * g))[:, None]
    step = (hi - lo) / g
    base = torch.arange(g, dtype=torch.float64, device=run.device)
    u = lo + (base + float(draw[0])) * step
    v = lo + (base + float(draw[1])) * step
    cols = [u[:, None].expand(g, g).reshape(-1), v[None, :].expand(g, g).reshape(-1)]
    cols += [torch.full((g * g,), lo + (hi - lo) * float(draw[d]), dtype=torch.float64,
                        device=run.device) for d in range(2, D)]
    return torch.stack(cols, dim=1)


def setup(run) -> dict:
    X, y = run.data(stream=0)
    run.mark("data")
    model = run.family.build(run.config, run.family.parts(run.config), X, y, run.device)
    run.mark("model")
    post = run.family.posterior(model)
    run.mark("posterior")
    draws = run.gen(1, device="cpu")
    D = len(run.config["dims"])
    mean, var = post.predict_f(request(run, torch.rand(D, generator=run.gen(2, "cpu"),
                                                        dtype=torch.float64)))
    del mean, var
    return {"X": X, "y": y, "model": model, "post": post, "draws": draws,
            "sample": Sample(int(run.traffic["sample"]), run.seed)}


def window(run, st: dict) -> dict:
    post, D = st["post"], len(run.config["dims"])
    lat, done, failed, first, last = [], 0, 0, None, None
    while True:
        draw = torch.rand(D, generator=st["draws"], dtype=torch.float64)
        xq = request(run, draw)
        run.sync()
        with run.item(done + failed):
            t0 = time.perf_counter()
            try:
                mean, var = post.predict_f(xq)
                run.sync()
                done += 1
            except (RuntimeError, ValueError) as exc:
                failed += 1
                print(f"request failed: {exc}", file=sys.stderr, flush=True)
                mean = None
            t1 = time.perf_counter()
        first = t0 if first is None else first
        last = t1
        if mean is not None:
            lat.append(t1 - t0)
            st["sample"].offer(lambda d=draw, m=mean, v=var: {"draw": d, "mean": m, "var": v})
            if run.trace:
                run.spans["request"].append(t1 - t0)
        if t1 - first >= run.seconds:
            break
    pts = int(run.traffic["grid"]) ** 2
    p95 = statistics.quantiles(lat, n=20, method="inclusive")[-1] if len(lat) > 1 else lat[0]
    return {"attempted": done + failed, "failed": failed, "points": pts,
            "e2e": {"map_pts_per_s": pts * done / (last - first), "map_p95_ms": 1e3 * p95}}


def release(st: dict) -> None:
    st["model"] = None
    st["post"] = None


def outputs(st: dict) -> list:
    return st["sample"].items


def reference(run, st: dict, dtype) -> list:
    """The sampled requests predicted by the family's plain posterior at
    the configuration's initial parameters, in ``dtype``."""
    post = run.family.ref_posterior(run.config, st["X"], st["y"], dtype)
    out = []
    for item in st["sample"].items:
        mean, var = post.predict(request(run, item["draw"]).to(dtype))
        out.append({"draw": item["draw"], "mean": mean, "var": var})
    return out


def compare(run, got: list, ref: list) -> dict:
    out = {"mean": 0.0, "var": 0.0}
    if not got or len(got) != len(ref):
        return {k: float("inf") for k in out}
    for g, r in zip(got, ref):
        out["mean"] = max(out["mean"], cmp.rel_max(g["mean"], r["mean"]))
        out["var"] = max(out["var"], cmp.rel_max(g["var"], r["var"]))
    return out
