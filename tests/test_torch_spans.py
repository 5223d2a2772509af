"""The port's spans and counters (utils/profiling.py ``span``,
``host_value``, ``span_records``) on the paths the benchmark's map and
ingest cells run, and the per-layer readers of benchmark/metrics/ that
read them.  This file imports no JAX.

- With no torch.profiler session active a build and a prediction record
  nothing, and ``span`` is one shared no-op.
- Under one, a GPRKron build records one ``kron.init`` root whose children
  open in the order of the code: the checks, the basis, the sort, the pair
  products, then each block's series and scan, then the scatter; its
  ``host_syncs`` are the 5·D + 2 that a build on the card makes.  A
  prediction records one ``predict_f`` root with ``predict.basis``,
  ``predict.mean``, ``predict.var`` a chunk.
- The statistics and the predictions are the same bits with the profiler
  on and off.
- On the card (``cuda``-marked: they skip without one): the
  synchronisations that ``torch.cuda.set_sync_debug_mode("warn")`` reports
  during a build and a prediction are their roots' ``host_syncs``, and a
  root's children's device times sum to within 3 % of the root's.
"""

import traceback
import warnings
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from asvgp_tpu_torch.basis import BSplineBasis
from asvgp_tpu_torch.models import GPRKron, Matern32
from asvgp_tpu_torch.utils import profiling
from asvgp_tpu_torch.utils.profiling import clear_spans, span, span_records
from benchmark import trace
from benchmark.core import load_module

REPO = Path(__file__).resolve().parents[1]
READERS = {  # reader -> the root it reads
    "map_var_ms": "predict_f", "map_mean_ms": "predict_f", "map_basis_ms": "predict_f",
    "stats_series_ms": "kron.init", "stats_scan_ms": "kron.init",
    "stats_scatter_host_ms": "kron.init", "stats_host_syncs": "kron.init",
    "stats_device_allocs": "kron.init",
}


def field(n, seed, device="cpu"):
    rng = np.random.RandomState(seed)
    X = rng.uniform(0.02, 0.98, (n, 2))
    y = np.sin(6 * X[:, 0] + 2 * X[:, 1]) + 0.1 * rng.randn(n)
    return (torch.as_tensor(X, device=device), torch.as_tensor(y, device=device))


def build(orders=(4, 4), m=12, n=2000, device="cpu", data=None):
    X, y = data if data is not None else field(n, 0, device)
    return GPRKron((X, y), [Matern32(lengthscales=0.2)] * 2,
                   [BSplineBasis(0.0, 1.0, m, o) for o in orders], noise_variance=0.1,
                   device=device)


def query(n=500, seed=1, device="cpu"):
    return torch.as_tensor(np.random.RandomState(seed).uniform(0.05, 0.95, (n, 2)),
                           device=device)


def build_children(orders):
    """The children of a D = 2 build's root, in the order they open."""
    np1, np2 = ((k + 1) * (k + 2) // 2 for k in orders)
    blocks = -(-np1 // max(1, 128 // np2))
    return (["model.check", "stats.basis", "stats.sort", "stats.series"]
            + ["stats.series", "stats.scan"] * blocks
            + ["stats.series", "stats.scan", "stats.scatter"])


def recorded(fn):
    """fn() under a CPU torch.profiler session: (its result, the roots it
    recorded, the profiler)."""
    clear_spans()
    with torch.profiler.profile() as prof:
        out = fn()
    return out, span_records(), prof


def test_off_records_nothing_and_span_is_one_shared_no_op():
    clear_spans()
    model = build()
    model.posterior().predict_f(query())
    assert span_records() == []
    assert span("a") is span("b", "cpu") is profiling._OFF


@pytest.mark.parametrize("orders", [(4, 4), (2, 3), (2, 4), (5, 5)])
def test_a_build_records_one_root_with_its_phases_in_order(orders):
    _, roots, _ = recorded(lambda: build(orders))
    assert len(roots) == 1
    root, children = roots[0][0], roots[0][1:]
    assert root["name"] == "kron.init" and root["parent"] is None
    assert [s["name"] for s in children] == build_children(orders)
    assert all(s["parent"] == 0 for s in children)
    # check_domain's min and max of each input (4), the parameters (5),
    # each dimension's basis coefficients (2) and n (1)
    assert root["host_syncs"] == 12
    assert root["launches"] == 0 and root["device_allocs"] is None
    assert all(s["device_ms"] is None for s in roots[0])


@pytest.mark.parametrize("batch,chunks", [(None, 1), (200, 3)])
def test_a_prediction_records_its_phases(batch, chunks):
    post = build().posterior()
    _, roots, _ = recorded(lambda: post.predict_f(query(), batch=batch))
    assert len(roots) == 1 and roots[0][0]["name"] == "predict_f"
    assert [s["name"] for s in roots[0][1:]] == (
        ["predict.basis", "predict.mean", "predict.var"] * chunks)
    # each dimension's basis coefficients a chunk, and the padding's centre
    assert roots[0][0]["host_syncs"] == 2 * chunks + (batch is not None)


def test_span_names_appear_among_the_profiler_events():
    def both():
        build().posterior().predict_f(query())

    _, roots, prof = recorded(both)
    names = {e.name for e in prof.events()}
    recorded_names = {s["name"] for spans in roots for s in spans}
    assert {"kron.init", "stats.scatter", "predict_f", "predict.var"} <= recorded_names
    assert recorded_names <= names


def test_results_are_the_same_bits_with_the_profiler_on_and_off():
    def build_and_map():
        model = build()
        return model, model.posterior().predict_f(query(), batch=200)

    off, (mean_off, var_off) = build_and_map()
    (on, (mean_on, var_on)), roots, _ = recorded(build_and_map)
    assert len(roots) == 2
    for name in ("kuf_y", "t_band", "yty", "n"):
        assert torch.equal(getattr(on, name), getattr(off, name)), name
    assert torch.equal(mean_on, mean_off) and torch.equal(var_on, var_off)


def test_children_host_times_sum_to_no_more_than_the_root():
    def both():
        build().posterior().predict_f(query())

    _, roots, _ = recorded(both)
    for spans in roots:
        assert sum(s["host_ms"] for s in spans[1:]) <= spans[0]["host_ms"]
        assert all(s["host_ms"] >= 0 for s in spans)


def test_nested_roots_and_the_cap_on_roots():
    clear_spans()
    with torch.profiler.profile():
        for _ in range(profiling.MAX_ROOTS + 5):
            with span("outer"):
                with span("inner"):
                    pass
    roots = span_records()
    assert len(roots) == profiling.MAX_ROOTS
    assert [(s["name"], s["parent"]) for s in roots[-1]] == [("outer", None), ("inner", 0)]
    clear_spans()
    assert span_records() == []


def test_host_value_and_to_device_count_transfers_only():
    before = profiling._host_syncs
    assert profiling.host_value(torch.tensor(2.5)) == 2.5
    assert profiling.host_value(np.float64(1.5)) == 1.5
    assert profiling._host_syncs == before + 1
    t = profiling.to_device(np.arange(3.0), torch.float64, "cpu")
    assert torch.equal(t, torch.arange(3.0, dtype=torch.float64))
    assert profiling.to_device(t, torch.float64, "cpu") is t
    assert profiling._host_syncs == before + 2


def view(busy_s, items):
    profile = None if busy_s is None else {"busy_s": busy_s, "window_s": 1.0}
    run = SimpleNamespace(config={}, traffic={}, arith=None, spans={}, counters={},
                          profile=profile, profiled_items=items)
    return trace.View(run)


@pytest.mark.parametrize("name", sorted(READERS))
def test_each_reader_reads_none_from_a_cpu_view(name):
    reader = load_module(REPO, "metrics", name)
    _, roots, _ = recorded(lambda: build().posterior().predict_f(query()))
    assert len(roots) == 2
    assert reader.read(view(None, 1)) is None   # no profile
    assert reader.read(view(0.0, 1)) is None    # the device ran nothing


def test_readers_read_the_last_items_roots():
    """With a device profile faked over CPU records: the host-clock and
    counter readers read their roots, the device-time readers find no
    device time, and too few roots read None."""
    def builds():
        for seed in range(3):
            build(data=field(2000, seed))

    _, roots, _ = recorded(builds)
    assert len(roots) == 3
    read = {name: load_module(REPO, "metrics", name).read for name in READERS}
    assert read["stats_host_syncs"](view(0.5, 2)) == 12.0
    want = sum(s["host_ms"] for spans in roots[-2:] for s in spans
               if s["name"] == "stats.scatter") / 2
    assert read["stats_scatter_host_ms"](view(0.5, 2)) == pytest.approx(want)
    for name in ("stats_series_ms", "stats_scan_ms", "stats_device_allocs", "map_var_ms"):
        assert read[name](view(0.5, 2)) is None, name
    assert read["stats_host_syncs"](view(0.5, 4)) is None


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: this checks the spans' device times and syncs")
    return torch.device("cuda", 0)


def warned_syncs(fn):
    """Where in the port (file:line) each synchronisation happens that torch
    reports while fn() runs."""
    found = []

    def show(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" in str(message):
            frames = [f"{Path(f.filename).name}:{f.lineno}" for f in traceback.extract_stack()
                      if "asvgp_tpu_torch" in f.filename]
            found.append(frames[-1] if frames else f"{filename}:{lineno}")

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return found


@pytest.mark.cuda
def test_warned_syncs_are_the_roots_host_syncs(cuda_device):
    """Counted untraced, where no root synchronises to anchor its clock."""
    data = field(200_000, 0, cuda_device)
    post = build(m=100, device=cuda_device, data=data).posterior()
    xq = query(10_000, 2, cuda_device)
    post.predict_f(xq)
    where = [warned_syncs(lambda: build(m=100, device=cuda_device, data=data)),
             warned_syncs(lambda: post.predict_f(xq))]
    clear_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        build(m=100, device=cuda_device, data=data)
        post.predict_f(xq)
    counted = [spans[0]["host_syncs"] for spans in span_records()]
    assert counted == [len(w) for w in where] == [12, 2], where


@pytest.mark.cuda
def test_children_device_times_tile_the_root(cuda_device):
    data = field(2_000_000, 0, cuda_device)
    post = build(m=100, device=cuda_device, data=data).posterior()
    xq = query(1_000_000, 2, cuda_device)
    post.predict_f(xq)
    clear_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        build(m=100, device=cuda_device, data=data)
        post.predict_f(xq)
    roots = span_records()
    assert [spans[0]["name"] for spans in roots] == ["kron.init", "predict_f"]
    for spans in roots:
        root = spans[0]["device_ms"]
        children = sum(s["device_ms"] for s in spans[1:])
        assert children <= root * 1.0001 and children >= 0.97 * root, (spans[0]["name"],
                                                                      children, root)
