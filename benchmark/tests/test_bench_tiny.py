"""The harness end to end on the CPU at tiny sizes, through the program's
plain versions: cells added in a temporary root as new files and entries
run and prove correct; the control (the reference in float32 in the
program's place) and every planted fault come out not correct."""

import io
import json
from contextlib import redirect_stdout

import pytest
import torch

from benchmark import core, faults
from benchmark.core import Bench, run_cell
from benchmark.tests.tiny import TINY_CELLS, make_root

SEED = 2 ** 31 + 11
FAULTS = {"tiny_2d.map": ("half", "alter"), "tiny_3d.map": ("half", "alter"),
          "tiny_2d.ingest": ("half", "alter"), "tiny_3d.ingest": ("half", "alter")}


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return Bench(make_root(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_added_cell_runs_and_agrees_with_the_reference(bench, cell):
    result, checks = run_cell(bench, cell, SEED, 0.2, False, "cpu")
    assert result["correct"], checks
    assert result["attempted"] >= 1 and result["failed"] == 0
    want = {m["name"] for m in bench.end_to_end(cell)}
    assert set(result["metrics"]) == want
    assert all(v["value"] > 0 for v in result["metrics"].values())


@pytest.mark.parametrize("cell", ["tiny_2d.map", "tiny_2d.ingest"])
def test_traced_run_is_checked_alike(bench, cell):
    result, checks = run_cell(bench, cell, SEED + 1, 0.2, True, "cpu")
    assert result["correct"], checks
    # no device ran: no device metric is reported from the CPU
    assert result["metrics"] == {}
    assert result["device"]["busy_s"] == 0.0 and len(result["breakdown"]["idle_gaps"]) <= 10


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_control_is_not_correct(bench, cell):
    result, checks = run_cell(bench, cell, SEED + 2, 0.1, False, "cpu", control=True)
    assert not result["correct"], checks


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in sorted(FAULTS.items()) for f in fs])
def test_planted_fault_is_not_correct(bench, cell, fault):
    with faults.plant(fault):
        result, checks = run_cell(bench, cell, SEED + 3, 0.1, False, "cpu")
    assert not result["correct"], (fault, checks)


def test_a_map_request_at_one_dimension_is_a_line():
    from types import SimpleNamespace

    from benchmark.entries.map import request

    run = SimpleNamespace(traffic={"grid": 4, "lo": 0.1, "hi": 0.9}, config={"dims": [{}]},
                          device=torch.device("cpu"))
    x = request(run, torch.tensor([0.5], dtype=torch.float64))
    assert x.shape == (16, 1)
    assert torch.all(x[1:] > x[:-1]) and 0.1 < float(x.min()) and float(x.max()) < 0.9


def test_same_seed_same_inputs(bench):
    run = core.Run(bench, "tiny_2d.map", SEED, 0.1, False, "cpu")
    a, b = run.data(stream=0), run.data(stream=0)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], core.Run(bench, "tiny_2d.map", SEED + 1, 0.1, False,
                                          "cpu").data(stream=0)[0])


def test_import_guard_passes_a_clean_run_and_trips_on_jax():
    result = {"correct": True, "attempted": 1, "failed": 0, "metrics": {}, "device": {}}
    checks = {"mean": {"value": 0.0, "limit": 1e-9}}
    out = io.StringIO()
    with redirect_stdout(out):
        assert core.finish(dict(result), checks, ["torch", "numpy", "asvgp_tpu_torch.models"]) == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    out = io.StringIO()
    with redirect_stdout(out):
        assert core.finish(dict(result), checks, ["torch", "jax.numpy"]) != 0
    assert out.getvalue() == ""
    assert core.forbidden_modules(["jaxlib.xla", "asvgp_tpu", "asvgp_tpu_torch", "jaxtyping",
                                   "flax.linen"]) == ["asvgp_tpu", "flax", "jaxlib"]
