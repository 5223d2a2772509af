"""BENCHMARK.json and the files it names: the contract's characters and
limits, and every cell's files found by name."""

import ast
import json
import re
from pathlib import Path

import pytest

from benchmark.core import Bench, forbidden_modules, load_module

REPO = Path(__file__).resolve().parents[2]
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert SPEC["paths"] == ["benchmark"]
    assert all(_line(w) for w in SPEC["command"]) and len(SPEC["command"]) <= 32


@pytest.mark.parametrize("kind,items", [("config", SPEC["configs"]),
                                        ("workload", SPEC["workloads"]),
                                        ("end_to_end", SPEC["end_to_end"]),
                                        ("per_layer", SPEC["per_layer"])])
def test_entries_names_and_keys(kind, items):
    names = [x["name"] for x in items]
    assert len(names) == len(set(names))
    for x in items:
        assert NAME.match(x["name"]), x["name"]
        extra = set(x) - KEYS[kind] - ({"workloads"} if kind in ("end_to_end", "per_layer")
                                       else set())
        assert KEYS[kind] <= set(x) and not extra, (x["name"], extra)
        if "unit" in x:
            assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
        for key in ("why", "layer") + (("source",) if kind == "config" else ()):
            if key in x:
                assert _line(x[key]), (x["name"], key)


def test_metric_rules():
    names = {m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]}
    assert len(names) == len(SPEC["end_to_end"]) + len(SPEC["per_layer"])
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", [])) <= cells
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_setup_another_metric_and_a_layer():
    bench = Bench(REPO)
    for cell in SPEC["workloads"]:
        e2e = {m["name"] for m in bench.end_to_end(cell["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert bench.per_layer(cell["name"])
        assert cell["chips"] in (1, 4)
        for m in bench.per_layer(cell["name"]):
            assert m["moves"] in e2e


def test_every_file_resolves_by_name():
    bench = Bench(REPO)
    used = set()
    for cell in SPEC["workloads"]:
        cfg = bench.config(cell["config"])
        used.add(cell["config"])
        assert cfg["name"] == cell["config"]
        mix = bench.traffic(cell["traffic"])
        for kind, name in (("families", cfg["family"]), ("arith", cfg["family"]),
                           ("data", cfg["data"]), ("entries", mix["entry"])):
            load_module(REPO, kind, name)
        assert bench.limits(cell["name"])
        for m in bench.per_layer(cell["name"]):
            assert callable(load_module(REPO, "metrics", m["name"]).read)
    assert used == {c["name"] for c in SPEC["configs"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files)) and all(f.startswith("benchmark/") for f in files)


def test_configs_state_their_cuts():
    for c in SPEC["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and "assumed" in cfg
        assert cfg["source"] == c["source"]


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module)
    return out


def test_reference_imports_nothing_of_the_program():
    for path in (REPO / "benchmark" / "reference").glob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert tops <= {"__future__", "itertools", "math", "fractions", "functools", "numpy",
                        "torch", "benchmark"}, (path.name, tops)
        assert not {n for n in _imports(path) if n.startswith("benchmark.")
                    and not n.startswith("benchmark.reference")}, path.name


def test_loops_reach_the_model_and_reference_only_through_the_family():
    for path in (REPO / "benchmark" / "entries").glob("*.py"):
        tops = {n for n in _imports(path)
                if n.startswith(("benchmark.reference", "benchmark.families", "asvgp_tpu_torch"))}
        assert not tops, (path.name, tops)


def test_no_file_of_the_benchmark_imports_jax():
    for path in (REPO / "benchmark").rglob("*.py"):
        assert not forbidden_modules(_imports(path)), path
