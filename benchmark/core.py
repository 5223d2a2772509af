"""The harness: finds a cell's files by name, runs its set-up, its measured
window and the check of its outputs, and prints the result line.

Everything that belongs to one configuration, model family, traffic mix,
per-layer metric or cell lives in a file of its own under the benchmark's
directory, found by the name that ``BENCHMARK.json`` gives:

  configs/<config>.json     sizes, hyperparameters, data generator, family
  families/<family>.py      the program's model from a config, and its plain
                            reference (reference/) and comparison
  data/<data>.py            the config's training data, drawn from the seed
  arith/<family>.py         the family's operations and bytes
  traffic/<traffic>.json    a mix's parameters; its "entry" names the loop
  entries/<entry>.py        the loop a mix drives: set-up, window, check
  metrics/<metric>.py       one reader per per-layer metric
  limits/<cell>.json        the limit of each number the check compares
"""

from __future__ import annotations

import gc
import importlib.util
import json
import random
import subprocess
import sys
import time
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path

import torch

from benchmark import trace as trace_mod

FORBIDDEN = ("jax", "jaxlib", "flax", "asvgp_tpu")


def forbidden_modules(modules) -> list:
    """The forbidden top-level names among ``modules`` (names compared whole,
    up to the first dot)."""
    return sorted({name.split(".")[0] for name in modules} & set(FORBIDDEN))


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(root: Path, kind: str, name: str):
    """benchmark/<kind>/<name>.py under ``root``, imported from its path."""
    path = Path(root) / "benchmark" / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1] if kind.endswith('s') else kind} named {name!r}: "
                                f"{path} is missing")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Bench:
    """BENCHMARK.json under ``root`` and the files it names."""

    def __init__(self, root):
        self.root = Path(root)
        self.spec = read_json(self.root / "BENCHMARK.json")

    def cell(self, name: str) -> dict:
        for cell in self.spec["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for cfg in self.spec["configs"]:
            if cfg["name"] == name:
                return read_json(self.root / cfg["file"])
        raise KeyError(f"no config named {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return read_json(self.root / "benchmark" / "traffic" / f"{name}.json")

    def limits(self, cell: str) -> dict:
        return read_json(self.root / "benchmark" / "limits" / f"{cell}.json")

    def end_to_end(self, cell: str) -> list:
        return [m for m in self.spec["end_to_end"] if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list:
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.spec["per_layer"]
                if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one use (``stream``) of the run's seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + stream) % (2 ** 63 - 1))
    return gen


class Sample:
    """A uniform sample of ``k`` of the window's items, drawn from the seed
    (reservoir sampling): ``offer(make)`` builds the kept record only when
    the item is kept."""

    def __init__(self, k: int, seed: int):
        self.k, self.items, self.seen = k, [], 0
        self.rng = random.Random(int(seed) * 7 + 3)

    def offer(self, make) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(make())
            return
        j = self.rng.randrange(self.seen)
        if j < self.k:
            self.items[j] = make()


class Run:
    """One run of one cell: its files, seed, window length, device, and
    what the window records (spans, counters, the profiled part)."""

    def __init__(self, bench: Bench, cell: str, seed: int, seconds: float, trace: bool, device):
        self.bench = bench
        self.root = bench.root
        self.cell = bench.cell(cell)
        self.config = bench.config(self.cell["config"])
        self.traffic = bench.traffic(self.cell["traffic"])
        self.family = load_module(self.root, "families", self.config["family"])
        self.arith = load_module(self.root, "arith", self.config["family"])
        self.entry = load_module(self.root, "entries", self.traffic["entry"])
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.device = torch.device(device)
        self.spans = defaultdict(list)
        self.counters = defaultdict(list)
        self._profiler = None
        self.profile = None
        self.profiled_items = 0
        self.phases = []

    def mark(self, name: str) -> None:
        """The end of a phase of set-up, synchronised: its name and time."""
        self.sync()
        self.phases.append((name, time.perf_counter()))

    def gen(self, stream: int, device=None) -> torch.Generator:
        return generator(self.seed, stream, self.device if device is None else device)

    def data(self, stream: int, n: int | None = None) -> tuple:
        """(X, y) of the config's data generator, ``n`` points (default: the
        config's ``n_train``) on the run's device, from the seed."""
        make = load_module(self.root, "data", self.config["data"]).make
        return make(int(n or self.config["n_train"]), self.gen(stream))

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextmanager
    def item(self, i: int):
        """Around the window's i-th item: a traced run profiles the first
        ``trace_items`` of them."""
        n = int(self.traffic.get("trace_items", 1))
        if self.trace and i == 0:
            self._profiler = trace_mod.Profiled(self.device)
            self._profiler.start()
        yield
        if self._profiler is not None and i == n - 1:
            self.end_profile(i + 1)

    def end_profile(self, items: int) -> None:
        if self._profiler is not None:
            self._profiler.stop()
            self.profile = self._profiler.reduce()
            self.profiled_items = items
            self._profiler = None


def device_kind(device) -> dict:
    device = torch.device(device)
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}
    return {"platform": "cpu", "kind": "cpu", "count": 1}


def power_line() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi: {exc}"


def judge(checks: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit, and finite; a number without a limit fails."""
    out, ok = {}, True
    for name, value in checks.items():
        limit = limits.get(name)
        out[name] = {"value": value, "limit": limit}
        if limit is None or not (value == value) or value > limit:
            ok = False
    return ok, out


def run_cell(bench: Bench, cell: str, seed: int, seconds: float, trace: bool, device,
             t_start: float | None = None, control: bool = False) -> tuple:
    """Set-up, window and check of one cell.  Returns (result, checks): the
    result line's object and the numbers compared, each with its limit.
    ``control`` puts the reference, computed in float32, in the program's
    place for the check."""
    t_start = time.perf_counter() if t_start is None else t_start
    run = Run(bench, cell, seed, seconds, trace, device)
    run.phases.append(("imports", time.perf_counter()))
    if run.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(run.device)
        torch.zeros(1, device=run.device)
    run.mark("context")
    state = run.entry.setup(run)
    run.mark("warm-up")
    setup_s = time.perf_counter() - t_start
    steps, t = [], t_start
    for name, t1 in run.phases:
        steps.append(f"{name} {t1 - t:.3f}")
        t = t1
    print(f"setup_s {setup_s:.3f}: " + ", ".join(steps), file=sys.stderr, flush=True)
    # no collection pauses inside the window: what set-up made is frozen
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        window = run.entry.window(run, state)
    finally:
        gc.enable()
        gc.unfreeze()
    run.end_profile(run.profiled_items or window["attempted"])
    run.sync()
    dev = device_kind(run.device)
    dev["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(run.device)
                                if run.device.type == "cuda" else 0)
    metrics = {}
    if trace:
        view = trace_mod.View(run)
        if run.profile is not None:
            dev["busy_s"] = run.profile["busy_s"]
            dev["window_s"] = run.profile["window_s"]
        for m in bench.per_layer(cell):
            reader = load_module(run.root, "metrics", m["name"])
            value = reader.read(view)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        e2e = dict(window["e2e"], setup_s=setup_s)
        for m in bench.end_to_end(cell):
            metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}
    # the check runs once the window's state is freed and the peak read
    run.entry.release(state)
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    ref = run.entry.reference(run, state, torch.float64)
    got = run.entry.reference(run, state, torch.float32) if control else run.entry.outputs(state)
    correct, checks = judge(run.entry.compare(run, got, ref), bench.limits(cell))
    result = {"correct": bool(correct and window["failed"] == 0),
              "attempted": int(window["attempted"]), "failed": int(window["failed"]),
              "metrics": metrics, "device": dev,
              "check_s": time.perf_counter() - t_check}
    if trace and run.profile is not None:
        result["breakdown"] = {"device_ops": run.profile["top_ops"],
                               "idle_gaps": run.profile["idle_gaps"]}
    return result, checks


def main(argv=None, root: Path | None = None, t_start: float | None = None) -> int:
    """The command line: one run of one cell, its result on the last line."""
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="Run one cell of the benchmark on the card.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = Bench(root or Path.cwd())
    chips = bench.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"need {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result",
              file=sys.stderr)
        return 2
    print(f"card: {power_line()}", file=sys.stderr, flush=True)
    result, checks = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                              "cuda", t_start=t_start)
    return finish(result, checks, list(sys.modules))


def finish(result: dict, checks: dict, modules) -> int:
    """Print the checks, then the result line, unless a forbidden module
    was loaded: then print no result and fail."""
    found = forbidden_modules(modules)
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}: no result", file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    return 0
