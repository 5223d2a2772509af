"""A tiny copy of the benchmark for the CPU tests: the benchmark's files in
a temporary root, with small configurations, a data generator, mixes and
cells added as new files and entries only."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

# a config: its base, its size, and at D = 3 a third dimension like the
# base's first, with data of its own
TINY_CONFIGS = {
    "tiny_2d": {"base": "enatl60_2d", "n_train": 3000, "m": 12, "D": 2},
    "tiny_3d": {"base": "enatl60_2d", "n_train": 3000, "m": 8, "D": 3, "order": 3,
                "data": "tiny_field3d"},
}
TINY_TRAFFIC = {
    "tiny_map": {"base": "map", "grid": 24, "trace_items": 2},
    "tiny_ingest": {"base": "ingest", "pool": 2, "trace_items": 2},
}
# cell -> (config, traffic, the real cell whose limits it takes)
TINY_CELLS = {
    "tiny_2d.map": ("tiny_2d", "tiny_map", "enatl60_2d.map"),
    "tiny_2d.ingest": ("tiny_2d", "tiny_ingest", "enatl60_2d.ingest"),
    "tiny_3d.map": ("tiny_3d", "tiny_map", "enatl60_2d.map"),
    "tiny_3d.ingest": ("tiny_3d", "tiny_ingest", "enatl60_2d.ingest"),
}
TINY_DATA = {"tiny_field3d": '''"""A smooth 3-D field for the CPU tests, drawn on the device."""

import torch


def make(n, gen, dtype=torch.float64):
    X = 0.02 + 0.96 * torch.rand((n, 3), generator=gen, dtype=dtype, device=gen.device)
    f = torch.sin(9 * X[:, 0] + 3 * X[:, 1]) * torch.cos(4 * X[:, 2])
    return X, f + 0.1 * torch.randn(n, generator=gen, dtype=dtype, device=gen.device)
'''}


def make_root(tmp: Path) -> Path:
    """A root holding BENCHMARK.json and benchmark/ as committed, plus the
    tiny configs, data, mixes, limits and cells: new files and new entries
    only."""
    root = Path(tmp) / "root"
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    b = root / "benchmark"
    for name, text in TINY_DATA.items():
        (b / "data" / f"{name}.py").write_text(text)
    for name, t in TINY_CONFIGS.items():
        cfg = json.loads((b / "configs" / f"{t['base']}.json").read_text())
        cfg["name"], cfg["n_train"] = name, t["n_train"]
        cfg["data"] = t.get("data", cfg["data"])
        cfg["dims"] = [dict(cfg["dims"][0]) for _ in range(t["D"])]
        for d in cfg["dims"]:
            d["m"], d["order"] = t["m"], t.get("order", d["order"])
        (b / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        spec["configs"].append({"name": name, "source": "https://arxiv.org/abs/2304.05091",
                                "file": f"benchmark/configs/{name}.json",
                                "reduced": ["n_train", "dims"], "why": "a CPU test size"})
    for name, t in TINY_TRAFFIC.items():
        mix = json.loads((b / "traffic" / f"{t['base']}.json").read_text())
        mix.update({k: v for k, v in t.items() if k != "base"})
        (b / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    for cell, (cfg, mix, real) in TINY_CELLS.items():
        shutil.copy(b / "limits" / f"{real}.json", b / "limits" / f"{cell}.json")
        spec["workloads"].append({"name": cell, "config": cfg, "traffic": mix, "chips": 1,
                                  "why": "a CPU test size"})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if real in m.get("workloads", []):
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root
