"""The port's metrics logging (train/logging.py) against the JAX package's:
the same rows in memory and in the JSONL file, and the same wall-clock
summary; on the CPU ``WallClock`` synchronises nothing."""

import json

import numpy as np
import torch

from asvgp_tpu.train.logging import MetricsLogger as JMetricsLogger
from asvgp_tpu.train.logging import WallClock as JWallClock
from asvgp_tpu_torch.train.logging import MetricsLogger, WallClock


def test_metrics_logger_rows_match_jax(tmp_path):
    metrics = {"loss": torch.tensor(1.25, dtype=torch.float64), "iters": 3, "note": "ok",
               "lr": np.float32(0.5)}
    rows = {}
    for name, cls in (("port", MetricsLogger), ("jax", JMetricsLogger)):
        logger = cls(str(tmp_path / f"{name}.jsonl"))
        logger.log(0, **metrics)
        logger.log(1, loss=0.5)
        logger.close()
        logger.close()
        lines = (tmp_path / f"{name}.jsonl").read_text().splitlines()
        assert [json.loads(line) for line in lines] == logger.rows
        rows[name] = [{k: v for k, v in r.items() if k != "time"} for r in logger.rows]
    assert rows["port"] == rows["jax"]
    assert rows["port"][0] == {"step": 0, "loss": 1.25, "iters": 3.0, "note": "ok", "lr": 0.5}
    assert MetricsLogger().log(2, x=1.0)["x"] == 1.0


def test_wall_clock_sums_sections_like_jax():
    clock, jclock = WallClock("cpu"), JWallClock()
    for c in (clock, jclock):
        for name in ("precompute", "optimize", "precompute"):
            with c.section(name):
                sum(range(1000))
    summary, jsummary = clock.summary(), jclock.summary()
    assert set(summary) == set(jsummary) == {"precompute", "optimize", "total"}
    assert summary["total"] == summary["precompute"] + summary["optimize"]
    assert all(v >= 0.0 for v in summary.values())
    assert WallClock().device is None
