"""The port's wall clock (train/logging.py) against the JAX package's: the
same summary; on the CPU ``WallClock`` synchronises nothing."""

from asvgp_tpu.train.logging import WallClock as JWallClock
from asvgp_tpu_torch.train.logging import WallClock


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
