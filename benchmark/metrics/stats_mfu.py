"""The builds' share of the card's FP64 peak: each build's operations
(arith) times the profiled builds over the profiled window, against
67 TFLOP/s."""

from benchmark.arith.roofline import PEAK_FP64_TC_PER_S


def read(v):
    if v.device_s() is None or not v.items:
        return None
    ops, _ = v.arith.stats_work(v.config, int(v.config["n_train"]))
    return 100.0 * ops * v.items / v.profile["window_s"] / PEAK_FP64_TC_PER_S
