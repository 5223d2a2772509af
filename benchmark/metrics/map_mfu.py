"""The map requests' share of the card's FP64 peak: each request's
operations (arith) times the profiled requests over the profiled
window, against 67 TFLOP/s."""

from benchmark.arith.roofline import PEAK_FP64_TC_PER_S


def read(v):
    if v.device_s() is None or not v.items:
        return None
    ops, _ = v.arith.request_work(v.config, int(v.traffic["grid"]) ** 2)
    return 100.0 * ops * v.items / v.profile["window_s"] / PEAK_FP64_TC_PER_S
