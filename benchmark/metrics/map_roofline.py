"""A request's share of its roofline: its least time (arith: its points
and the posterior's reachable entries read once, mean and variance
written once, against its operations) over its device time."""

from benchmark.arith.roofline import bound


def read(v):
    busy = v.device_s()
    if not busy or not v.items:
        return None
    ops, nbytes = v.arith.request_work(v.config, int(v.traffic["grid"]) ** 2)
    return 100.0 * bound(ops, nbytes)["bound_s"] / (busy / v.items)
