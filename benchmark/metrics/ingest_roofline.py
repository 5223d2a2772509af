"""A build's share of its roofline: its least time (arith: X and y read
once, the statistics written once, against its operations) over its
device time."""

from benchmark.arith.roofline import bound


def read(v):
    busy = v.device_s()
    if not busy or not v.items:
        return None
    ops, nbytes = v.arith.stats_work(v.config, int(v.config["n_train"]))
    return 100.0 * bound(ops, nbytes)["bound_s"] / (busy / v.items)
