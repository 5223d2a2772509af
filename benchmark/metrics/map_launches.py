"""Launches of the port's hand-written kernels a request (``core.LAUNCHES``
over the ``predict_f`` root), from the program's counter."""

from benchmark.spans import root_count


def read(v):
    return root_count(v, "predict_f", "launches")
