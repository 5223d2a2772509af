"""Device time a build of the fixed-order prefix sums and cell boundary
differences (``stats.scan``, once a block), from the program's spans."""

from benchmark.spans import phase_ms


def read(v):
    return phase_ms(v, "kron.init", "stats.scan")
