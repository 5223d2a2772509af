"""Device time a build of the series products (``stats.series``: the pair
products, each block's series, the concatenation of the grid), from the
program's spans."""

from benchmark.spans import phase_ms


def read(v):
    return phase_ms(v, "kron.init", "stats.series")
