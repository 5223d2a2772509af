"""Host time a build of the accumulation of Kuf·y and the multiband
(``stats.scatter``: some hundreds of slice-adds launched one by one), from
the program's spans: where it exceeds the phase's device time, the host
paces it."""

from benchmark.spans import phase_ms


def read(v):
    return phase_ms(v, "kron.init", "stats.scatter", clock="host_ms")
