"""Host synchronisations a build (reads of a device value through the
program's ``host_value``), from the program's counter on each root."""

from benchmark.spans import root_count


def read(v):
    return root_count(v, "kron.init", "host_syncs")
