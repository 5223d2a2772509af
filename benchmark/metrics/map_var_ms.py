"""Device time a request of the variance (``predict.var``: the gathers
from P⁻¹'s block band and their einsums), from the program's spans."""

from benchmark.spans import phase_ms


def read(v):
    return phase_ms(v, "predict_f", "predict.var")
