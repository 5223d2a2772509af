"""Device time a request of the basis (``predict.basis``: Kuf per
dimension, the windows, Kuu⁻¹'s quadratic forms), from the program's
spans."""

from benchmark.spans import phase_ms


def read(v):
    return phase_ms(v, "predict_f", "predict.basis")
