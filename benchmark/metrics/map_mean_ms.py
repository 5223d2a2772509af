"""Device time a request of the mean (``predict.mean``: the gather from
the posterior weights and its einsum), from the program's spans."""

from benchmark.spans import phase_ms


def read(v):
    return phase_ms(v, "predict_f", "predict.mean")
