"""Gaussian likelihood (PyTorch counterpart of asvgp_tpu/models/likelihoods.py)."""

from __future__ import annotations

import math

import torch

from asvgp_tpu_torch.models.kernels import as_float

_LOG2PI = math.log(2.0 * math.pi)


class Gaussian:
    def __init__(self, variance=1.0):
        self.variance = as_float(variance)

    def predict_log_density(self, f_mean, f_var, y):
        """log N(y | f_mean, f_var + σ²) — the NLPD integrand."""
        v = f_var + self.variance
        return -0.5 * (_LOG2PI + torch.log(v) + (y - f_mean) ** 2 / v)

    def predict_mean_and_var(self, f_mean, f_var):
        return f_mean, f_var + self.variance
