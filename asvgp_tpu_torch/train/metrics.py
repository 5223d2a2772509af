"""Benchmark metrics with the reference's definitions.

NLPD = mean negative predictive log density; MSE = mean squared error of the
predictive mean (PyTorch counterpart of asvgp_tpu/train/metrics.py).
"""

from __future__ import annotations

import torch


def mse(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(y_true.reshape(-1) - y_pred.reshape(-1)))


def nlpd(log_densities: torch.Tensor) -> torch.Tensor:
    return -torch.mean(log_densities)
