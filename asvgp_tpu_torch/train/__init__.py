"""Trainers (full-batch L-BFGS) and metrics (NLPD, MSE)."""

from asvgp_tpu_torch.train.lbfgs import fit_lbfgs
from asvgp_tpu_torch.train.metrics import mse, nlpd

__all__ = ["fit_lbfgs", "mse", "nlpd"]
