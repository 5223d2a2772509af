"""Trainers (full-batch L-BFGS, minibatch Adam) and metrics (NLPD, MSE)."""

from asvgp_tpu_torch.train.lbfgs import fit_lbfgs
from asvgp_tpu_torch.train.adam import fit_adam_minibatch
from asvgp_tpu_torch.train.metrics import mse, nlpd

__all__ = ["fit_lbfgs", "fit_adam_minibatch", "mse", "nlpd"]
