"""Trainers (full-batch L-BFGS, minibatch Adam, optax's Adam as a functional
optimizer for the data-parallel steps) and metrics (NLPD, MSE)."""

from asvgp_tpu_torch.train.lbfgs import fit_lbfgs
from asvgp_tpu_torch.train.adam import Adam, fit_adam_minibatch
from asvgp_tpu_torch.train.metrics import mse, nlpd

__all__ = ["fit_lbfgs", "Adam", "fit_adam_minibatch", "mse", "nlpd"]
