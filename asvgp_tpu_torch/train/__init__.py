"""Trainers (full-batch L-BFGS, minibatch Adam, optax's Adam as a functional
optimizer for the data-parallel steps), metrics (NLPD, MSE) and
checkpoints of parameter pytrees in the JAX package's file format."""

from asvgp_tpu_torch.train.checkpoint import load_pytree, save_pytree
from asvgp_tpu_torch.train.lbfgs import fit_lbfgs
from asvgp_tpu_torch.train.adam import Adam, fit_adam_minibatch
from asvgp_tpu_torch.train.metrics import mse, nlpd

__all__ = ["fit_lbfgs", "Adam", "fit_adam_minibatch", "mse", "nlpd", "save_pytree",
           "load_pytree"]
