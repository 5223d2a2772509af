"""Metrics (the trainers come with the training slice)."""

from asvgp_tpu_torch.train.metrics import mse, nlpd

__all__ = ["mse", "nlpd"]
