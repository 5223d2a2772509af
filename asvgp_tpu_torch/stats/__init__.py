"""Sufficient-statistic assembly on the data's device."""

from asvgp_tpu_torch.stats.sufficient import SufficientStats, compute_stats

__all__ = ["SufficientStats", "compute_stats"]
