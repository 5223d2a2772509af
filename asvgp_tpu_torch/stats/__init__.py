"""Sufficient-statistic assembly on the data's device."""

from asvgp_tpu_torch.stats.sufficient import SufficientStats, compute_stats
from asvgp_tpu_torch.stats.kron import KronStats, compute_kron_stats
from asvgp_tpu_torch.stats.additive import AdditiveStats, compute_additive_stats

__all__ = ["SufficientStats", "compute_stats", "KronStats", "compute_kron_stats",
           "AdditiveStats", "compute_additive_stats"]
