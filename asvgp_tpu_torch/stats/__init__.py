"""Sufficient-statistic assembly on the data's device."""

from asvgp_tpu_torch.stats.sufficient import SufficientStats, compute_stats
from asvgp_tpu_torch.stats.kron import KronStats, compute_kron_stats

__all__ = ["SufficientStats", "compute_stats", "KronStats", "compute_kron_stats"]
