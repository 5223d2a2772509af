"""Sufficient-statistic assembly on the data's device."""

from asvgp_tpu_torch.stats.sufficient import (
    SufficientStats,
    compute_stats,
    kuf_matvec,
    kufkfu_band,
)
from asvgp_tpu_torch.stats.kron import KronStats, compute_kron_stats
from asvgp_tpu_torch.stats.kron_nd import (
    compute_kron_stats_nd,
    t_band_to_blocks_nd,
    t_band_trace_against_kron_nd,
)
from asvgp_tpu_torch.stats.additive import AdditiveStats, compute_additive_stats

__all__ = ["SufficientStats", "compute_stats", "kuf_matvec", "kufkfu_band",
           "KronStats", "compute_kron_stats", "compute_kron_stats_nd",
           "t_band_trace_against_kron_nd", "t_band_to_blocks_nd",
           "AdditiveStats", "compute_additive_stats"]
