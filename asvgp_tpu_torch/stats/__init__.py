"""Sufficient-statistic assembly on the data's device, and its
data-parallel form (each rank's shard, one ``all_reduce``)."""

from asvgp_tpu_torch.stats.sufficient import (
    SufficientStats,
    all_reduce_stats,
    compute_stats,
    compute_stats_sharded,
    compute_stats_sharded_masked,
    kuf_matvec,
    kufkfu_band,
    pad_for_sharding,
)
from asvgp_tpu_torch.stats.kron import KronStats, compute_kron_stats, compute_kron_stats_sharded
from asvgp_tpu_torch.stats.kron_nd import (
    compute_kron_stats_nd,
    compute_kron_stats_nd_sharded,
    t_band_to_blocks_nd,
    t_band_trace_against_kron_nd,
)
from asvgp_tpu_torch.stats.additive import (
    AdditiveStats,
    compute_additive_stats,
    compute_additive_stats_sharded,
)

__all__ = ["SufficientStats", "all_reduce_stats", "compute_stats", "compute_stats_sharded",
           "compute_stats_sharded_masked", "pad_for_sharding", "kuf_matvec", "kufkfu_band",
           "KronStats", "compute_kron_stats", "compute_kron_stats_sharded",
           "compute_kron_stats_nd", "compute_kron_stats_nd_sharded",
           "t_band_trace_against_kron_nd", "t_band_to_blocks_nd",
           "AdditiveStats", "compute_additive_stats", "compute_additive_stats_sharded"]
