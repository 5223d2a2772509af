"""Data parallelism over a ``torch.distributed`` process group: shard the
data, all-reduce the sufficient statistics, step replicated (``dp``); the
per-rank process launcher (``launch``) and the multi-rank dry run
(``dryrun``)."""

from asvgp_tpu_torch.parallel.dp import (
    make_dp_train_step,
    make_dp_train_step_additive,
    make_dp_train_step_kron,
    place,
    shard_data,
)
from asvgp_tpu_torch.parallel.dryrun import dryrun_multirank
from asvgp_tpu_torch.parallel.launch import run_ranks

__all__ = ["make_dp_train_step", "make_dp_train_step_additive", "make_dp_train_step_kron",
           "place", "shard_data", "dryrun_multirank", "run_ranks"]
