"""Faults planted under a run's timed path, to show that the check catches
them: ``with plant(name): run_cell(...)`` must come out not correct.

  half    the statistics built on every other point, then doubled: half of
          the data left out, the mean taken over the rest
  alter   one answer altered where it is produced: a predicted mean or an
          entry of Kuf·y

One chip and no exchange between chips: no cell can leave one out; no cell
steps a state, so none can return it unchanged.
"""

from __future__ import annotations

from contextlib import contextmanager
from unittest import mock

import asvgp_tpu_torch.models.kron as kron_model
from asvgp_tpu_torch.stats.kron import KronStats


def _halved(build):
    def half(bases, X, y, w=None):
        s = build(bases, X[::2], y.reshape(-1)[::2])
        return KronStats(kuf_y=2 * s.kuf_y, t_band=2 * s.t_band, yty=2 * s.yty, n=2 * s.n)
    return half


def _altered_stats(build):
    def altered(bases, X, y, w=None):
        s = build(bases, X, y, w)
        kuf_y = s.kuf_y.clone()
        kuf_y[0] += 1.0
        return KronStats(kuf_y=kuf_y, t_band=s.t_band, yty=s.yty, n=s.n)
    return altered


def _altered_predict(predict):
    def altered(self, x):
        mean, var = predict(self, x)
        mean = mean.clone()
        mean[0] += 1.0
        return mean, var
    return altered


STATS = {"half": _halved, "alter": _altered_stats}
FAULTS = tuple(STATS)


@contextmanager
def plant(name: str):
    """The program with fault ``name`` planted, for the ``with`` block."""
    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}; one of {FAULTS}")
    wrap = STATS[name]
    predict = kron_model.PosteriorKron._predict_chunk
    with mock.patch.multiple(kron_model,
                             compute_kron_stats=wrap(kron_model.compute_kron_stats),
                             compute_kron_stats_nd=wrap(kron_model.compute_kron_stats_nd)), \
            mock.patch.object(kron_model.PosteriorKron, "_predict_chunk",
                              _altered_predict(predict) if name == "alter" else predict):
        yield
