"""The port's sufficient statistics against the JAX package's.

Both sort the points by cell (stably) and take cumsums with boundary
differences, so the sums run in the same order; they are held to 1e-12
relative to each statistic's largest entry, room for the two libraries'
cumsum implementations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asvgp_tpu.basis import BSplineBasis as JBasis
from asvgp_tpu.stats.sufficient import compute_stats as jcompute_stats
from asvgp_tpu.stats.sufficient import kufkfu_band as jkufkfu_band
from asvgp_tpu.stats.sufficient import kuf_matvec as jkuf_matvec
from asvgp_tpu_torch.basis import BSplineBasis
from asvgp_tpu_torch.stats import SufficientStats, compute_stats, kuf_matvec, kufkfu_band
from asvgp_tpu_torch.stats.sufficient import _prefix_sums


# one jitted program per shape: far quicker than JAX's op-by-op dispatch
_jstats = jax.jit(jcompute_stats, static_argnums=0)


@jax.jit
def _jscatter(x, y):
    vals, start = JBasis(0.0, 1.0, 30, 3).evaluate_basis(x)
    return jkuf_matvec(vals, start, y, 30), jkufkfu_band(vals, start, 30)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12 * max(np.abs(want).max(), 1e-300))


@pytest.mark.parametrize("order", [1, 3, 6])
@pytest.mark.parametrize("n,m", [(50, 40), (3000, 64), (20000, 500)])
def test_compute_stats_matches_jax(order, n, m):
    rng = np.random.RandomState(n + order)
    x = rng.uniform(0.005, 0.995, n)
    y = np.sin(40.0 * x) + 0.3 * rng.randn(n)
    got = compute_stats(BSplineBasis(0.0, 1.0, m, order), torch.from_numpy(x), torch.from_numpy(y))
    want = _jstats(JBasis(0.0, 1.0, m, order), jnp.asarray(x), jnp.asarray(y))
    assert isinstance(got, SufficientStats)
    assert got.kufkfu_band.shape == (order + 1, m) and got.kuf_y.shape == (m,)
    for t in (got.kuf_y, got.kufkfu_band, got.yty, got.n):
        assert t.dtype == torch.float64
    _close(got.kuf_y, want.kuf_y)
    _close(got.kufkfu_band, want.kufkfu_band)
    _close(got.yty, want.yty)
    assert got.n.item() == float(n)


def test_stats_equal_scatter_form_and_empty_cells():
    # points in a few cells only: empty cells must give zero sums
    basis = BSplineBasis(0.0, 1.0, 30, 3)
    rng = np.random.RandomState(7)
    x = np.concatenate([rng.uniform(0.1, 0.12, 40), rng.uniform(0.7, 0.71, 25)])
    y = rng.randn(x.shape[0])
    got = compute_stats(basis, torch.from_numpy(x), torch.from_numpy(y))
    want_kuf_y, want_band = _jscatter(jnp.asarray(x), jnp.asarray(y))
    _close(got.kuf_y, want_kuf_y)
    _close(got.kufkfu_band, want_band)


@pytest.mark.parametrize("n", [1, 5, 1023, 1024, 1025, 4096, 70001])
def test_prefix_sums(n):
    v = np.random.RandomState(n).randn(3, n)
    got = _prefix_sums(torch.from_numpy(v))
    want = np.concatenate([np.zeros((3, 1)), np.cumsum(v, axis=1)], axis=1)
    assert got.shape == (3, n + 1)
    # two-level order of summation: a few ulps of the running magnitude
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-13 * np.abs(v).sum())


@pytest.mark.parametrize("order", [1, 3])
def test_kuf_matvec_and_kufkfu_band_match_jax(order):
    """The public structured-Kuf products against the JAX package's
    scatter-add forms, on points that leave cells empty."""
    rng = np.random.RandomState(order)
    x = np.concatenate([rng.uniform(0.05, 0.3, 70), rng.uniform(0.6, 0.95, 50)])
    y = rng.randn(x.shape[0])
    m = 30
    vals, start = BSplineBasis(0.0, 1.0, m, order).evaluate_basis(torch.from_numpy(x))
    jvals, jstart = JBasis(0.0, 1.0, m, order).evaluate_basis(jnp.asarray(x))
    got_y = kuf_matvec(vals, start, torch.from_numpy(y), m)
    got_band = kufkfu_band(vals, start, m)
    assert got_y.shape == (m,) and got_band.shape == (order + 1, m)
    _close(got_y, jkuf_matvec(jvals, jstart, jnp.asarray(y), m))
    _close(got_band, jkufkfu_band(jvals, jstart, m))
