"""Data parallelism in the port (parallel/, the sharded statistics of every
family, the models' ``group=``) on 8 gloo ranks on the CPU, against the
port's unsharded builds and the JAX package on 8 virtual devices.

One spawn of 8 ranks serves the whole file (``parallel.dryrun.parity_rank``,
a module-scoped fixture): it returns every family's numbers and the tests
compare them.  The bars (PERF.md §2):

- the statistics of GPR1D, GPRKron at D = 2 and D = 3 and GPRAdditive,
  padded with ``pad_for_sharding`` and masked at an N that 8 does not
  divide, against the port's unsharded build and the JAX package's sharded
  build: each statistic's sum, sum of squares and random projection within
  1e-10 of the sum of the absolute terms it is made of, and its largest
  difference within 1e-10 of its largest entry (an entry is a difference
  of prefix sums, so its own rounding scales with the sums before it, not
  with the entry); every rank holds the same sum;
- a group of one rank: the sharded statistics and the data-parallel step's
  loss equal bit for bit to the same build or step without the
  ``all_reduce``;
- two full-batch data-parallel Adam steps (``num_data_total = N``) of each
  family (GPRKron at D = 2 and D = 3) from ``init_params()`` against the
  JAX package's data-parallel step on the 8-device mesh, and at D = 3 also
  against the port's step on one process: losses within 1e-9, the
  parameters after two steps within 1e-8, relative;
- ``fit_lbfgs`` of a GPR1D built with ``group=`` on each rank's shard
  against the unsharded model (tests/test_dp_protocol.py for JAX): loss
  within 1e-8 relative in the same iteration count;
- the dry run's two steps a family: finite and the same on every rank.

The spawned children must not import JAX (tests/test_torch_no_jax.py reads
the sources; here each child reports ``"jax" in sys.modules``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from asvgp_tpu.basis import B3Spline as JB3
from asvgp_tpu.basis import BSplineBasis as JBasis
from asvgp_tpu.models import Matern32 as JMatern32
from asvgp_tpu.models.gpr1d import default_params as jdefault_params
from asvgp_tpu.parallel import (
    make_dp_train_step as jmake_step,
    make_dp_train_step_additive as jmake_step_additive,
    make_dp_train_step_kron as jmake_step_kron,
    shard_data as jshard_data,
)
from asvgp_tpu.stats.additive import _additive_stats_local
from asvgp_tpu.stats.kron import _kron_stats_local
from asvgp_tpu.stats.kron_nd import _kron_stats_local_nd
from asvgp_tpu.stats.sufficient import _stats_local, _unmesh
from asvgp_tpu_torch.basis import B3Spline, BSplineBasis
from asvgp_tpu_torch.models import GPR1D, Matern32
from asvgp_tpu_torch.models.gpr1d import default_params
from asvgp_tpu_torch.parallel import make_dp_train_step_kron, run_ranks
from asvgp_tpu_torch.parallel.dryrun import parity_rank
from asvgp_tpu_torch.stats import (
    compute_additive_stats,
    compute_kron_stats,
    compute_kron_stats_nd,
    compute_stats,
    pad_for_sharding,
)
from asvgp_tpu_torch.train import fit_lbfgs

WORLD = 8
TOL_STATS = 1e-10
TOL_LOSS, TOL_PARAMS, TOL_FIT = 1e-9, 1e-8, 1e-8


def data(n, d, seed):
    rng = np.random.RandomState(seed)
    X = rng.uniform(0.04, 0.96, (n, d))
    y = np.sin(5 * X[:, 0]) + np.cos(3 * X[:, -1]) + 0.1 * rng.randn(n)
    return (X[:, 0] if d == 1 else X), y


# name -> (family, port bases, JAX bases, JAX local build, port local build, n, d, seed);
# every n leaves a remainder modulo 8
STATS = {
    "gpr1d": ("gpr1d", [B3Spline(0.0, 1.0, 24)], [JB3(0.0, 1.0, 24)], _stats_local,
              compute_stats, 203, 1, 0),
    "kron": ("kron", [B3Spline(0.0, 1.0, 9)] * 2, [JB3(0.0, 1.0, 9)] * 2, _kron_stats_local,
             compute_kron_stats, 250, 2, 1),
    "kron_nd": ("kron_nd", [BSplineBasis(0.0, 1.0, 5, 1)] * 3, [JBasis(0.0, 1.0, 5, 1)] * 3,
                _kron_stats_local_nd, compute_kron_stats_nd, 205, 3, 2),
    "additive": ("additive", [BSplineBasis(0.0, 1.0, 16, 3), BSplineBasis(0.0, 1.0, 20, 3)],
                 [JBasis(0.0, 1.0, 16, 3), JBasis(0.0, 1.0, 20, 3)], _additive_stats_local,
                 compute_additive_stats, 203, 2, 3),
}
# name -> (family, port bases, JAX bases, Matérn ν + 1/2, n, d, seed): full
# batch, N divisible by 8; "kron_nd" takes the D ≥ 3 statistics (order-1
# bases: the JAX step compiles in about 6 s on 8 devices)
STEPS = {
    "gpr1d": ("gpr1d", B3Spline(0.0, 1.0, 16), JB3(0.0, 1.0, 16), 3, 128, 1, 4),
    "kron": ("kron", [B3Spline(0.0, 1.0, 8)] * 2, [JB3(0.0, 1.0, 8)] * 2, 3, 256, 2, 5),
    "kron_nd": ("kron", [BSplineBasis(0.0, 1.0, 5, 1)] * 3, [JBasis(0.0, 1.0, 5, 1)] * 3, 1,
                256, 3, 8),
    "additive": ("additive", [B3Spline(0.0, 1.0, 10), B3Spline(0.0, 1.0, 14)],
                 [JB3(0.0, 1.0, 10), JB3(0.0, 1.0, 14)], 3, 256, 2, 6),
}
N_STEPS = 2
FIT = (Matern32(lengthscales=0.2), B3Spline(0.0, 1.0, 40), 2000, 7, 60)


def per_dim_params(d):
    """init_params() of GPRKron and GPRAdditive with d Matérn kernels (ℓ = 1,
    σ² = 1: the raw values do not depend on ν) and noise 0.1, in the JAX
    layout (numpy)."""
    one, noise = default_params(Matern32(), 0.1)["kernel"], default_params(Matern32(), 0.1)
    return {"kernels": [dict(one) for _ in range(d)], "likelihood": noise["likelihood"]}


def step_params(family, d):
    if family == "gpr1d":
        return default_params(Matern32(), 0.1)
    return per_dim_params(d)


def cases():
    stats = {name: (fam, pb[0] if fam == "gpr1d" else pb, torch.as_tensor(data(n, d, seed)[0]),
                    torch.as_tensor(data(n, d, seed)[1]))
             for name, (fam, pb, _, _, _, n, d, seed) in STATS.items()}
    steps = {}
    for name, (fam, pb, _, nu2, n, d, seed) in STEPS.items():
        X, y = data(n, d, seed)
        nu2s = nu2 if fam == "gpr1d" else [nu2] * d
        steps[name] = (fam, pb, nu2s, X, y, step_params(fam, d), N_STEPS)
    kernel, basis, n, seed, iters = FIT
    X, y = data(n, 1, seed)
    return {"stats": stats, "steps": steps, "fit": (kernel, basis, X, y, iters)}


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(parity_rank, WORLD, args=(cases(),), backend="gloo", timeout=240)


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((WORLD,), ("data",))


def stats_rel(got: dict, want: dict) -> float:
    """The largest distance over the statistics: each one's sum, sum of
    squares and projection on fixed random weights relative to the sum of
    the absolute terms it is made of (chip_smoke.py ``stats_errors``), and
    its largest entrywise difference relative to its largest entry."""
    errs = []
    for f, w in want.items():
        g, w = np.asarray(got[f], np.float64), np.asarray(w, np.float64)
        r = np.random.RandomState(7).randn(*w.shape)
        errs += [abs(g.sum() - w.sum()) / np.abs(w).sum(),
                 abs((g * g).sum() - (w * w).sum()) / (w * w).sum(),
                 abs((r * g).sum() - (r * w).sum()) / np.abs(r * w).sum(),
                 np.abs(g - w).max() / np.abs(w).max()]
    return float(max(errs))


def jax_masked_sharded(local, bases, X, y, mesh):
    """The JAX package's local build with weights, shard_map'd over the
    mesh and psum'd: its sharded statistics of the padded, masked data."""
    xp, yp, w = (a.numpy() for a in pad_for_sharding(torch.as_tensor(X), torch.as_tensor(y),
                                                     WORLD))
    b = bases[0] if len(bases) == 1 else bases

    def shard_fn(xs, ys, ws):
        return jax.tree.map(lambda a: jax.lax.psum(a, "data"), local(b, xs, ys, ws))

    # jitted: an eager shard_map runs op by op on each device, for minutes
    fn = jax.jit(jax.shard_map(shard_fn, mesh=mesh, in_specs=(P("data"),) * 3, out_specs=P()))
    with jax.set_mesh(mesh):
        out = _unmesh(fn(jnp.asarray(xp), jnp.asarray(yp), jnp.asarray(w)), mesh)
    return {f: np.asarray(getattr(out, f)) for f in vars(out)}


@pytest.mark.parametrize("name", list(STATS))
def test_sharded_stats_match_unsharded_and_jax(ranks, mesh, name):
    _, pb, jb, jlocal, plocal, n, d, seed = STATS[name]
    X, y = data(n, d, seed)
    got = ranks[0]["stats"][name]
    for r in ranks[1:]:
        assert all(np.array_equal(r["stats"][name][f], got[f]) for f in got), "ranks differ"
    b = pb if len(pb) > 1 else pb[0]
    s = plocal(b, torch.as_tensor(X), torch.as_tensor(y))
    unsharded = {f: getattr(s, f).numpy() for f in vars(s)}
    assert float(got["n"]) == n
    assert stats_rel(got, unsharded) <= TOL_STATS
    assert stats_rel(got, jax_masked_sharded(jlocal, jb, X, y, mesh)) <= TOL_STATS


def test_group_of_one_is_bit_equal(ranks):
    one = ranks[0]["one"]
    assert set(one) == {f"stats_{n}" for n in STATS} | {f"step_{n}" for n in STEPS}
    assert all(one.values()), one


def jax_params(family, d):
    if family == "gpr1d":
        return jdefault_params(JMatern32(), 0.1)
    return jax.tree.map(jnp.asarray, per_dim_params(d))


@pytest.mark.parametrize("name", list(STEPS))
def test_dp_step_matches_jax(ranks, mesh, name):
    family, _, jb, nu2, n, d, seed = STEPS[name]
    X, y = data(n, d, seed)
    maker = {"gpr1d": jmake_step, "kron": jmake_step_kron,
             "additive": jmake_step_additive}[family]
    nu2 = nu2 if family == "gpr1d" else [nu2] * d
    step, opt = maker(jb, nu2, mesh, optimizer=optax.adam(1e-2), num_data_total=n)
    params = jax_params(family, d)
    state = opt.init(params)
    xs, ys = jshard_data(jnp.asarray(X), jnp.asarray(y), mesh)
    losses = []
    for _ in range(N_STEPS):
        params, state, loss = step(params, state, xs, ys)
        losses.append(float(loss))
    got = ranks[0]["steps"][name]
    assert all(r["steps"][name]["losses"] == got["losses"] for r in ranks), "ranks differ"
    assert max(abs(a - b) / abs(b) for a, b in zip(got["losses"], losses)) <= TOL_LOSS
    want = [float(v) for v in jax.tree.leaves(params)]
    have = [float(v) for v in jax.tree.leaves(got["params"])]
    assert max(abs(a - b) / abs(b) for a, b in zip(have, want)) <= TOL_PARAMS


def test_dp_step_at_d3_matches_one_process(ranks):
    """The D ≥ 3 dispatch of ``make_dp_train_step_kron``: 8 ranks against
    the same steps on one process without the ``all_reduce``."""
    family, pb, _, nu2, n, d, seed = STEPS["kron_nd"]
    X, y = data(n, d, seed)
    step, opt = make_dp_train_step_kron(pb, [nu2] * d, None, num_data_total=n)
    params = per_dim_params(d)
    state, losses = opt.init(params), []
    for _ in range(N_STEPS):
        params, state, loss = step(params, state, torch.as_tensor(X), torch.as_tensor(y))
        losses.append(float(loss))
    got = ranks[0]["steps"]["kron_nd"]
    assert max(abs(a - b) / abs(b) for a, b in zip(got["losses"], losses)) <= TOL_LOSS
    want = [float(v) for v in jax.tree.leaves(_numpy_tree(params))]
    have = [float(v) for v in jax.tree.leaves(got["params"])]
    assert max(abs(a - b) / abs(b) for a, b in zip(have, want)) <= TOL_PARAMS


def _numpy_tree(tree):
    return jax.tree.map(lambda t: t.numpy(), tree)


def test_full_fit_from_sharded_stats_matches_unsharded(ranks):
    kernel, basis, n, seed, iters = FIT
    X, y = data(n, 1, seed)
    model = GPR1D((X, y), kernel, basis, device="cpu")
    info = {}
    _, loss, it = fit_lbfgs(model.training_loss, model.params(), max_iters=iters, info=info)
    got = ranks[0]["fit"]
    assert got["iters"] == it and got["evals"] == info["ls_evals"]
    assert abs(got["loss"] - loss) / abs(loss) <= TOL_FIT
    assert float(got["stats"]["n"]) == n


def test_dryrun_and_children_without_jax(ranks):
    losses = ranks[0]["dryrun"]["losses"]
    assert set(losses) == {"gpr1d", "kron", "additive"}
    assert all(np.all(np.isfinite(v)) and len(v) == 2 for v in losses.values())
    assert all(r["dryrun"]["losses"] == losses for r in ranks)
    assert not any(r["jax_imported"] or r["dryrun"]["jax_imported"] for r in ranks)
