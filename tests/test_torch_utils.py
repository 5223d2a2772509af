"""Checkpoints (train/checkpoint.py), scipy interop (utils/interop.py) and
the profiling helpers (utils/profiling.py) against the JAX package's.

A checkpoint is the JAX package's file: a pickle of the leaves, in the
order JAX flattens the tree, and the structure as ``str(treedef)``.  One
written by either package loads in the other with equal leaves; the
structure string equals JAX's for every kind of node.  The interop helpers
give the JAX package's results exactly (the same host arithmetic; the
basis values of Kuf agree to the last bit, as tests/test_torch_basis.py
holds them).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from asvgp_tpu.basis import B3Spline as JB3Spline
from asvgp_tpu.models import GPR1D as JGPR1D
from asvgp_tpu.models import Matern32 as JMatern32
from asvgp_tpu.train import checkpoint as jcheckpoint
from asvgp_tpu.utils import interop as jinterop
from asvgp_tpu_torch import utils
from asvgp_tpu_torch.basis import B3Spline
from asvgp_tpu_torch.models import GPR1D, Matern32
from asvgp_tpu_torch.train import checkpoint, load_pytree, save_pytree

TREES = [
    {"a": [1.0, (2.0, 3.0)], "b": None},
    {"likelihood": {"raw_variance": 1.0},
     "kernel": {"raw_variance": 2.0, "raw_lengthscales": 3.0}},
    1.0, None, [], (), {}, (1.0,), [None, 1.0],
    {"kernels": [{"a": 1.0}, {"a": 2.0}], "z": (np.ones(3),)},
    {1: 2.0, 0: 3.0},
]


@pytest.mark.parametrize("tree", TREES, ids=range(len(TREES)))
def test_structure_and_leaf_order_match_jax(tree):
    leaves, treedef = checkpoint._tree_flatten(tree)
    jleaves, jtreedef = jax.tree.flatten(tree)
    assert treedef == str(jtreedef)
    assert len(leaves) == len(jleaves)
    assert all(np.array_equal(a, b) for a, b in zip(leaves, jleaves))


def models():
    rng = np.random.RandomState(0)
    x = rng.uniform(0.05, 0.95, 50)
    y = np.sin(6.0 * x)
    model = GPR1D((x, y), Matern32(lengthscales=0.3), B3Spline(0.0, 1.0, 10), device="cpu")
    jmodel = JGPR1D((jnp.asarray(x), jnp.asarray(y)), JMatern32(lengthscales=0.3),
                    JB3Spline(0.0, 1.0, 10))
    return model, jmodel


def test_round_trip(tmp_path):
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "s": [torch.tensor(2.5, dtype=torch.float64), None, (torch.ones(2),)]}
    path = str(tmp_path / "ckpt.pkl")
    save_pytree(path, tree)
    back = load_pytree(path, tree)
    assert back["s"][1] is None and isinstance(back["s"][2], tuple)
    for a, b in zip(checkpoint._tree_flatten(back)[0], checkpoint._tree_flatten(tree)[0]):
        assert a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)


def test_checkpoints_cross_packages(tmp_path):
    """JAX writes, the port reads; the port writes, JAX reads: the same
    leaves, and the port's model restored from a JAX checkpoint."""
    model, jmodel = models()
    jparams = jax.tree.map(lambda v: v * 1.25, jmodel.init_params())
    jpath = str(tmp_path / "jax.pkl")
    jcheckpoint.save_pytree(jpath, jparams)
    loaded = load_pytree(jpath, model.params())
    model.load_jax_params(loaded)
    for got, want in zip(jax.tree.leaves(jax.tree.map(np.asarray, jparams)),
                         checkpoint._tree_flatten(model.params())[0]):
        assert np.array_equal(got, want.numpy())

    ppath = str(tmp_path / "port.pkl")
    save_pytree(ppath, model.params())
    jloaded = jcheckpoint.load_pytree(ppath, jmodel.init_params())
    for got, want in zip(jax.tree.leaves(jloaded), jax.tree.leaves(jparams)):
        assert np.array_equal(np.asarray(got), np.asarray(want))


def test_load_errors_match_jax(tmp_path):
    model, _ = models()
    like = model.params()
    path = str(tmp_path / "c.pkl")
    save_pytree(path, like)
    with pytest.raises(ValueError, match="leaves, expected"):
        load_pytree(path, {**like, "extra": torch.zeros(())})
    renamed = {"kernel": like["kernel"], "noise": like["likelihood"]}
    with pytest.raises(ValueError, match="structure does not match"):
        load_pytree(path, renamed)
    reshaped = {**like, "likelihood": {"raw_variance": torch.zeros(2, dtype=torch.float64)}}
    with pytest.raises(ValueError, match="leaf shapes differ at indices \\[2\\]"):
        load_pytree(path, reshaped)
    # the JAX package raises the same three on the same files
    jlike = jax.tree.map(np.asarray, like)
    for bad in ({**jlike, "extra": np.zeros(())},
                {"kernel": jlike["kernel"], "noise": jlike["likelihood"]},
                {**jlike, "likelihood": {"raw_variance": np.zeros(2)}}):
        with pytest.raises(ValueError):
            jcheckpoint.load_pytree(path, bad)


def test_load_keeps_the_dtype_and_device_of_like(tmp_path):
    path = str(tmp_path / "c.pkl")
    save_pytree(path, {"a": np.float64(1.0) / 3.0, "b": np.arange(3.0)})
    like = {"a": torch.zeros((), dtype=torch.float32),
            "b": torch.zeros(3, dtype=torch.float64, device="cpu")}
    out = load_pytree(path, like)
    assert out["a"].dtype == torch.float32 and float(out["a"]) == np.float32(1.0 / 3.0)
    assert out["b"].dtype == torch.float64 and out["b"].device == like["b"].device
    assert torch.equal(out["b"], torch.arange(3.0, dtype=torch.float64))


def test_interop_matches_jax():
    rng = np.random.RandomState(1)
    band = rng.randn(4, 30)
    for j in range(1, 4):
        band[j, 30 - j:] = 0.0
    csr = utils.lower_band_to_scipy(torch.from_numpy(band))
    want = jinterop.lower_band_to_scipy(jnp.asarray(band))
    assert isinstance(csr, sp.csr_matrix) and np.array_equal(csr.toarray(), want.toarray())
    back = utils.scipy_to_lower_band(csr, 3, device="cpu")
    assert back.dtype == torch.float64 and back.device.type == "cpu"
    assert np.array_equal(back.numpy(), jinterop.scipy_to_lower_band(want, 3))
    assert np.array_equal(back.numpy(), band)
    x = rng.uniform(0.01, 0.99, 200)
    kuf = utils.kuf_to_scipy(B3Spline(0.0, 1.0, 25), torch.from_numpy(x))
    jkuf = jinterop.kuf_to_scipy(JB3Spline(0.0, 1.0, 25), x)
    assert kuf.shape == jkuf.shape == (25, 200)
    assert np.array_equal(kuf.toarray(), jkuf.toarray())
    assert np.array_equal(kuf.indptr, jkuf.indptr) and np.array_equal(kuf.indices, jkuf.indices)
    assert np.array_equal(utils.kuf_to_scipy(B3Spline(0.0, 1.0, 25), x, device="cpu").toarray(),
                          kuf.toarray())


def test_scipy_to_lower_band_defaults_to_the_card():
    mat = sp.identity(5, format="csr")
    if torch.cuda.is_available():
        assert utils.scipy_to_lower_band(mat, 1).is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            utils.scipy_to_lower_band(mat, 1)


def test_kuf_to_scipy_defaults_to_the_card():
    x = np.linspace(0.1, 0.9, 7)
    if torch.cuda.is_available():
        want = utils.kuf_to_scipy(B3Spline(0.0, 1.0, 9), torch.from_numpy(x).cuda())
        assert np.array_equal(utils.kuf_to_scipy(B3Spline(0.0, 1.0, 9), x).indices, want.indices)
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            utils.kuf_to_scipy(B3Spline(0.0, 1.0, 9), x)


def test_timed_returns_median_and_result():
    calls = []

    def fn(a, b=1):
        calls.append(a)
        return {"sum": torch.tensor(a + b)}

    seconds, result = utils.timed(fn, 2, b=3, reps=3, warmup=2)
    assert isinstance(seconds, float) and seconds >= 0.0
    assert int(result["sum"]) == 5 and len(calls) == 5


def test_trace_to_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "trace"
    with utils.trace_to(str(logdir)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(logdir / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
