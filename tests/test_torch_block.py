"""Block-banded linear algebra of the port (banded/block.py) and its
dense-block kernel K16 (banded/dense_block.py), against the JAX package.

K16's plain version is held to the JAX package's double-single kernel
``chol_inv_dense_ds`` in Pallas interpret mode, as
tests/test_pallas_ds_block.py runs it (≤ 1e-12 relative to the largest
entry, the bar of that test against float64), and to numpy's float64
Cholesky (≤ 1e-13 relative at κ ≤ 1e4, ≤ 1e-9 at κ = 1e10, the JAX
test's bar for the ill-conditioned block) and inverse (≤ 1e-12 at
κ ≤ 1e4).  The block ops (the
factor, its log-determinant, both solves, the solve with A and the block
Takahashi band) are held to the JAX package's float64 ``banded/block.py``
on the CPU to 1e-12 relative, and the backward of the Cholesky and of the
solves to ``jax.vjp`` of the same functions to 1e-10: the same float64
functions, the port taking the off-diagonal blocks, the solves and the
block Takahashi recursion through the diagonal-block inverses that K16
returned with the factor where the JAX package solves triangular systems.

The CUDA kernel has no CPU mode: its tests are marked ``cuda`` and skip
without a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asvgp_tpu.banded import block as jblock
from asvgp_tpu.banded import ds as jds
from asvgp_tpu.banded import pallas_ds_block as jpdb
from asvgp_tpu.banded import pallas_kernels as jpk
from asvgp_tpu_torch.banded import _build, block, core, dense_block


def random_spd(seed, b, kappa=1.0):
    """tests/test_pallas_ds_block.py's block: eigenvalues log-spaced from 1
    down to 1/κ."""
    rng = np.random.RandomState(seed)
    q, _ = np.linalg.qr(rng.randn(b, b))
    ev = np.logspace(0.0, -np.log10(max(kappa, 1.0)), b)
    return q @ np.diag(ev) @ q.T


def rel(got, want):
    got = np.asarray(got.detach().cpu() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def block_problem(W, nb, B, seed):
    """A random SPD block-banded A = G Gᵀ (G block-lower with block
    bandwidth W, its diagonal dominant so that κ(A) stays near 10²), as
    (block storage, dense) numpy arrays."""
    rng = np.random.RandomState(seed)
    n = nb * B
    g = np.zeros((n, n))
    for j in range(nb):
        for p in range(W + 1):
            if j + p < nb:
                blk = rng.randn(B, B) / np.sqrt(B * (W + 1))
                if p == 0:
                    blk = np.tril(blk) + np.diag(1.0 + rng.rand(B))
                g[(j + p) * B:(j + p + 1) * B, j * B:(j + 1) * B] = blk
    dense = g @ g.T
    return np.asarray(block.dense_to_block_band(torch.from_numpy(dense), W, B)), dense


@pytest.fixture
def interpret():
    jpk.set_interpret(True)
    yield
    jpk.set_interpret(False)


@pytest.mark.parametrize("b", [4, 16])
def test_chol_inv_dense_plain_matches_jax_interpret(interpret, b):
    m = random_spd(0, b)
    mh, ml = jds.split_f64(jnp.asarray(m))
    lh, ll, ivh, ivl = jpdb.chol_inv_dense_ds(mh, ml)
    l, t = dense_block.chol_inv_dense(torch.from_numpy(m))
    assert rel(l, jds.merge_f64(lh, ll)) <= 1e-12
    assert rel(t, jds.merge_f64(ivh, ivl)) <= 1e-12
    assert bool((torch.triu(l, 1) == 0).all()) and bool((torch.triu(t, 1) == 0).all())


@pytest.mark.parametrize("b,kappa,tol", [
    (1, 1.0, 1e-15), (7, 1.0, 1e-13), (24, 1e4, 1e-13), (40, 1e4, 1e-13), (16, 1e10, 1e-9),
])
def test_chol_inv_dense_plain_matches_numpy(b, kappa, tol):
    """One block and a batch of three: L and L⁻¹ against numpy; the strict
    upper triangles exactly zero; only the lower triangle is read."""
    ms = np.stack([random_spd(s, b, kappa) for s in range(3)])
    junk = np.triu(np.random.RandomState(9).randn(b, b), 1)  # ignored
    l, t = dense_block.chol_inv_dense(torch.from_numpy(ms + junk))
    for i in range(3):
        want = np.linalg.cholesky(ms[i])
        assert rel(l[i], want) <= tol
        if kappa <= 1e4:
            # the inverse carries κ(L) = √κ more rounding
            assert rel(t[i], np.linalg.inv(want)) <= 10 * tol
    assert bool((torch.triu(l, 1) == 0).all()) and bool((torch.triu(t, 1) == 0).all())
    one_l, one_t = dense_block.chol_inv_dense(torch.from_numpy(ms[1]))
    assert torch.equal(one_l, l[1]) and torch.equal(one_t, t[1])


@pytest.mark.parametrize("W,nb,B", [(0, 5, 6), (1, 8, 5), (2, 6, 7), (4, 10, 8)])
def test_block_ops_match_jax(W, nb, B):
    blocks, dense = block_problem(W, nb, B, 10 * W + nb)
    rng = np.random.RandomState(1)
    b_vec, b_mat = rng.randn(nb * B), rng.randn(nb * B, 3)
    tb = torch.from_numpy(blocks)
    jb = jnp.asarray(blocks)
    l, linv = block.cholesky_block_banded(tb)
    jl = jblock.cholesky_block_banded(jb)
    assert rel(l, jl) <= 1e-12
    assert rel(block.log_det_from_block_cholesky(l),
               jblock.log_det_from_block_cholesky(jl)) <= 1e-12
    assert rel(block.log_det_from_block_cholesky(l), np.linalg.slogdet(dense)[1]) <= 1e-12
    jl_np = jnp.asarray(l.numpy())
    for rhs in (b_vec, b_mat):
        t_rhs, j_rhs = torch.from_numpy(rhs), jnp.asarray(rhs)
        assert rel(block.solve_lower_block_banded(l, t_rhs, linv),
                   jblock.solve_lower_block_banded(jl_np, j_rhs)) <= 1e-12
        assert rel(block.solve_upper_block_banded_transpose(l, t_rhs, linv),
                   jblock.solve_upper_block_banded_transpose(jl_np, j_rhs)) <= 1e-12
        x = block.cholesky_solve_block_banded(l, t_rhs, linv)
        assert rel(x, jblock.cholesky_solve_block_banded(jl_np, j_rhs)) <= 1e-12
        assert rel(x, np.linalg.solve(dense, rhs)) <= 1e-12
    assert rel(linv, np.linalg.inv(l[0].numpy())) <= 1e-12
    s = block.takahashi_inverse_block_banded(l, linv)
    assert rel(s, jblock.takahashi_inverse_block_banded(jl_np)) <= 1e-12
    inv_band = block.dense_to_block_band(torch.from_numpy(np.linalg.inv(dense)), W, B)
    assert rel(s, inv_band) <= 1e-12
    assert rel(block.block_band_to_dense(tb), dense) == 0.0


@pytest.mark.parametrize("W,nb,B", [(0, 4, 5), (1, 6, 5), (4, 8, 5)])
def test_block_backward_matches_jax_vjp(W, nb, B):
    """The Functions' backward against ``jax.vjp`` of the JAX package's
    ``cholesky_block_banded`` and ``solve_lower_block_banded`` with the same
    cotangents; the solve of Lᵀ against autograd through the dense solve."""
    blocks, _ = block_problem(W, nb, B, 3 + W)
    rng = np.random.RandomState(2 + W)
    lbar = rng.randn(*blocks.shape)
    b, xbar = rng.randn(nb * B), rng.randn(nb * B)

    tb = torch.from_numpy(blocks).requires_grad_()
    l, linv = block.cholesky_block_banded(tb)
    assert not linv.requires_grad
    (got_a,) = torch.autograd.grad(l, tb, torch.from_numpy(lbar))
    _, vjp = jax.vjp(jblock.cholesky_block_banded, jnp.asarray(blocks))
    (want_a,) = vjp(jnp.asarray(lbar))
    assert rel(got_a, want_a) <= 1e-10

    l_np = l.detach().numpy()
    tl = torch.from_numpy(l_np).requires_grad_()
    tbv = torch.from_numpy(b).requires_grad_()
    x = block.solve_lower_block_banded(tl, tbv, linv)
    got_l, got_b = torch.autograd.grad(x, (tl, tbv), torch.from_numpy(xbar))
    _, vjp = jax.vjp(jblock.solve_lower_block_banded, jnp.asarray(l_np), jnp.asarray(b))
    want_l, want_b = vjp(jnp.asarray(xbar))
    assert rel(got_l, want_l) <= 1e-10 and rel(got_b, want_b) <= 1e-10

    x = block.solve_upper_block_banded_transpose(tl, tbv, linv)
    got_l, got_b = torch.autograd.grad(x, (tl, tbv), torch.from_numpy(xbar))
    _, vjp = jax.vjp(jblock.solve_upper_block_banded_transpose, jnp.asarray(l_np),
                     jnp.asarray(b))
    want_l, want_b = vjp(jnp.asarray(xbar))
    assert rel(got_l, want_l) <= 1e-10 and rel(got_b, want_b) <= 1e-10


def test_block_ops_on_the_cpu_run_only_plain_versions(monkeypatch):
    """With the kernel launcher and the library loader patched to raise,
    the block ops run on CPU tensors through K16's plain version alone: once
    per block column in the factor, and nothing from the solves or the
    block Takahashi recursion."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the CUDA launcher")

    monkeypatch.setattr(core, "_launch", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    W, nb, B = 2, 6, 5
    blocks, _ = block_problem(W, nb, B, 0)
    tb = torch.from_numpy(blocks).requires_grad_()
    core.reset_counters()
    l, linv = block.cholesky_block_banded(tb)
    assert core.PLAIN_CALLS == {"cpu": nb, "cuda": 0}
    x = block.cholesky_solve_block_banded(l, torch.ones(nb * B, dtype=torch.float64), linv)
    block.takahashi_inverse_block_banded(l.detach(), linv)
    x.sum().backward()
    l0, _ = block.cholesky_block_banded_fwd(torch.from_numpy(blocks[:1]))
    assert core.PLAIN_CALLS == {"cpu": nb + 1, "cuda": 0}  # W = 0: one call for all blocks
    assert l0.shape == (1, nb, B, B)
    assert all(v == 0 for v in core.LAUNCHES.values())


def test_chol_inv_dense_rejects_bad_shapes():
    with pytest.raises(ValueError):
        dense_block.chol_inv_dense(torch.zeros(3, 4, dtype=torch.float64))
    with pytest.raises(ValueError):
        dense_block.chol_inv_dense(torch.zeros(4, 4, dtype=torch.float64, device="meta"))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 7, 32, 33, 100, 128, 169, 170, 200])
@pytest.mark.parametrize("kappa", [1.0, 1e4, 1e10])
def test_cuda_chol_inv_dense_matches_plain(cuda_device, b, kappa):
    """K16 on a batch of three blocks against its plain version: ≤ 1e-13
    relative at κ ≤ 1e4, ≤ 1e-9 at κ = 1e10, and equal bit for bit (the
    same roundings in the same order for every entry); strict upper
    triangles zero.  B = 33 is one row past a warp, B = 169 the widest
    block held in shared memory, B = 170 the first in the global
    workspace."""
    ms = torch.from_numpy(np.stack([random_spd(s, b, kappa) for s in range(3)]))
    core.reset_counters()
    l, t = dense_block.chol_inv_dense(ms.to(cuda_device))
    torch.cuda.synchronize()
    assert core.LAUNCHES["chol_inv_dense"] == 1 and core.PLAIN_CALLS["cuda"] == 0
    want_l, want_t = dense_block.chol_inv_dense_plain(ms)
    tol = 1e-13 if kappa <= 1e4 else 1e-9
    assert rel(l, want_l.numpy()) <= tol and rel(t, want_t.numpy()) <= tol
    assert torch.equal(l.cpu(), want_l) and torch.equal(t.cpu(), want_t)
    assert bool((torch.triu(l, 1) == 0).all()) and bool((torch.triu(t, 1) == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("W", [0, 1, 4])
def test_cuda_block_cholesky_matches_cpu(cuda_device, W):
    nb, B = 12, 20
    blocks, _ = block_problem(W, nb, B, 5)
    tb = torch.from_numpy(blocks)
    core.reset_counters()
    tg = tb.to(cuda_device).requires_grad_()
    l, _ = block.cholesky_block_banded(tg)
    (g,) = torch.autograd.grad(block.log_det_from_block_cholesky(l), tg)
    torch.cuda.synchronize()
    assert core.LAUNCHES["chol_inv_dense"] == (1 if W == 0 else nb)
    assert core.PLAIN_CALLS["cuda"] == 0
    tc = tb.clone().requires_grad_()
    lc, _ = block.cholesky_block_banded(tc)
    (gc,) = torch.autograd.grad(block.log_det_from_block_cholesky(lc), tc)
    assert rel(l, lc.detach().numpy()) <= 1e-12 and rel(g, gc.numpy()) <= 1e-10
