"""Block-banded linear algebra in float64: the Kronecker model's coupling
matrix P.

PyTorch counterpart of ``asvgp_tpu/banded/block.py`` with the structure of
its accelerator route ``block_ds.py``.  P = Kuu₁ ⊗ Kuu₂ + KufKfu/σ² is
banded in blocks of size B = m₂ with block bandwidth W = k₁; the
factorization walks the nb = m₁ block columns carrying a W-column window,
and each step is dense B×B algebra.

Storage: ``blocks`` of shape (W+1, nb, B, B), ``blocks[p, J] = A[(J+p)·B :
(J+p+1)·B, J·B : (J+1)·B]`` (block column J, p-th sub-diagonal; slots past
the end zero).  The diagonal blocks of an input hold the full symmetric
block; those of a factor are lower-triangular.

``cholesky_block_banded`` factors one block column per step: the Schur
update of its (W+1, B, B) panel in one ``torch.matmul``, the diagonal
block through K16 (``dense_block.chol_inv_dense``, which also returns the
inverse of the factor), and the W off-diagonal blocks as one product with
that inverse.  W = 0 is one K16 launch on the batch of nb diagonal blocks.
The factorization returns those inverses L_JJ⁻¹ beside L; its backward
(``CholeskyBlockBanded``) is the reverse block recursion of the JAX
package's ``_chol_block_adjoint`` fed with them, and the solves and the
block Takahashi recursion take them as an input, so the inverses are
computed once, by K16.  Every other block product is ``torch.matmul``.
"""

from __future__ import annotations

import torch

from asvgp_tpu_torch.banded.dense_block import chol_inv_dense


def _t(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2)


def _phi(x: torch.Tensor) -> torch.Tensor:
    """Lower triangle with halved diagonal (the Cholesky-adjoint projector),
    over the last two dims."""
    return torch.tril(x) - 0.5 * torch.diag_embed(torch.diagonal(x, dim1=-2, dim2=-1))


def _keep(j: int, wp1: int, nb: int, like: torch.Tensor) -> torch.Tensor:
    """(W+1, 1, 1) mask of the block rows J + p < nb of block column J."""
    rows = j + torch.arange(wp1, device=like.device)
    return (rows < nb).to(like.dtype)[:, None, None]


# ---------------------------------------------------------------------------
# block-banded Cholesky
# ---------------------------------------------------------------------------


def cholesky_block_banded_fwd(blocks: torch.Tensor):
    """The factor and the inverses of its diagonal blocks:
    (L (W+1, nb, B, B), L_JJ⁻¹ (nb, B, B)).  K16 runs once per block
    column (W ≥ 1) or once on all nb diagonal blocks (W = 0)."""
    wp1, nb, B, _ = blocks.shape
    W = wp1 - 1
    if W == 0:
        l0, linv = chol_inv_dense(blocks[0].contiguous())
        return l0[None], linv
    zero = blocks.new_zeros((B, B))
    # window[p-1] = factor column J-p, (W+1, B, B); zero before column 0
    window = [torch.zeros_like(blocks[:, 0]) for _ in range(W)]
    cols, linvs = [], []
    for j in range(nb):
        # s[q] = a[q] - Σ_p L[J+q, J-p] L[J, J-p]ᵀ with L[J+q, J-p] =
        # window[p-1][q+p]: rows R[q] = [window[0][q+1] | window[1][q+2] |
        # ...], G = the stacked L[J, J-p]ᵀ, one matmul for the whole panel
        r = torch.stack([
            torch.cat([window[p - 1][q + p] if q + p <= W else zero for p in range(1, W + 1)],
                      dim=-1)
            for q in range(W + 1)
        ])
        g = torch.cat([_t(window[p - 1][p]) for p in range(1, W + 1)], dim=0)
        s = blocks[:, j] - torch.matmul(r, g)
        l00, linv = chol_inv_dense(s[0].contiguous())
        off = torch.matmul(s[1:], _t(linv))
        col = torch.cat([l00[None], off]) * _keep(j, wp1, nb, s)
        window = [col] + window[:-1]
        cols.append(col)
        linvs.append(linv)
    return torch.stack(cols, dim=1), torch.stack(linvs)


def chol_block_adjoint(l_blocks: torch.Tensor, linv: torch.Tensor,
                       lbar: torch.Tensor) -> torch.Tensor:
    """Ā from (L, L̄) for the block-banded Cholesky, given the inverses
    ``linv`` of L's diagonal blocks: the reverse block recursion of the JAX
    package's ``_chol_block_adjoint`` (block.py:125-236), column K from
    nb−1 down to 0, carrying the S̄ columns K+1..K+W:
      L̄[a,K] += −Σ_p S̄_{a−p}(K+p) L[p,K] − Σ_q S̄_q(K+a)ᵀ L[q+a,K]
      S̄_q(K) = L̄_q L0⁻¹ (q ≥ 1),  Ā_q(K) = S̄_q(K),
      S̄_0(K) = ½ L0⁻ᵀ (Φ(L0ᵀM) + Φ(L0ᵀM)ᵀ) L0⁻¹,  M = tril(L̄_0 − Σ_q S̄_qᵀ L_q).
    """
    wp1, nb, B, _ = l_blocks.shape
    W = wp1 - 1
    if W == 0:
        m = _phi(torch.matmul(_t(l_blocks[0]), torch.tril(lbar[0])))
        return (0.5 * torch.matmul(_t(linv), torch.matmul(m + _t(m), linv)))[None]
    zero = l_blocks.new_zeros((B, B))
    window = [torch.zeros_like(l_blocks[:, 0]) for _ in range(W)]  # S̄ columns K+1..K+W
    cols = [None] * nb
    for k in range(nb - 1, -1, -1):
        l_col, li = l_blocks[:, k], linv[k]
        g = l_col[1:].reshape(W * B, B)
        r = torch.stack([
            torch.cat([window[p - 1][a - p] if a - p >= 0 else zero for p in range(1, W + 1)],
                      dim=-1)
            for a in range(W + 1)
        ])
        t = torch.stack([torch.cat([_t(window[a - 1][q]) for q in range(W + 1)], dim=-1)
                         for a in range(1, W + 1)])
        h = torch.stack([
            torch.cat([l_col[q + a] if q + a <= W else zero for q in range(W + 1)], dim=0)
            for a in range(1, W + 1)
        ])
        lb = lbar[:, k] - torch.matmul(r, g)
        lb = torch.cat([lb[:1], lb[1:] - torch.matmul(t, h)])
        keep = _keep(k, wp1, nb, lb)
        lb = torch.where(keep > 0, lb, 0.0)
        sbar_off = torch.matmul(lb[1:], li)
        extra = torch.matmul(_t(sbar_off.reshape(W * B, B)), l_col[1:].reshape(W * B, B))
        m = _phi(torch.matmul(_t(l_col[0]), torch.tril(lb[0] - extra)))
        sbar0 = 0.5 * torch.matmul(_t(li), torch.matmul(m + _t(m), li))
        col = torch.where(keep > 0, torch.cat([sbar0[None], sbar_off]), 0.0)
        window = [col] + window[:-1]
        cols[k] = col
    return torch.stack(cols, dim=1)


class CholeskyBlockBanded(torch.autograd.Function):
    """(L, L_JJ⁻¹) = block-banded chol(A) and its diagonal-block inverses:
    the forward of ``cholesky_block_banded_fwd`` (K16 on the diagonal
    blocks), the backward ``chol_block_adjoint``.  The inverses carry no
    gradient: every consumer differentiates through L alone."""

    @staticmethod
    def forward(ctx, blocks):
        l_blocks, linv = cholesky_block_banded_fwd(blocks)
        ctx.save_for_backward(l_blocks, linv)
        ctx.mark_non_differentiable(linv)
        return l_blocks, linv

    @staticmethod
    def backward(ctx, lbar, _linv_bar):
        l_blocks, linv = ctx.saved_tensors
        return chol_block_adjoint(l_blocks, linv, lbar)


def cholesky_block_banded(blocks: torch.Tensor):
    """Block-banded Cholesky A = L Lᵀ, differentiable in L.

    Args:
      blocks: (W+1, nb, B, B) block-lower storage of a symmetric
        positive-definite A (diagonal blocks full-symmetric).
    Returns:
      (L, linv): (W+1, nb, B, B) block-lower storage of L (diagonal blocks
      lower-triangular, blocks past the end zero), and the (nb, B, B)
      inverses of its diagonal blocks, which K16 computed with them; the
      solves and ``takahashi_inverse_block_banded`` take both.
    """
    return CholeskyBlockBanded.apply(blocks)


def log_det_from_block_cholesky(l_blocks: torch.Tensor) -> torch.Tensor:
    """log|A| = 2 Σ log diag(L) over the diagonal blocks; only strictly
    positive diagonal entries enter (a padding block's zeros would give
    −inf, and a Cholesky diagonal is positive)."""
    diags = torch.diagonal(l_blocks[0], dim1=-2, dim2=-1)
    return 2.0 * torch.sum(torch.log(torch.where(diags > 0, diags, 1.0)))


# ---------------------------------------------------------------------------
# solves
# ---------------------------------------------------------------------------


def _rhs_blocks(b: torch.Tensor, nb: int, B: int):
    vec = b.ndim == 1
    b2 = b[:, None] if vec else b
    return b2.reshape(nb, B, b2.shape[1]), vec


def _out(x: torch.Tensor, vec: bool) -> torch.Tensor:
    x = x.reshape(-1, x.shape[-1])
    return x[:, 0] if vec else x


def solve_lower_block_banded_impl(l_blocks: torch.Tensor, b: torch.Tensor,
                                  linv: torch.Tensor) -> torch.Tensor:
    """L x = b by block forward substitution (b: (nb·B,) or (nb·B, r))."""
    wp1, nb, B, _ = l_blocks.shape
    W = wp1 - 1
    bb, vec = _rhs_blocks(b, nb, B)
    if W == 0:
        return _out(torch.matmul(linv, bb), vec)
    xs: list = []
    for j in range(nb):
        s = bb[j]
        if j > 0:
            # s = b_J − [L[J, J−1] | ... | L[J, J−W]] [x_{J−1}; ...; x_{J−W}]
            ps = range(1, min(W, j) + 1)
            row = torch.cat([l_blocks[p, j - p] for p in ps], dim=-1)
            s = s - torch.matmul(row, torch.cat([xs[j - p] for p in ps], dim=0))
        xs.append(torch.matmul(linv[j], s))
    return _out(torch.stack(xs), vec)


def solve_upper_block_banded_transpose_impl(l_blocks: torch.Tensor, b: torch.Tensor,
                                            linv: torch.Tensor) -> torch.Tensor:
    """Lᵀ x = b by block backward substitution."""
    wp1, nb, B, _ = l_blocks.shape
    W = wp1 - 1
    bb, vec = _rhs_blocks(b, nb, B)
    if W == 0:
        return _out(torch.matmul(_t(linv), bb), vec)
    xs: list = [None] * nb
    for j in range(nb - 1, -1, -1):
        s = bb[j]
        ps = range(1, min(W, nb - 1 - j) + 1)
        if ps:
            # s = b_J − Σ_p L[J+p, J]ᵀ x_{J+p}
            row = torch.cat([_t(l_blocks[p, j]) for p in ps], dim=-1)
            s = s - torch.matmul(row, torch.cat([xs[j + p] for p in ps], dim=0))
        xs[j] = torch.matmul(_t(linv[j]), s)
    return _out(torch.stack(xs), vec)


def _band_outer_blocks(u: torch.Tensor, v: torch.Tensor, wp1: int, nb: int, B: int):
    """Block band of −u vᵀ: out[p, J] = −u_{J+p} v_Jᵀ (zero for J+p ≥ nb,
    diagonal blocks lower-triangular: the storage of a factor)."""
    ub = u.reshape(nb, B, -1)
    vb = v.reshape(nb, B, -1)
    outs = []
    for p in range(wp1):
        blk = u.new_zeros((nb, B, B))
        if p < nb:
            blk[: nb - p] = -torch.matmul(ub[p:], _t(vb[: nb - p]))
        outs.append(torch.tril(blk) if p == 0 else blk)
    return torch.stack(outs)


def _as_matrix(x: torch.Tensor) -> torch.Tensor:
    return x[:, None] if x.ndim == 1 else x


class SolveLowerBlockBanded(torch.autograd.Function):
    """x = L⁻¹ b, with the algebraic adjoint b̄ = L⁻ᵀ x̄, L̄ = −b̄ xᵀ on the
    block band (block.py:401-427), which holds all of L's gradient: none
    flows through the diagonal-block inverses."""

    @staticmethod
    def forward(ctx, l_blocks, b, linv):
        x = solve_lower_block_banded_impl(l_blocks, b, linv)
        ctx.save_for_backward(l_blocks, x, linv)
        return x

    @staticmethod
    def backward(ctx, xbar):
        l_blocks, x, linv = ctx.saved_tensors
        wp1, nb, B, _ = l_blocks.shape
        bbar = solve_upper_block_banded_transpose_impl(l_blocks, xbar, linv)
        lbar = _band_outer_blocks(_as_matrix(bbar), _as_matrix(x), wp1, nb, B)
        return lbar, bbar, None


class SolveUpperBlockBandedTranspose(torch.autograd.Function):
    """x = L⁻ᵀ b, with the algebraic adjoint b̄ = L⁻¹ x̄, L̄ = −x b̄ᵀ on the
    block band (block.py:430-453)."""

    @staticmethod
    def forward(ctx, l_blocks, b, linv):
        x = solve_upper_block_banded_transpose_impl(l_blocks, b, linv)
        ctx.save_for_backward(l_blocks, x, linv)
        return x

    @staticmethod
    def backward(ctx, xbar):
        l_blocks, x, linv = ctx.saved_tensors
        wp1, nb, B, _ = l_blocks.shape
        bbar = solve_lower_block_banded_impl(l_blocks, xbar, linv)
        lbar = _band_outer_blocks(_as_matrix(x), _as_matrix(bbar), wp1, nb, B)
        return lbar, bbar, None


def solve_lower_block_banded(l_blocks: torch.Tensor, b: torch.Tensor,
                             linv: torch.Tensor) -> torch.Tensor:
    """Solve L x = b for (L, linv) from ``cholesky_block_banded``; b is
    (nb·B,) or (nb·B, r).  Differentiable in L and b."""
    return SolveLowerBlockBanded.apply(l_blocks, b, linv)


def solve_upper_block_banded_transpose(l_blocks: torch.Tensor, b: torch.Tensor,
                                       linv: torch.Tensor) -> torch.Tensor:
    """Solve Lᵀ x = b.  Differentiable in L and b."""
    return SolveUpperBlockBandedTranspose.apply(l_blocks, b, linv)


def cholesky_solve_block_banded(l_blocks: torch.Tensor, b: torch.Tensor,
                                linv: torch.Tensor) -> torch.Tensor:
    """Solve A x = b given the block-banded factor L of A and its
    diagonal-block inverses."""
    return solve_upper_block_banded_transpose(
        l_blocks, solve_lower_block_banded(l_blocks, b, linv), linv)


# ---------------------------------------------------------------------------
# block Takahashi: the block band of A⁻¹
# ---------------------------------------------------------------------------


def takahashi_inverse_block_banded(l_blocks: torch.Tensor, linv: torch.Tensor) -> torch.Tensor:
    """Block band of A⁻¹ from the block-banded factor L and its
    diagonal-block inverses: the block Takahashi recursion
    (block.py:468-531), exact on the block band.  Returns (W+1, nb, B, B)
    block-lower storage (diagonal blocks symmetric)."""
    wp1, nb, B, _ = l_blocks.shape
    W = wp1 - 1
    if W == 0:
        return torch.matmul(_t(linv), linv)[None]
    window = [torch.zeros_like(l_blocks[:, 0]) for _ in range(W)]  # S columns J+1..J+W
    cols = [None] * nb
    for j in range(nb - 1, -1, -1):
        l_col, li = l_blocks[:, j], linv[j]
        w = l_col[1:]  # w[p-1] = L[J+p, J]
        # M[q-1, p-1] = S[J+q, J+p]: window[p-1][q-p] (p ≤ q), else the
        # transpose of window[q-1][p-q]; rows flattened as (W, B, W·B)
        m = torch.stack([
            torch.cat([window[p - 1][q - p] if p <= q else _t(window[q - 1][p - q])
                       for p in range(1, W + 1)], dim=-1)
            for q in range(1, W + 1)
        ])
        # S[J+q, J] = −(Σ_p S[J+q, J+p] L[J+p, J]) L_JJ⁻¹
        s_off = -torch.matmul(torch.matmul(m, w.reshape(W * B, B)), li)
        # S[J, J] = (L_JJ⁻ᵀ − Σ_p S[J+p, J]ᵀ L[J+p, J]) L_JJ⁻¹
        acc = torch.matmul(_t(s_off.reshape(W * B, B)), w.reshape(W * B, B))
        sjj = torch.matmul(_t(li) - acc, li)
        sjj = 0.5 * (sjj + _t(sjj))
        col = torch.cat([sjj[None], s_off]) * _keep(j, wp1, nb, s_off)
        window = [col] + window[:-1]
        cols[j] = col
    return torch.stack(cols, dim=1)


# ---------------------------------------------------------------------------
# layout helpers
# ---------------------------------------------------------------------------


def block_band_to_dense(blocks: torch.Tensor) -> torch.Tensor:
    """Expand block-lower storage to the dense symmetric (nb·B, nb·B) matrix."""
    wp1, nb, B, _ = blocks.shape
    out = blocks.new_zeros((nb * B, nb * B))
    for p in range(wp1):
        for j in range(nb - p):
            blk = blocks[p, j]
            out[(j + p) * B:(j + p + 1) * B, j * B:(j + 1) * B] += blk
            if p > 0:
                out[j * B:(j + 1) * B, (j + p) * B:(j + p + 1) * B] += _t(blk)
    return out


def dense_to_block_band(dense: torch.Tensor, W: int, B: int) -> torch.Tensor:
    """Block-lower storage (W+1, nb, B, B) of a dense symmetric matrix: one
    block diagonal at a time, out of place, so that it differentiates into
    the blocks it reads (the lower ones)."""
    nb = dense.shape[0] // B
    grid = dense.reshape(nb, B, nb, B).transpose(1, 2)  # grid[I, J] = block (I, J)
    rows = []
    for p in range(W + 1):
        diag = torch.diagonal(grid, offset=-p, dim1=0, dim2=1).permute(2, 0, 1)  # [J] = (J+p, J)
        rows.append(torch.cat([diag, dense.new_zeros((nb - diag.shape[0], B, B))]))
    return torch.stack(rows)
