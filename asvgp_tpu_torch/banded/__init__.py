"""Banded linear algebra (PyTorch counterpart of asvgp_tpu/banded).

Storage conventions as in the JAX package: a *lower band* ``band`` of shape
``(k+1, m)`` holds a lower-triangular-banded ``(m, m)`` matrix ``M`` with
``band[j, i] = M[i + j, i]`` for ``i + j < m``; out-of-range slots are zero
("right padding").  Row 0 is the main diagonal.

``ops`` holds the plain-PyTorch recursions (``*_plain``) and the public ops,
which run the plain recursion on a CPU tensor and a kernel on a CUDA one;
``core`` the two value sweeps (K1, K2) and the collapsed core's adjoint
(K7, K8), ``single`` the single-matrix Cholesky and Takahashi and their
adjoints (K9–K12, in float32 K17–K20) and the pair Cholesky (K15),
``solve`` the triangular solves (K13, K14, in float32 K21, K22) and their
autograd Functions, ``tan`` the tangent-fused
sweeps (K3, K4) and ``twist`` their two-ended form (K5, K6), as CUDA
kernels on the GPU; ``twisted`` the float64 oracle of the two-ended
factorization.  ``block`` holds the block-banded algebra of the Kronecker
model and of the additive model's dense coupling (a block-banded matrix of
full block bandwidth), whose diagonal-block step is K16 (``dense_block``).
"""

from asvgp_tpu_torch.banded.layout import (
    band_to_dense,
    dense_to_band,
    dense_to_lower_band,
    lower_band_of_symmetric,
    lower_band_to_dense,
    mask_band,
    mask_lower_band,
    shift_cols,
    symmetrise_lower_band,
    transpose_lower_band,
)
from asvgp_tpu_torch.banded.ops import (
    band_frobenius,
    banded_posterior,
    cholesky_band,
    cholesky_band_pair,
    cholesky_solve_band,
    collapsed_core,
    collapsed_core_matern,
    log_det_from_cholesky,
    matvec_band,
    matvec_symmetric_band,
    product_band_band,
    solve_lower_band,
    solve_upper_band_transpose,
    takahashi_inverse_band,
    twist_scope,
)
from asvgp_tpu_torch.banded.core import factor_takahashi_solve
from asvgp_tpu_torch.banded.block import (
    block_band_to_dense,
    cholesky_block_banded,
    cholesky_solve_block_banded,
    dense_to_block_band,
    log_det_from_block_cholesky,
    solve_lower_block_banded,
    solve_upper_block_banded_transpose,
    takahashi_inverse_block_banded,
)
from asvgp_tpu_torch.banded.tan import factor_takahashi_solve_tan
from asvgp_tpu_torch.banded.twist import factor_takahashi_solve_tan_twist, twist_applicable

__all__ = [
    "band_to_dense",
    "dense_to_band",
    "dense_to_lower_band",
    "lower_band_of_symmetric",
    "lower_band_to_dense",
    "mask_band",
    "mask_lower_band",
    "shift_cols",
    "symmetrise_lower_band",
    "transpose_lower_band",
    "band_frobenius",
    "banded_posterior",
    "cholesky_band",
    "cholesky_band_pair",
    "cholesky_solve_band",
    "collapsed_core",
    "collapsed_core_matern",
    "log_det_from_cholesky",
    "matvec_band",
    "matvec_symmetric_band",
    "product_band_band",
    "solve_lower_band",
    "solve_upper_band_transpose",
    "takahashi_inverse_band",
    "twist_scope",
    "factor_takahashi_solve",
    "factor_takahashi_solve_tan",
    "factor_takahashi_solve_tan_twist",
    "twist_applicable",
    "block_band_to_dense",
    "cholesky_block_banded",
    "cholesky_solve_block_banded",
    "dense_to_block_band",
    "log_det_from_block_cholesky",
    "solve_lower_block_banded",
    "solve_upper_block_banded_transpose",
    "takahashi_inverse_block_banded",
]
