"""Smoke run of the PyTorch/CUDA port (asvgp_tpu_torch) on one NVIDIA GPU.

Drives the GPR1D serving and training paths (in float64 and in float32),
minibatch Adam and SVGP1D at the north-star shape — N = 10⁶ points from
bench.py's generator, m = 10⁴ B3-spline features on [0, 1], Matérn-3/2 —
GPRKron at the eNATL60
protocol's shape (experiments/spatial_2d/ocean_ssh.py: N = 2·10⁶ 2-D
points, 100 × 100 B4-spline features; also through the protocol's torch
leg) and at D = 3 (N = 10⁶, 20³ B3-spline features), GPRAdditive at
ADDITIVE_PROBE.json's shape (tools/additive_probe.py: N = 5·10⁵ points in
4 dimensions, 250 B3-spline features each, M = 1000), the float32 trainers
and data parallelism on a world of one rank, through the port's public
entry points, on the card:

  0. card check: prints nvidia-smi's name and power limit; no CUDA, no run
  1. build: compiles the CUDA sweeps (csrc/*.cu) with nvcc, one process per
     source, all at once; registers and spills of every kernel
  2. kernel parity: K1 + K2, K3 + K4 and K5 + K6 against their plain
     PyTorch versions, for k = 1..6 on random SPD bands (with a random
     symmetric tangent band), and at the main path's shapes on its real
     Kuu, T = ∂Kuu/∂ℓ, P and Kuf·y; K7–K12 for k = 1..6 on random SPD
     bands and cotangents; the partitioned adjoints (K7, K8, K10, K12,
     K18, K20, K23) and forward sweeps (K9, K11, K15, K17, K19) at the
     edges of their partitions (one column, one chunk, a ragged chunk, two
     matrices, k = 6 at m = 10⁴), the forward sweeps' first chunk equal
     bit for bit to the kernel on that chunk alone; the twisted sweeps K5
     and K6 at the edges of their partitions (both parities of m − k, the
     reversed stream a chunk shorter, one chunk, a chunk edge at the middle
     block, k = 6 at m = 10⁴), each stream's first chunk equal bit for bit
     to the kernel on a problem made of that chunk alone; the serving
     sweeps K1 and K2 at the edges of their partitions (one column, one
     chunk of each and one more column, ragged last chunks, k = 6 at
     m = 10⁴), each walk's first chunk equal bit for bit to the kernel on
     that chunk alone; the single-ended tangent sweeps K3 and K4 at the
     same edges (and k = 3 at m = 10⁴), each walk's first chunk the kernel
     on that chunk alone, with the registers and spills of their kernels
  3. serving path: GPR1D on the card → training_loss (held to the
     CPU-float64 value of the JAX package) → posterior → predict_f on 10⁵
     held-out points in batches → NLPD; predictions held against a
     posterior built by the plain versions on a CPU copy
  4. proof of the serving path: K1 and K2 launched, no plain version ran on
     a CUDA tensor
  5. training path: training_loss().backward() on the twisted route and on
     the single-ended one (gradients held to the JAX package's CPU-float64
     values), fit_lbfgs for 10 iterations at the north star, the Snelson
     fit of GPR1D and of the exact GP
  6. proof of the training path: each step and fit runs on fresh counters
     and launches exactly its route's kernels (K5 + K6 on the twisted
     route, K3 + K4 on the single-ended one, once per evaluation) and no
     plain version on a CUDA tensor
  6a. minibatch Adam (fit_adam_minibatch) at the north star: batch 4096,
     learning rate 1e-2, 20 steps on a fixed index stream; the step-1 loss
     and gradient and the step-20 loss and parameters held to the JAX
     package's CPU-float64 run of the same loop on the same indices
  6b. its proof: a step launches K1, K2, K7, K8 once each, the fit 20 times
     each, nothing else, and no plain version on a CUDA tensor
  6c. SVGP1D (fit_svgp) at the same data and width: batch 100, learning rate
     1e-3, 20 steps from init_params() with the C* seeding; losses at steps
     1 and 20 held to the JAX package's CPU-float64 values; predict_f and
     NLPD on the held-out points against the plain versions on a CPU copy
  6d. its proof: the seeding launches K9 once, a step K9 ×4, K10 ×4, K11 ×3,
     K12 ×3, a prediction K9 ×2, K11 ×2, nothing else
  6e. K7–K12 against their plain versions at the main path's shapes, on the
     inputs the paths gave them (the north-star Kuu, the Λ of the seeded
     SVGP, the actual cotangents of CollapsedCore and of the SVGP step)
  6f. K15 (pair Cholesky) and K23 (pair Takahashi adjoint) against their
     plain versions for k = 1..6, then each on fresh counters at the north
     star's Kuu and P: banded.cholesky_band_pair with a gradient launches
     K15 and K8 once, core.tak_bwd_pair K23 once
  6g. K16 (dense-block Cholesky ⊗ inverse) against its plain version on
     random SPD blocks, B = 1..200 (33: a row past a warp; 128: the TPU's
     limit; 169/170: the last in shared memory and the first in the global
     workspace), κ = 1, 1e4, 1e10: equal bit for bit; strict upper
     triangles exactly zero
  6h. GPRKron: the statistics (built twice: the same bits; held to the JAX
     package's CPU-float64 values), the loss and its gradient by
     backward(), fit_lbfgs (10 iterations, curv_rtol 10, REPS + 1 times),
     the posterior, predictions on 10⁵ held-out points, MSE and NLPD, all
     held to tools/kron_anchors.py's values; predictions against a
     posterior built by the plain versions on a CPU copy
  6i. its proof: construction launches nothing, a step K9, K10, K11, K12
     twice each and K16 once per block column (100), the fit that per
     evaluation, the posterior K9 = K11 = 2 and K16 = 100, the predictions
     K24 once a chunk; K16 against its plain version on the 100 diagonal
     blocks the step gave it; K24 at the map cell's shape
     (benchmark/traffic/map.json: one 1000 × 1000 map over (0.02, 0.98)²,
     10⁶ points, k₁ = 4, T = 5) on the posterior's band of P⁻¹, its
     windows taken from predict_f (one launch a request) in the map's
     row-major order and in a shuffled order: against its plain version on
     the card within 1e-13, two launches bit-equal, the shuffled result the
     ordered one permuted bit for bit
  6j. the solves and the float32 kernels: K13/K14 (float64) and K17–K22
     (float32) against their plain versions for k = 1..6 on random SPD
     bands, the solves with a vector and a matrix right-hand side; at the
     north star, banded.cholesky_solve_band on the real L_P and Kuf·y
     (K9 + K13 + K14, on fresh counters) against banded_posterior's u
     (K1 + K2), and the largest entry of the composed chunk maps K13 and
     K14 built there; K13/K21 and K14/K22 at the edges of their partitions
     (one row, one chunk, a ragged chunk, 4096 columns); the solves'
     autograd Functions against autograd through the plain versions
  6k. the float32 GPR1D at the north star (GPR1D(..., dtype=float32)):
     training_loss() and .backward(), the posterior, predict_f on the 10⁵
     held-out points in batches and NLPD, held to tools/f32_anchors.py's
     values (the JAX package's float32 route); predictions against a
     posterior built by the plain float32 versions on a CPU copy; the loss
     within 1e-2 of the float64 anchor (printed on its own line)
  6l. its proof, on fresh counters: construction and predict launch
     nothing; a step K17 ×2, K19, K21, K18 ×2, K20, K22 once each; the
     posterior K17 ×2, K19 ×2, K21, K22; no float64 kernel and no plain
     version on a CUDA tensor; K17–K22 against their plain versions on the
     arguments the step and the posterior gave them; the largest entry of
     the adjoints' composed chunk maps on the factors the main paths gave
     them (L_Kuu and L_P at the north star, the Adam and SVGP steps', the
     GPRKron step's, the float32 step's); for the forward sweeps on the
     same paths' arguments, the Takahashi maps' largest entry and the
     Cholesky walk's largest entry of W and smallest singular value of
     I − W P; for K5 and K6 on the north star's bands, each stream's
     largest W, Ẇ (Kuu) and β (P), the smallest eigenvalue of I − UᵀWU
     and K6's maps' largest entry; for K1 and K2 on the same bands, Kuu's
     and P's largest W, P's β, the smallest eigenvalue of I − UᵀWU and
     K2's maps' largest entry; for K3 and K4 on the same bands, Kuu's W
     and Ẇ, P's W and β, each one's smallest eigenvalue of I − UᵀWU and
     K4's maps' largest entry by matrix
  6m. GPRAdditive: the statistics (built twice: the same bits; held to the
     JAX package's CPU-float64 values), the loss and its gradient by
     backward(), fit_lbfgs (10 iterations, curv_rtol 10, REPS + 1 times,
     ms per iteration on the host clock), the posterior, predictions on 10⁵
     held-out points, MSE and NLPD, all held to tools/additive_anchors.py's
     values; predictions against a posterior built by the plain versions on
     a CPU copy
  6n. its proof: construction and prediction launch nothing, a step K9,
     K10, K11, K12 four times each (once per dimension) and K16 once per
     128-wide block column of the padded P (8), the fit that per
     evaluation, the posterior K9 = K11 = 4 and K16 = 8; K16 equal bit for
     bit to its plain version on the 8 diagonal blocks the step gave it,
     K9–K12 against theirs on the step's arguments (m = 250)
  6q. the eNATL60 protocol's torch leg (experiments/spatial_2d/
     ocean_ssh_torch.py, ``run``) at its full width with 10 iterations: its
     ELBO, MSE and NLL held to tools/kron_anchors.py's values at GPRKron's
     bars in 10 iterations and 12 evaluations, its artifact's keys the JAX
     script's without relay_wait_s, each stage's launches exact (the
     predict stage's three predictions one K24 launch each)
  6r. GPRKron at D = 3 (tools/kron_nd_anchors.py's shape: 10⁶ points of a
     3-D field, 3 × B3 of m = 20, so P has 20 block columns of dense 400 ×
     400 blocks): the statistics (built twice: the same bits), the loss and
     its gradient by backward(), fit_lbfgs (10 iterations, curv_rtol 10,
     three times), the posterior, predictions on 10⁵ held-out points, MSE
     and NLPD, all held to that script's values; predictions against a
     posterior built by the plain versions on a CPU copy
  6s. its proof: construction launches nothing, a step K9, K10, K11, K12
     three times each and K16 20 times, the fit that per evaluation, the
     posterior K9 = K11 = 3 and K16 = 20, the predictions K24 (T = 16, the
     kernel's run-time T) once a chunk; K16 at B = 400
     equal bit for bit to its plain version on the step's 20 diagonal
     blocks, K9–K12 within 1e-13 of theirs on the step's arguments
  6t. the float32 trainers: fit_lbfgs of the float32 GPR1D on Snelson
     (the defaults, up to 500 iterations) and at the north star (10
     iterations, curv_rtol 10), and fit_adam_minibatch(..., dtype=float32)
     at the north star (phase 6a's batch, steps and indices), each once on
     fresh counters: losses and parameters within max(10 × spread, 1e-6)
     of tools/f32_fit_anchors.py's JAX float32 runs (the spread: how far one
     float32 rounding of their inputs moves them), the iteration counts and
     ``converged`` equal, each final loss within 10 × the JAX float32 run's
     distance from its float64 run; every evaluation and step launches the
     float32 route (K17 ×2, K19, K21, K18 ×2, K20, K22) exactly, the
     parameters stay float32; ms of each run
  6u. data parallelism on a world of one NCCL rank (this process): the
     sharded statistics at the north star, the eNATL60 shape and
     ADDITIVE_PROBE.json's, each bit-equal to the build without the
     all_reduce, and the all_reduce's ms; two data-parallel Adam steps of
     each family (full batch), each loss and the parameters bit-equal to
     the same step without the all_reduce, each step's launches exact
     (K1, K2, K7, K8; K9–K12 ×2 and K16 × 100; K9–K12 ×4 and K16 × 8) and
     its ms; the eNATL60 leg with --mesh 1 (a rank process of its own), its
     ELBO, MSE and NLL equal to phase 6q's
  6v. block cyclic reduction at the north star (GPR1D(..., backend="cr"),
     banded/cyclic.py: batched library calls on 3×3 blocks, no kernel of
     its own): the loss and its gradient by backward() within 1e-9 and
     1e-8 of the anchors and the loss within 1e-9 of the twisted route's;
     S_Kuu, S_P and u within 1e-9 of banded_posterior's K1 + K2 results
     and the predictions on the 10⁵ held-out points of the default
     route's; fit_lbfgs (10 iterations, curv_rtol 10) within 1e-8 of the
     anchor; the step, the posterior and the fit each on fresh counters
     launch none of K1–K23; a step and a posterior under
     set_sync_debug_mode("error"); a step traced by utils.trace_to (its
     Chrome trace must hold CUDA kernel events); the fitted parameters
     through save_pytree / load_pytree on the card, the loss equal bit for
     bit; kuf_to_scipy of 10⁴ points from the card with the CPU's pattern
     and its values within 1e-15 (the card divides by a scalar as a
     product with its reciprocal, so the values differ in the last bits).
     Printed, not held: the A/B of cyclic reduction against the serial
     walks on the same inputs (host-clock median of utils.timed, wall and
     device ms, busy share and device operations of each): the CR step
     against the twisted (K5 + mid + K6) and single-ended (K3 + K4) steps,
     the CR posterior against K1 + K2's, cr_inverse_band(Kuu) against
     K9 + K11 and
     cr_logdet_solve(P, b) against K9 + K13 + K14
  7. times on the card (CUDA events, median of REPS; each plain version
     once after a warm-up, with no kernel launched by any of them; each fit
     REPS times on the host clock), the device time of K1, K2, K13, K14,
     K21, K22,
     the adjoints K7, K8, K10, K12, K18, K20, K23, the forward sweeps K9,
     K11, K15, K17, K19, the twisted sweeps K5, K6, the single-ended
     sweeps K3, K4, K16 alone, and K24 on the map's windows in its order
     and shuffled
     (torch.profiler), of K1 + K2, the float64 posterior and the value-only
     ELBO, of the mid step, of K5 + mid + K6, of K3 + K4 and of the twisted
     and single-ended value-and-grad steps, and the partitioned kernels' and those steps'
     event time less their device time, each kernel's bound,
     cholesky_solve_band, the
     float32 step, posterior and predict beside the float64 ones, and the
     library
     counterparts: K16's (torch.linalg.cholesky, then solve_triangular
     against I), the dense torch.linalg.cholesky of A for K9, K15 and K17,
     torch.cholesky_inverse of the dense L for K11 and K19 and the dense
     torch.linalg.solve_triangular for K13, K14, K21 and K22; the additive
     step, posterior and predict (events, device time, busy share), K16
     alone at B = 128 with its bound, and the additive P's block route
     (log|P| + L⁻¹b, P⁻¹b + P⁻¹) against the library's yardstick on the
     same padded P (torch.linalg.cholesky + solve_triangular; + cholesky_solve
     + torch.cholesky_inverse); at D = 3 the statistics, the step and its
     backward, one block Cholesky of P, the fit per iteration, the
     posterior and predict (with their busy shares), and K16 at B = 400 on
     one block, on the 20 in one launch and as 20 launches, beside the
     library pair on the same blocks, with its bound

Every phase prints one JSON line; any failure raises.  The second-last
line lists the kernels, the last line is the device record.  Run from the
repository root:

    python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
import copy
import importlib.util
import json
import math
import re
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

N = 1_000_000
M = 10_000
SEED = 0
N_TEST = 100_000
TEST_SEED = 1
PREDICT_BATCH = 30_000  # 10⁵ points in 4 chunks: the last one is padded
PARITY_M = 1000
REPS = 5
SNELSON_DIR = Path(__file__).resolve().parent / "data" / "snelson"

# training_loss at bench.py's shape and init params, and its gradient in the
# raw parameters, computed on a CPU in float64 through the JAX package's
# lax.scan recursions
ANCHOR_LOSS = 233371.85202107206
ANCHOR_GRAD = {
    "raw_lengthscales": 6194.71248362058,
    "raw_variance": -1666.3533805085608,
    "raw_noise_variance": 47919.1679342376,
}
# the JAX package's fit_lbfgs on a CPU in float64: at bench.py's shape,
# max_iters=10, curv_rtol=10.0 (10 iterations, 13 evaluations); on Snelson
# (B3 on [-3.5, 10.5], m = 100) with the defaults (50 iterations, 58
# evaluations); the exact GP on Snelson with the defaults
ANCHOR_FIT_LOSS = 230282.0107765328
ANCHOR_FIT_ITERS = 10
ANCHOR_SNELSON_LOSS = 60.8356177971898
ANCHOR_EXACT_LOSS = 60.5739888147678
# max |kernel - plain| / max |plain| over every output: random diagonally
# dominant bands are well conditioned, so the two summation orders agree to
# a few ulps of float64
TOL_PARITY = 1e-11
# at the main path's shapes κ(Kuu) amplifies the rounding differences
# between the two orders of summation
TOL_PARITY_MAIN = 1e-8
TOL_LOSS = 1e-7      # relative, against ANCHOR_LOSS
TOL_PREDICT = 1e-9   # max |card - cpu| / max |cpu|, mean and variance
TOL_GRAD = 1e-8      # relative, each component against ANCHOR_GRAD
TOL_ROUTES = 1e-9    # relative, twisted vs single-ended loss and gradient
TOL_FIT = 1e-8       # relative, fitted losses against the JAX package's
TOL_KUF = 1e-15      # absolute, Kuf's values (≤ 1) from the card against the CPU's: the
                     # card divides by a scalar as a product with its reciprocal
TOL_CR = 1e-9        # relative, the CR loss against ANCHOR_LOSS (the JAX CR route lies
                     # 3.9e-12 from it) and its posterior and predictions against the
                     # default route's (largest value)
# the new kernels (K7-K12) against their plain versions at m = PARITY_M on
# random bands: relative to the largest value of each output
TOL_PARITY_ADJOINT = 1e-13

# minibatch Adam at the north star (experiments/large_regression/
# synthetic_1m.py's --batch, the JAX package's default learning rate) and
# the SVGP baseline (synthetic_1m.py's --svgp-batch, the reference's Adam
# default), each on indices drawn with numpy from its own seed
ADAM_STEPS, ADAM_BATCH, ADAM_LR, ADAM_INDEX_SEED = 20, 4096, 1e-2, 2
SVGP_STEPS, SVGP_BATCH, SVGP_LR, SVGP_INDEX_SEED = 20, 100, 1e-3, 3
# the same loops run by the JAX package on a CPU in float64 (lax.scan
# recursions, optax.adam) on the same indices: the step-1 loss and its
# gradient, the step-20 loss and the final parameters
ANCHOR_ADAM_LOSS_1 = -132856.28487561457
ANCHOR_ADAM_GRAD_1 = {
    "raw_lengthscales": 72862.16893929032,
    "raw_variance": -16027.979633740617,
    "raw_noise_variance": 414226.92808208877,
}
ANCHOR_ADAM_LOSS_20 = -230279.5564658884
ANCHOR_ADAM_PARAMS = {
    "raw_lengthscales": -7.105764511649853,
    "raw_variance": 0.7391621332951891,
    "raw_noise_variance": -2.452380962579647,
}
ANCHOR_SVGP_LOSS_1 = 3739292.7939086454
ANCHOR_SVGP_LOSS_20 = 4151146.415940038
TOL_ADAM_LOSS = 1e-9   # relative, step-1 and step-20 losses
TOL_ADAM_GRAD = 1e-8   # relative, each step-1 gradient component and final parameter
TOL_SVGP_LOSS = 1e-9   # relative, step-1 and step-20 losses

# the profiled calls a step's busy share is read over; two keep the trace of
# a Kron step (≈ 8000 device operations a call) short
PROFILE_REPS = 2

# H100 SXM data sheet: HBM3 bandwidth and the FP64 and FP32 (non-tensor-core)
# peaks; the sweeps' arithmetic is scalar fma
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP64_PER_S = 34e12
# FP64 on the tensor cores: the rate of K16's dense Cholesky and triangular
# inverse, which are matmul-shaped
PEAK_FP64_TC_PER_S = 67e12
PEAK_FP32_PER_S = 67e12

KERNELS = {
    # name: (source, TPU kernel it replaces)
    "chol_pair_solve": ("asvgp_tpu_torch/csrc/banded_core.cu",
                        "asvgp_tpu/banded/pallas_ds_core.py:74"),
    "tak_pair_solve": ("asvgp_tpu_torch/csrc/banded_core.cu",
                       "asvgp_tpu/banded/pallas_ds_core.py:152"),
    "chol_pair_solve_tan": ("asvgp_tpu_torch/csrc/banded_tan.cu",
                            "asvgp_tpu/banded/pallas_ds_tan.py:82"),
    "tak_pair_solve_tan": ("asvgp_tpu_torch/csrc/banded_tan.cu",
                           "asvgp_tpu/banded/pallas_ds_tan.py:211"),
    "chol_quad_solve_tan": ("asvgp_tpu_torch/csrc/banded_tan.cu",
                            "asvgp_tpu/banded/pallas_ds_twist.py:165"),
    "tak_quad_solve_tan": ("asvgp_tpu_torch/csrc/banded_tan.cu",
                           "asvgp_tpu/banded/pallas_ds_twist.py:315"),
    "tak_bwd_vec": ("asvgp_tpu_torch/csrc/banded_adjoint.cu",
                    "asvgp_tpu/banded/pallas_ds_core.py:270"),
    "chol_bwd_pair": ("asvgp_tpu_torch/csrc/banded_adjoint.cu",
                      "asvgp_tpu/banded/pallas_ds_pair.py:152"),
    "chol_fwd": ("asvgp_tpu_torch/csrc/banded_adjoint.cu",
                 "asvgp_tpu/banded/pallas_ds.py:63"),
    "chol_bwd": ("asvgp_tpu_torch/csrc/banded_adjoint.cu",
                 "asvgp_tpu/banded/pallas_ds.py:127"),
    "tak_fwd": ("asvgp_tpu_torch/csrc/banded_adjoint.cu",
                "asvgp_tpu/banded/pallas_ds.py:237"),
    "tak_bwd": ("asvgp_tpu_torch/csrc/banded_adjoint.cu",
                "asvgp_tpu/banded/pallas_ds.py:435"),
    "chol_fwd_pair": ("asvgp_tpu_torch/csrc/banded_adjoint.cu",
                      "asvgp_tpu/banded/pallas_ds_pair.py:86"),
    "tak_bwd_pair": ("asvgp_tpu_torch/csrc/banded_adjoint.cu",
                     "asvgp_tpu/banded/pallas_ds_core.py:447"),
    "chol_inv_dense": ("asvgp_tpu_torch/csrc/block_chol_inv.cu",
                       "asvgp_tpu/banded/pallas_ds_block.py:47"),
    "solve_lower": ("asvgp_tpu_torch/csrc/banded_solve.cu",
                    "asvgp_tpu/banded/pallas_ds.py:310"),
    "solve_upper_t": ("asvgp_tpu_torch/csrc/banded_solve.cu",
                      "asvgp_tpu/banded/pallas_ds.py:361"),
    "chol_fwd_f32": ("asvgp_tpu_torch/csrc/banded_adjoint.cu",
                     "asvgp_tpu/banded/pallas_kernels.py:162"),
    "chol_bwd_f32": ("asvgp_tpu_torch/csrc/banded_adjoint.cu",
                     "asvgp_tpu/banded/pallas_kernels.py:207"),
    "tak_fwd_f32": ("asvgp_tpu_torch/csrc/banded_adjoint.cu",
                    "asvgp_tpu/banded/pallas_kernels.py:322"),
    "tak_bwd_f32": ("asvgp_tpu_torch/csrc/banded_adjoint.cu",
                    "asvgp_tpu/banded/pallas_kernels.py:375"),
    "solve_lower_f32": ("asvgp_tpu_torch/csrc/banded_solve.cu",
                        "asvgp_tpu/banded/pallas_kernels.py:486"),
    "solve_upper_t_f32": ("asvgp_tpu_torch/csrc/banded_solve.cu",
                          "asvgp_tpu/banded/pallas_kernels.py:527"),
    # K24 replaces no TPU kernel: the JAX package gathers the windows with
    # XLA (asvgp_tpu/models/kron.py:448-465)
    "block_window_quad": ("asvgp_tpu_torch/csrc/block_window.cu", None),
}
SERVING_KERNELS = ("chol_pair_solve", "tak_pair_solve")
TRAINING_KERNELS = ("chol_pair_solve_tan", "tak_pair_solve_tan",
                    "chol_quad_solve_tan", "tak_quad_solve_tan")
ADAM_KERNELS = ("chol_pair_solve", "tak_pair_solve", "tak_bwd_vec", "chol_bwd_pair")
# launches of one SVGP step (elbo calls kl, which factors again), of the C*
# seeding and of one prediction
SVGP_STEP = {"chol_fwd": 4, "chol_bwd": 4, "tak_fwd": 3, "tak_bwd": 3}
SVGP_SEED = {"chol_fwd": 1}
SVGP_PREDICT = {"chol_fwd": 2, "tak_fwd": 2}
PARAM_NAMES = ("raw_lengthscales", "raw_variance", "raw_noise_variance")

# GPRKron at the eNATL60 protocol of experiments/spatial_2d/ocean_ssh.py:
# synthetic_ssh(N_KRON + N_KRON_TEST) from KRON_SEED, the first N_KRON_TEST
# points held out, 2 × BSplineBasis(0, 1, 100, 4), 2 × Matern32(ℓ = 0.1),
# noise 0.1; only the iteration count is cut (10, as at the north star)
N_KRON, N_KRON_TEST, KRON_SEED = 2_000_000, 100_000, 1997
KRON_M, KRON_ORDER, KRON_ELL, KRON_NOISE = 100, 4, 0.1, 0.1
# the same model built by the JAX package on a CPU in float64
# (tools/kron_anchors.py): the statistics as that script's stat_summary
# gives them, the loss and its gradient at the initial parameters (order:
# kernels[0] ℓ and σ², kernels[1] ℓ and σ², noise), fit_lbfgs(max_iters=10,
# curv_rtol=10.0), and the MSE and NLPD of its posterior on the held-out points
ANCHOR_KRON_STATS = {
    "kuf_y": {"sum": 65556.69205098292, "abs_sum": 1412646.605229095,
              "sumsq": 313530657.1867012, "proj": -1827.132858930665,
              "proj_abs": 1115813.802874701},
    "t_band": {"sum": 1430404.0314282072, "abs_sum": 1430404.0314282072,
               "sumsq": 35191151.72021886, "proj": 4173.822649832639,
               "proj_abs": 1140029.426080588},
    "yty": 1410364.1114346646,
    "n": 2000000.0,
}
STAT_SUMMARY_SEED = 7
ANCHOR_KRON_LOSS = 253363.2654126156
ANCHOR_KRON_GRAD = (245455.01157823647, 308984.9796388908, 245158.2569789277,
                    308984.9796401218, 272302.43079762574)
ANCHOR_KRON_FIT_LOSS = -930917.8958619128
ANCHOR_KRON_FIT_ITERS, ANCHOR_KRON_FIT_EVALS = 10, 12
ANCHOR_KRON_MSE = 0.022358649162923617
ANCHOR_KRON_NLPD = -0.48088964638062937
# relative limits (PERF.md §2): the statistics' summaries (each against
# the sum of absolute values it is made of: the JAX package takes one
# 2·10⁶-long cumsum, the port two levels of prefix sums); loss, gradient,
# fit, MSE and NLPD as PERF.md §2 sets them
TOL_KRON_STATS = 1e-10
TOL_KRON_LOSS = 1e-9
TOL_KRON_GRAD = 1e-8
TOL_KRON_FIT = 1e-8
TOL_KRON_METRICS = 1e-8
# K16 against its plain version, relative to the largest entry of each output
TOL_K16 = 1e-13       # κ ≤ 1e4
TOL_K16_ILL = 1e-9    # κ = 1e10, the JAX package's test's bar
K16_SIZES = (1, 7, 32, 33, 100, 128, 169, 170, 200)
K16_KAPPAS = (1.0, 1e4, 1e10)
# one value-and-grad step of GPRKron: the two per-dimension factors and
# Takahashi bands forward (K9, K11) and backward (K10, K12); K16 once per
# block column of P, KRON_M of them; the posterior the same without the
# backward
KRON_STEP = {"chol_fwd": 2, "chol_bwd": 2, "tak_fwd": 2, "tak_bwd": 2,
             "chol_inv_dense": KRON_M}
KRON_POSTERIOR = {"chol_fwd": 2, "tak_fwd": 2, "chol_inv_dense": KRON_M}
# the eNATL60 leg's predict stage: the posterior, then predict_f,
# predict_log_density and a warm predict_f, each one chunk and one K24
ENATL_PREDICT = KRON_POSTERIOR | {"block_window_quad": 3}
# K24 at the map cell's request (benchmark/traffic/map.json): a MAP_GRID ×
# MAP_GRID map over (MAP_LO, MAP_HI)², shifted by MAP_SHIFT of a grid step,
# in the map's row-major order and permuted from MAP_SHUFFLE_SEED
MAP_GRID, MAP_LO, MAP_HI, MAP_SHIFT, MAP_SHUFFLE_SEED = 1000, 0.02, 0.98, (0.37, 0.61), 5
# K24 against its plain version on the card, relative to the largest value:
# one FP64 sum in another order (7.1e-16 measured at this shape)
TOL_K24 = 1e-13

# GPRAdditive at ADDITIVE_PROBE.json's shape (tools/additive_probe.py):
# N_ADD points in ADD_D dimensions from RandomState(ADD_SEED), y = Σ_d
# sin((3 + 2d) x_d) + 0.2 ε; N_ADD_TEST held-out points drawn the same way
# from RandomState(ADD_TEST_SEED); ADD_D × B3Spline(0, 1, ADD_M) (M = 1000),
# ADD_D × Matern32(ℓ = 0.2), noise 0.1; only the iteration count is cut (10)
N_ADD, N_ADD_TEST, ADD_SEED, ADD_TEST_SEED = 500_000, 100_000, 0, 1
ADD_D, ADD_M, ADD_ELL, ADD_NOISE = 4, 250, 0.2, 0.1
# the same model built by the JAX package on a CPU in float64
# (tools/additive_anchors.py on the GPU machine's CPU; its loss at init
# lies 1.35e-9 from ADDITIVE_PROBE.json's CPU loss0, as far as Kuu
# perturbed at the float64 rounding level moves it): the statistics as
# stat_summary gives them, the loss and its gradient at the initial
# parameters (order: kernels[d] ℓ and σ² for d = 0..3, noise),
# fit_lbfgs(max_iters=10, curv_rtol=10.0), and the MSE and NLPD of its
# posterior on the held-out points
ANCHOR_ADD_STATS = {
    "kuf_y": {"sum": 2169574.795993968, "abs_sum": 2187626.9745228547,
              "sumsq": 6576778637.303127, "proj": -25511.16841485128,
              "proj_abs": 1691825.4251026236},
    "kufkfu": {"sum": 8000000.0, "abs_sum": 8000000.0,
               "sumsq": 1496748467.8923402, "proj": -73098.2926616824,
               "proj_abs": 6371954.89076828},
    "yty": 1381178.9333684472,
    "n": 500000.0,
}
ANCHOR_ADD_LOSS = 493038.7789725177
ANCHOR_ADD_GRAD = (116416.86840022025, 80399.73537979103, 116407.69842062812,
                   80369.1098745171, 116427.46688392779, 80304.02522578467,
                   116285.77008498665, 80371.96071087514, -341187.2788966579)
ANCHOR_ADD_FIT_LOSS = -79702.19602276012
ANCHOR_ADD_FIT_ITERS, ANCHOR_ADD_FIT_EVALS = 10, 12
ANCHOR_ADD_MSE = 0.04018866119832291
ANCHOR_ADD_NLPD = -0.18640098532841895
# relative limits, GPRKron's (PERF.md §2), the gradient's per component.
# The JAX package's own values move by up to 1.3e-9 (loss), 1.3e-8
# (gradient), 2.3e-9 (fit), 1.1e-9 (NLPD) when Kuu, or KufKfu and Kuf·y,
# are perturbed at the float64 rounding level (tools/additive_anchors.py
# --spread), so the loss and gradient bars sit at the anchors' own
# precision
TOL_ADD_STATS = 1e-10
TOL_ADD_LOSS = 1e-09
TOL_ADD_GRAD = 1e-08
TOL_ADD_FIT = 1e-08
TOL_ADD_METRICS = 1e-08
# P is M×M, M = ADD_D·ADD_M, factored in 128-wide blocks (padded to 1024):
# one value-and-grad step factors each Kuu_d and takes its Takahashi band
# forward (K9, K11) and backward (K10, K12), and runs K16 once per block
# column of P; the posterior the same without the backward
ADD_NB = -(-ADD_D * ADD_M // 128)
ADD_STEP = {"chol_fwd": ADD_D, "chol_bwd": ADD_D, "tak_fwd": ADD_D, "tak_bwd": ADD_D,
            "chol_inv_dense": ADD_NB}
ADD_POSTERIOR = {"chol_fwd": ADD_D, "tak_fwd": ADD_D, "chol_inv_dense": ADD_NB}

# GPRKron at D = 3 (tools/kron_nd_anchors.py's shape): synthetic_field_3d(N_ND
# + N_ND_TEST) from ND_SEED, the first N_ND_TEST points held out,
# ND_D × BSplineBasis(0, 1, ND_M, ND_ORDER) (M = 8000 features, ND_M block
# columns of dense blocks of side ND_B = 400), ND_D × Matern32(ℓ = 0.2),
# noise 0.1; only the iteration count is cut (10)
N_ND, N_ND_TEST, ND_SEED = 1_000_000, 100_000, 2024
ND_D, ND_M, ND_ORDER, ND_ELL, ND_NOISE = 3, 20, 3, 0.2, 0.1
ND_B = ND_M ** (ND_D - 1)
# the same model built by the JAX package on a CPU in float64
# (tools/kron_nd_anchors.py on the GPU machine's CPU): the statistics as
# stat_summary gives them, the loss and its gradient at the initial
# parameters (order: kernels[d] ℓ and σ² for d = 0..2, noise),
# fit_lbfgs(max_iters=10, curv_rtol=10.0), and the MSE and NLPD of its
# posterior on the held-out points.  With the statistics or each Kuu band
# perturbed by 1e-15 relative (``--spread``) these move by ≤ 1.4e-13 (loss),
# ≤ 7.1e-13 (each gradient component), ≤ 9.2e-15 (fit), ≤ 7.6e-16 (MSE,
# NLPD), in the same 10 iterations and 12 evaluations: GPRKron's bars hold
ANCHOR_ND = {
    "stats": {
        "kuf_y": {"sum": -29972.848955179623, "abs_sum": 722112.3694239776,
                  "sumsq": 140907577.3625167, "proj": -2563.0221672881016,
                  "proj_abs": 565118.9268311497},
        "t_band": {"sum": 739522.2476334567, "abs_sum": 739522.2476334567,
                   "sumsq": 7095418.076303582, "proj": 5945.407147247732,
                   "proj_abs": 590953.8753723652},
        "yty": 729212.2049221199,
        "n": 1000000.0,
    },
    "loss": 580713.6943829674,
    "grad": (178188.11174145513, 479444.2443951602, 178735.0353435378,
             479444.2443951554, 178177.08600719162, 479444.2443951453,
             -293541.9518282401),
    "fit_loss": -852009.637113552, "fit_iters": 10, "fit_evals": 12,
    "mse": 0.00993946808153179,
    "nlpd": -0.8865584164779218,
}
# relative limits (PERF.md §2): GPRKron's bars at D = 2
TOL_ND = {"stats": 1e-10, "loss": 1e-9, "grad": 1e-8, "fit": 1e-8, "mse": 1e-8, "nlpd": 1e-8}
# a step factors each Kuu_d and takes its Takahashi band forward (K9, K11)
# and backward (K10, K12), and runs K16 once per block column of P (ND_M);
# the posterior the same without the backward
ND_STEP = {"chol_fwd": ND_D, "chol_bwd": ND_D, "tak_fwd": ND_D, "tak_bwd": ND_D,
           "chol_inv_dense": ND_M}
ND_POSTERIOR = {"chol_fwd": ND_D, "tak_fwd": ND_D, "chol_inv_dense": ND_M}
# timed fits after the warm-up one (a D = 3 fit takes seconds)
ND_FIT_REPS = 2

# the eNATL60 protocol's torch leg (experiments/spatial_2d/ocean_ssh_torch.py)
# at its defaults with 10 iterations: held to the GPRKron anchors above
ENATL_LEG = Path(__file__).resolve().parent / "experiments" / "spatial_2d" / "ocean_ssh_torch.py"
ENATL_ITERS = 10
# the JAX script's artifact keys without relay_wait_s
ENATL_KEYS = {
    "n_train", "n_test", "features", "order", "device", "elbo", "iters", "grad_norm",
    "converged", "opt_info", "mse", "nll", "timings_s", "opt_phases_s", "stats_phases_s",
    "pred_phases_s", "cpu_f64_baseline",
}

# the solves K13/K14 and the float32 kernels K17-K22 against their plain
# versions on random bands at PARITY_M (phase 6j), relative to the largest
# entry: the float64 solves at the float64 sweeps' bar (TOL_PARITY_ADJOINT);
# the float32 forward sweeps and solves at TOL_F32_FWD and the float32
# adjoints at TOL_F32_ADJOINT (the same recursions rounded in another
# order, κ ≤ 1e4)
TOL_F32_FWD = 1e-5
TOL_F32_ADJOINT = 1e-4
F32_ADJOINTS = ("chol_bwd_f32", "tak_bwd_f32")
SOLVE_RHS = 5  # columns of the matrix right-hand sides
SOLVES = ("solve_lower", "solve_upper_t", "solve_lower_f32", "solve_upper_t_f32")
# K13/K21 and K14/K22 at the edges of their partitions into 64-row chunks
# (phase 6j), (k, m, r): one row; one chunk (m < 64, m = 64); a ragged last
# chunk (the top rows of the upper solve); 4096 columns, where the rows
# form one chunk
SOLVE_EDGES = ((1, 1, 1), (3, 40, 1), (3, 40, SOLVE_RHS), (6, 64, 1), (2, 65, SOLVE_RHS),
               (4, 4097, 1), (3, 1000, 4096))
# the adjoints K7/K8/K10/K12 and K18/K20 (one matrix), K8/K23 (two) at the
# edges of their partitions into chunks (phase 2), (k, m, nb): one column;
# one chunk (m < 64, m = 64); a ragged last chunk; the two-chunk rule up to
# 512 columns (GPRAdditive's m = 250, 192 + 65 columns at 257, 256 + 256 at
# 512, 64-column chunks from 513); k = 6 at m = 10⁴, whose chunks are the
# longest (192 columns) so that the scan's maps fit in shared memory
ADJOINT_EDGES = ((1, 1, 1), (3, 40, 1), (6, 64, 1), (2, 65, 1), (3, 250, 1), (3, 257, 1),
                 (3, 512, 2), (3, 513, 1), (4, 4097, 1), (3, 1000, 2), (6, 10_000, 1),
                 (6, 10_000, 2))
ADJOINTS = ("tak_bwd_vec", "chol_bwd_pair", "chol_bwd", "tak_bwd", "tak_bwd_pair",
            "chol_bwd_f32", "tak_bwd_f32")
# the forward sweeps K9/K17 and K15 (chol_fwd<K, T>, one and two matrices;
# 128-column chunks) and K11/K19 (tak_fwd<K, T>; 64 at k <= 4) at the
# edges of their partitions (phase 2), (k, m, nb): one column; one chunk;
# a ragged last chunk of one column (the Takahashi's at 65, the
# Cholesky's at 129); the Takahashi's two-chunk rule (m = 250, 257, 512,
# 513); two matrices; 4097 columns; k = 6 at m = 10⁴.  Every chunk spans
# at least FIRST_CHUNK columns, so the first FIRST_CHUNK columns of a walk
# (the first of the Cholesky's, the last of the Takahashi's) lie in the
# kernel's first chunk and, alone, form one chunk
FORWARD_EDGES = ((1, 1, 1), (3, 40, 1), (6, 64, 1), (2, 65, 1), (2, 129, 1), (3, 250, 1),
                 (3, 257, 1), (3, 512, 1), (3, 513, 1), (4, 4097, 1), (3, 1000, 2),
                 (3, 10_000, 1), (6, 10_000, 1), (6, 10_000, 2))
FORWARDS = ("chol_fwd", "chol_fwd_f32", "chol_fwd_pair", "tak_fwd", "tak_fwd_f32")
FIRST_CHUNK = 64
# the twisted sweeps K5 (chol_quad_solve_tan; 128-column chunks, its walk
# stages 2(k² + k(k+1)) doubles a chunk) and K6 (tak_quad_solve_tan; 64 at
# k <= 3, as many as the scan can stage maps of (2D)² + 2D doubles, 2D =
# k(k+1)) at the edges of their partitions (phase 2), (k, m): both parities
# of m - k; the reversed stream one K5 chunk shorter (h = 129, g = 128);
# both streams one chunk (h = g = 64); a chunk edge at the middle block
# (h = g = 256); k = 6 at m = 10⁴ (K6's 320-column chunks)
TWIST_EDGES = ((1, 1001), (2, 1000), (2, 2 * 129 + 1), (3, 2 * 129 + 2), (3, 2 * 64 + 3),
               (4, 2 * 256 + 4), (5, 2 * 256 + 5), (6, 2 * 256 + 6), (6, 10_000))
TWISTED = ("chol_quad_solve_tan", "tak_quad_solve_tan")
SMEM_LIMIT, MAX_CHUNKS, TILE = 232448, 256, 64  # csrc/chunk_scan.cuh
TWO_CHUNK_COLS = 512  # csrc/banded_adjoint.cu kTwoChunkCols: past it the linear sweeps' rule
# the serving sweeps K1 (chol_pair_solve; 128-column chunks, its walk stages
# k² + k(k+1) + 2k doubles a chunk) and K2 (tak_pair_solve; 64 at k <= 3,
# as many as the scan can stage maps of DD² + DD doubles, DD = k(k+1)/2 + k)
# at the edges of their partitions (phase 2), (k, m), for k = 1..6: one
# column (k = 1); one chunk of K2 exactly and one more column; one chunk of
# K1 exactly and one more column; ragged last chunks of both (165: K2's
# third and K1's second chunk of 37 columns; 293: K1's third, K2's fifth);
# k = 6 at m = 10⁴ (K2's 320-column chunks).  Each walk's first chunk (K1's
# first CORE_FIRST[0] columns, K2's last CORE_FIRST[1]) is the kernel on
# those columns alone
CORE_EDGES = ((1, 1),) + tuple((k, m) for k in range(1, 7)
                               for m in (64, 65, 128, 129, 165, 293)) + ((6, 10_000),)
CORE_FIRST = (128, 64)
# the single-ended tangent sweeps K3 (chol_pair_solve_tan; 128-column chunks,
# its walk stages K5's triple, 2(k² + k(k+1)) doubles a chunk) and K4
# (tak_pair_solve_tan; 64 at k <= 3, as many as the scan can stage maps of
# (2D)² + 2D doubles, 2D = k(k+1)) at the edges of their partitions (phase
# 2): CORE_EDGES's shapes, which are the same edges of chunks of the same
# lengths, and k = 3 at m = 10⁴ (the north star's); each walk's first chunk
# (K3's first TAN_FIRST[0] columns, K4's last TAN_FIRST[1]) is the kernel
# on those columns alone
TAN_EDGES = CORE_EDGES + ((3, 10_000),)
TAN_FIRST = (128, 64)
TAN = TRAINING_KERNELS[:2]
# K17-K22 on the arguments the float32 path gave them at the north star:
# 10x the random bands' bar, as κ(Kuu) amplifies the rounding there
TOL_F32_MAIN = 1e-4
# cholesky_solve_band (K9 + K13 + K14) against banded_posterior's u (K1 + K2)
# at the north star, relative to the largest entry
TOL_SOLVE_NORTH_STAR = 1e-10
# the float32 GPR1D at the north star (GPR1D(..., dtype=float32)): the JAX
# package's float32 route (statistics in float64 cast once, then x64 off,
# the scan recursions) on a CPU, from tools/f32_anchors.py: the loss and
# its gradient in the raw parameters at init_params(), the posterior's mean
# and variance on the held-out points as stat_summary gives them, the NLPD
ANCHOR_F32_LOSS = 234253.0
ANCHOR_F32_GRAD = {
    "raw_lengthscales": 8933.3369140625,
    "raw_variance": -941.2274780273438,
    "raw_noise_variance": 47080.55078125,
}
ANCHOR_F32_MEAN = {"sum": -195.68821878519884, "abs_sum": 67375.21798719614,
                   "proj": -241.61307477659423, "proj_abs": 53322.61184563257}
ANCHOR_F32_VAR = {"sum": 96.33213925361633, "abs_sum": 96.33213925361633,
                  "proj": -0.2866495889355711, "proj_abs": 76.48262411980065}
ANCHOR_F32_NLPD = 0.2177850902080536
# the float64 values of the same quantities (the JAX package's float64
# model, same script): the variance's summary and the NLPD; the loss and
# gradient are ANCHOR_LOSS and ANCHOR_GRAD
ANCHOR_F64_VAR = {"sum": 78.70736558194623, "abs_sum": 78.70736558194623,
                  "proj": -0.23688432906875484, "proj_abs": 62.488747552658815}
ANCHOR_F64_NLPD = 0.2176898227591378
# relative bars (PERF.md §2): the JAX float32 route's own distance from
# its float64 values (tools/f32_anchors.py's f32_error), rounded up, or 1e-5
# where that is larger.  κ(Kuu) amplifies float32 rounding at this shape, so
# a float32 route that rounds in another order (the card's kernels fuse
# multiply-adds) may lie anywhere within what float32 leaves undetermined.
# "pointwise" holds the card's predictions against the plain float32
# versions' on a CPU copy (the largest difference over the largest value),
# at the JAX float32 predictions' pointwise distance from float64.
TOL_F32 = {"loss": 3.8e-3,
           "grad": {"raw_lengthscales": 0.31, "raw_variance": 0.78,
                    "raw_noise_variance": 1.8e-2},
           "mean": 1e-5, "var": 0.19, "nlpd": 4.4e-4,
           "mean_pointwise": 1.6e-4, "var_pointwise": 8.0e-2}
TOL_F32_VS_F64 = 1e-2  # the float32 loss against ANCHOR_LOSS: a sanity hold
# the launches of a float32 value-and-grad step and of its posterior: the
# JAX package's float32 route (ops._use_pallas), K17-K22
F32_STEP = {"chol_fwd_f32": 2, "tak_fwd_f32": 1, "solve_lower_f32": 1,
            "chol_bwd_f32": 2, "tak_bwd_f32": 1, "solve_upper_t_f32": 1}
F32_POSTERIOR = {"chol_fwd_f32": 2, "tak_fwd_f32": 2, "solve_lower_f32": 1,
                 "solve_upper_t_f32": 1}
# the float32 trainers (phase 6t): the JAX package's float32 runs on a CPU
# (x64 off, the scan recursions; tools/f32_fit_anchors.py --spread 4):
# fit_lbfgs of the float32 GPR1D on Snelson (the defaults: up to 500
# iterations) and at the north star (max_iters=10, curv_rtol=10.0), and
# fit_adam_minibatch's loop at the north star (ADAM_* above) in float32.
# params are (ℓ, σ², noise), raw.  "spread" is each quantity's largest
# relative move when the float32 statistics and the initial parameters move
# by one float32 rounding (4 repeats); the bar is max(10 × spread, 1e-6).
# The counts are held where the spread left them fixed (Snelson: 500
# iterations, not converged; the north star: 10 iterations, not converged;
# the evaluations moved: 1554-1633 and 27-48), and each final loss within
# 10 × the JAX float32 run's own distance from its float64 run (f64)
F32_FITS = {
    "snelson": {"loss": 60.9678955078125, "iters": 500, "converged": False,
                "params": [0.6008453369140625, 0.4865211546421051, -2.495842933654785],
                "spread": {"loss": 0.002188411629615837,
                           "params": [0.11736447513777078, 0.14483341777467987,
                                      0.004207550320376022]},
                "f64": ANCHOR_SNELSON_LOSS},
    "north_star": {"loss": 230472.5, "iters": 10, "converged": False,
                   "params": [-6.9321489334106445, 0.5439996123313904, -2.3705263137817383],
                   "spread": {"loss": 0.0006443284990617101,
                              "params": [0.004825705730658829, 0.019457205094579162,
                                         0.010178112441801569]},
                   "f64": ANCHOR_FIT_LOSS},
}
F32_ADAM = {"loss_1": -131978.5, "loss_last": -229725.5,
            "params": [-7.105610370635986, 0.7393084168434143, -2.4523892402648926],
            "spread": {"loss_1": 0.0049591410722200965, "loss_last": 0.0007552491995882042,
                       "params": [2.2212461862176037e-05, 0.0008741055071629972,
                                  7.680292932205567e-06]},
            "f64": ANCHOR_ADAM_LOSS_20}


_T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line; ``at_s`` is the seconds since the script started."""
    print(json.dumps({"phase": phase, "at_s": round(time.perf_counter() - _T0, 2), **fields}),
          flush=True)


def bench_data(n: int, seed: int):
    """bench.py's generator: ~700 periods on (0.005, 0.995), noise 0.3."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(0.005, 0.995, n)
    y = np.sin(4400.0 * x) + 0.5 * np.sin(1100.0 * x) + 0.3 * rng.randn(n)
    return x, y


def spd_band(k: int, m: int, rng) -> np.ndarray:
    """Random diagonally dominant SPD lower band (k+1, m), right-padded."""
    a = 0.3 * rng.randn(k + 1, m)
    a[0] = np.abs(a[0]) + 2.0 * k + 1.0
    for j in range(1, k + 1):
        a[j, m - j:] = 0.0
    return a


def sym_band(k: int, m: int, rng) -> np.ndarray:
    """Random symmetric lower band (k+1, m), right-padded: a tangent."""
    a = 0.1 * rng.randn(k + 1, m)
    for j in range(1, k + 1):
        a[j, m - j:] = 0.0
    return a


def rel_err(got, ref) -> float:
    ref = ref.detach().to("cpu")
    got = got.detach().to("cpu")
    return float(torch.max(torch.abs(got - ref)) / torch.max(torch.abs(ref)))


def abs_err(got, ref) -> float:
    return float(torch.max(torch.abs(got.detach().cpu() - ref.detach().cpu())))


def rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def cuda_ms(fn, reps: int = REPS) -> dict:
    """Median and all times (ms) of ``fn`` between CUDA events, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end))
    return {"median_ms": float(np.median(ts)), "ms": ts}


def make_model(x, y, m: int, device, dtype=None, backend=None):
    from asvgp_tpu_torch.basis import B3Spline
    from asvgp_tpu_torch.models import GPR1D, Matern32

    return GPR1D(
        (x, y), Matern32(variance=1.0, lengthscales=1e-3), B3Spline(0.0, 1.0, m),
        noise_variance=0.1, device=device, dtype=dtype, backend=backend,
    )


def model_bands(model):
    """The main path's (Kuu, T = ∂Kuu/∂ℓ, P, Kuf·y) at the model's params."""
    from asvgp_tpu_torch.features.spline_features import make_kuu
    from asvgp_tpu_torch.models import Matern

    with torch.no_grad():
        kernel, lik = model._build()
        var, ell = kernel.variance, kernel.lengthscales
        kuu, tan = torch.func.jvp(
            lambda l: make_kuu(Matern(var, l, nu2=model.nu2), model.basis),
            (ell,), (torch.ones_like(ell),),
        )
        p_band = model.kufkfu_band / lik.variance + kuu
    return kuu, tan, p_band, model.kuf_y


def _errs(name, got, ref) -> dict:
    return {f"{name}_rel": max(rel_err(g, r) for g, r in zip(got, ref)),
            f"{name}_abs": max(abs_err(g, r) for g, r in zip(got, ref))}


def kernel_parity(bands) -> dict:
    """Each kernel against its plain version on CPU copies of the same
    inputs, and each chain (K1+K2, K3+K4, K5+mid+K6) against the plain
    chain.  ``bands`` = (kuu, tan, p_band, b) on the card."""
    from asvgp_tpu_torch.banded import core, tan, twist

    kuu, tanb, p_band, b = bands
    dev = kuu.device
    cpu = [t.detach().to("cpu") for t in bands]
    k, m = kuu.shape[0] - 1, kuu.shape[1]
    res = {"k": k, "m": m}

    k1 = core.chol_pair_solve(kuu, p_band, b)
    res |= _errs("chol_pair_solve", k1, core.chol_pair_solve_plain(cpu[0], cpu[2], cpu[3]))
    k2 = core.tak_pair_solve(*k1)
    res |= _errs("tak_pair_solve", k2, core.tak_pair_solve_plain(*[t.cpu() for t in k1]))
    res["chain_core_rel"] = _errs("c", core.factor_takahashi_solve(kuu, p_band, b),
                                  core.factor_takahashi_solve_plain(cpu[0], cpu[2], cpu[3]))["c_rel"]

    k3 = tan.chol_pair_solve_tan(*bands)
    res |= _errs("chol_pair_solve_tan", k3, tan.chol_pair_solve_tan_plain(*cpu))
    k4 = tan.tak_pair_solve_tan(*k3)
    res |= _errs("tak_pair_solve_tan", k4, tan.tak_pair_solve_tan_plain(*[t.cpu() for t in k3]))
    res["chain_tan_rel"] = _errs("c", tan.factor_takahashi_solve_tan(*bands),
                                 tan.factor_takahashi_solve_tan_plain(*cpu))["c_rel"]

    k5 = twist.chol_quad_solve_tan(*bands)
    res |= _errs("chol_quad_solve_tan", k5, twist.chol_quad_solve_tan_plain(*cpu))
    k5_host = [t.cpu() for t in k5]
    _, z, x2, _ = twist.mid_step(*cpu, k5_host[0], k5_host[1], k5_host[4])
    k6 = twist.tak_quad_solve_tan(*k5, z.to(dev), x2.to(dev), m)
    res |= _errs("tak_quad_solve_tan", k6, twist.tak_quad_solve_tan_plain(*k5_host, z, x2, m))
    res["chain_twist_rel"] = _errs("c", twist.factor_takahashi_solve_tan_twist(*bands),
                                   twist.factor_takahashi_solve_tan_twist_plain(*cpu))["c_rel"]
    return res


def check_parity(res: dict, tol: float, where: str) -> None:
    worst = max(v for key, v in res.items() if key.endswith("_rel"))
    if not worst <= tol:
        raise AssertionError(f"kernel parity {where}: {res}")


def adjoint_calls():
    """(kernel, plain version) of K7-K12, each taking the same arguments."""
    from asvgp_tpu_torch.banded import core, single

    return {
        "tak_bwd_vec": (core.tak_bwd_vec, core.tak_bwd_vec_plain),
        "chol_bwd_pair": (core.chol_bwd_pair, core.chol_bwd_pair_plain),
        "chol_fwd": (single.chol_fwd, single.chol_fwd_plain),
        "chol_bwd": (single.chol_bwd, single.chol_bwd_plain),
        "tak_fwd": (single.tak_fwd, single.tak_fwd_plain),
        "tak_bwd": (single.tak_bwd, single.tak_bwd_plain),
    }


def f32_calls():
    """(kernel, plain version) of K13, K14 and K17-K22, each taking the same
    arguments; the wrappers dispatch on the dtype."""
    from asvgp_tpu_torch.banded import single, solve

    return {
        "solve_lower": (solve.solve_lower, solve.solve_lower_plain),
        "solve_upper_t": (solve.solve_upper_t, solve.solve_upper_t_plain),
        "chol_fwd_f32": (single.chol_fwd, single.chol_fwd_plain),
        "chol_bwd_f32": (single.chol_bwd, single.chol_bwd_plain),
        "tak_fwd_f32": (single.tak_fwd, single.tak_fwd_plain),
        "tak_bwd_f32": (single.tak_bwd, single.tak_bwd_plain),
        "solve_lower_f32": (solve.solve_lower, solve.solve_lower_plain),
        "solve_upper_t_f32": (solve.solve_upper_t, solve.solve_upper_t_plain),
    }


def adjoint_parity(calls: dict, table=None) -> dict:
    """Each kernel of ``table`` (default: K7-K12) on the card against its
    plain version on CPU copies of the same inputs; ``calls`` maps a
    kernel's name to the argument lists (tensors on the card) to hold it
    on."""
    res = {}
    for name, arg_lists in calls.items():
        kernel, plain = (table or adjoint_calls())[name]
        errs = [_errs(name, (kernel(*args),), (plain(*[t.cpu() for t in args]),))
                for args in arg_lists]
        res[f"{name}_rel"] = max(e[f"{name}_rel"] for e in errs)
        res[f"{name}_abs"] = max(e[f"{name}_abs"] for e in errs)
    return res


def random_adjoint_inputs(k: int, m: int, rng, device) -> dict:
    """K7-K12's arguments at a random SPD band A = L Lᵀ, S its Takahashi
    band, and random cotangents."""
    from asvgp_tpu_torch.banded import ops

    a = torch.as_tensor(spd_band(k, m, rng), dtype=torch.float64)
    l = ops.cholesky_band_plain(a)
    s = ops.takahashi_inverse_band_plain(l)
    l_bar, s_bar = (torch.as_tensor(rng.randn(k + 1, m)) for _ in range(2))
    a, l, s, l_bar, s_bar = (t.to(device) for t in (a, l, s, l_bar, s_bar))
    iv = (1.0 / l[0]).contiguous()
    return {"tak_bwd_vec": [(l, s, s_bar, iv)], "chol_bwd_pair": [(l, l_bar)],
            "chol_fwd": [(a,)], "chol_bwd": [(l, l_bar)], "tak_fwd": [(l,)],
            "tak_bwd": [(l, s, s_bar)]}


class capture:
    """Context manager: record the arguments of every call of
    ``module.name`` (cloned, in call order) into ``store[name]`` while
    calling through.  It launches nothing itself."""

    def __init__(self, store: dict, module, *names):
        self.store, self.module, self.names = store, module, names
        self.saved = {}

    def __enter__(self):
        for name in self.names:
            fn = self.saved[name] = getattr(self.module, name)
            self.store.setdefault(name, [])

            def spy(*args, _fn=fn, _name=name):
                self.store[_name].append(tuple(t.detach().clone() for t in args))
                return _fn(*args)

            setattr(self.module, name, spy)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.module, name, fn)
        return False


def index_stream(seed: int, steps: int, batch: int, n: int) -> np.ndarray:
    """(steps, batch) minibatch indices drawn with numpy from ``seed``."""
    return np.random.RandomState(seed).randint(0, n, size=(steps, batch))


def timed_runs(device, route: str, want: dict, fn) -> dict:
    """``fn()`` REPS + 1 times, each on fresh counters held exactly to
    ``want``; the first run is the warm-up.  Returns every run's result
    (the first one's is ``out``) and the host-clock seconds of the other
    REPS."""
    from asvgp_tpu_torch.banded import core

    outs, seconds = [], []
    for _ in range(REPS + 1):
        core.reset_counters()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        outs.append(fn())
        torch.cuda.synchronize(device)
        seconds.append(time.perf_counter() - t0)
        launches = read_launches(device, route, want)
    return {"out": outs[0], "outs": outs, "launches": launches, "seconds": seconds[1:]}


def repeat_rel(runs: dict) -> float:
    """The largest relative difference of any run's losses from the first
    run's: 0.0 when the loop repeats bit for bit on the card."""
    first = runs["outs"][0][1]
    return max(float(torch.max(torch.abs(out[1] - first) / torch.abs(first)))
               for out in runs["outs"])


def adam_path(device, x_d, y_d) -> dict:
    """Phases 6a and 6b: one step (loss and gradient) and the 20-step fit of
    ``fit_adam_minibatch`` at the north star, each on fresh counters; the
    arguments K7 and K8 got in the step are kept for phase 6e."""
    from asvgp_tpu_torch.banded import core
    from asvgp_tpu_torch.basis import B3Spline
    from asvgp_tpu_torch.models import Matern32
    from asvgp_tpu_torch.models.gpr1d import default_params
    from asvgp_tpu_torch.train import fit_adam_minibatch
    from asvgp_tpu_torch.train.adam import minibatch_loss

    basis = B3Spline(0.0, 1.0, M)
    params0 = default_params(Matern32(variance=1.0, lengthscales=1e-3), 0.1)
    idx = index_stream(ADAM_INDEX_SEED, ADAM_STEPS, ADAM_BATCH, N)
    idx0 = torch.as_tensor(idx[0], device=device)
    names = {"kernel": {"raw_lengthscales": "raw_lengthscales", "raw_variance": "raw_variance"},
             "likelihood": {"raw_variance": "raw_noise_variance"}}

    args: dict = {}
    core.reset_counters()
    p = {g: {k: torch.tensor(float(v), dtype=torch.float64, device=device, requires_grad=True)
             for k, v in d.items()} for g, d in params0.items()}
    with capture(args, core, "tak_bwd_vec", "chol_bwd_pair"):
        loss = minibatch_loss(basis, 3, N, p, x_d[idx0], y_d[idx0])
        loss.backward()
    step_launches = read_launches(device, "Adam step", dict.fromkeys(ADAM_KERNELS, 1))
    grad1 = {names[g][k]: float(t.grad) for g, d in p.items() for k, t in d.items()}

    def fit():
        return fit_adam_minibatch(basis, 3, x_d, y_d, params0, batch_size=ADAM_BATCH,
                                  steps=ADAM_STEPS, learning_rate=ADAM_LR, indices=idx)

    runs = timed_runs(device, "Adam fit", dict.fromkeys(ADAM_KERNELS, ADAM_STEPS), fit)
    params, losses = runs["out"]
    final = {names[g][k]: float(t) for g, d in params.items() for k, t in d.items()}
    return {
        "loss1": float(loss.detach()), "grad1": grad1, "losses": losses.tolist(),
        "params": final, "args": args, "repeat_rel": repeat_rel(runs),
        "launches": {"step": step_launches, "fit": runs["launches"]},
        "ms_per_step": float(np.median([s * 1e3 / ADAM_STEPS for s in runs["seconds"]])),
        "ms_per_step_all": [s * 1e3 / ADAM_STEPS for s in runs["seconds"]],
    }


def svgp_path(device, x_d, y_d, x_test, y_test) -> dict:
    """Phases 6c and 6d: ``SVGP1D`` and ``fit_svgp`` at the north star's data
    and width, each stage on fresh counters: the C* seeding alone
    (``fit_svgp`` from ``init_params()`` for 0 steps), one step (its K9-K12
    arguments kept for phase 6e), the 20-step fit, the prediction on the
    held-out points, and the same prediction by the plain versions on a
    CPU copy."""
    from asvgp_tpu_torch.banded import core, single
    from asvgp_tpu_torch.basis import B3Spline
    from asvgp_tpu_torch.models import Matern32, SVGP1D, fit_svgp
    from asvgp_tpu_torch.train import nlpd

    def build(dev):
        return SVGP1D(Matern32(variance=1.0, lengthscales=1e-3), B3Spline(0.0, 1.0, M),
                      noise_variance=0.1, num_data=N, device=dev)

    model = build(device)
    idx = index_stream(SVGP_INDEX_SEED, SVGP_STEPS, SVGP_BATCH, N)
    core.reset_counters()
    seeded, _ = fit_svgp(model, x_d, y_d, model.init_params(), steps=0,
                         batch_size=SVGP_BATCH)
    seed_launches = read_launches(device, "SVGP C* seeding", SVGP_SEED)

    args: dict = {}
    idx0 = torch.as_tensor(idx[0], device=device)
    p = {g: ({k: v.clone().requires_grad_() for k, v in d.items()} if isinstance(d, dict)
             else d.clone().requires_grad_()) for g, d in seeded.items()}
    core.reset_counters()
    with capture(args, single, *SVGP_STEP):
        model.training_loss(x_d[idx0], y_d[idx0], p).backward()
    step_launches = read_launches(device, "SVGP step", SVGP_STEP)

    # the fit from the seeded parameters: the same loop as from
    # init_params(), whose seeding gives the same C* bit for bit, so the
    # host clock times the steps alone
    def fit():
        return fit_svgp(model, x_d, y_d, seeded, batch_size=SVGP_BATCH,
                        steps=SVGP_STEPS, learning_rate=SVGP_LR, indices=idx)

    want = {name: SVGP_STEPS * n for name, n in SVGP_STEP.items()}
    runs = timed_runs(device, "SVGP fit", want, fit)
    params, losses = runs["out"]

    xt = torch.as_tensor(x_test, dtype=torch.float64, device=device)
    yt = torch.as_tensor(y_test, dtype=torch.float64, device=device)
    core.reset_counters()
    mean, var = model.predict_f(xt, params=params)
    predict_launches = read_launches(device, "SVGP predict", SVGP_PREDICT)
    core.reset_counters()
    score = float(nlpd(model.predict_log_density((xt, yt), params=params)))
    read_launches(device, "SVGP predict_log_density", SVGP_PREDICT)
    if not (mean.shape == var.shape == (x_test.shape[0], 1)):
        raise AssertionError(f"SVGP predict_f shapes {tuple(mean.shape)}, {tuple(var.shape)}")
    if not (bool(torch.isfinite(mean).all()) and bool(torch.isfinite(var).all())
            and math.isfinite(score)):
        raise AssertionError("non-finite SVGP predictions or NLPD")

    cpu_model = build("cpu")
    cpu_params = {g: ({k: v.cpu() for k, v in d.items()} if isinstance(d, dict) else d.cpu())
                  for g, d in params.items()}
    t0 = time.perf_counter()
    mean_c, var_c = cpu_model.predict_f(torch.as_tensor(x_test), params=cpu_params)
    cpu_s = time.perf_counter() - t0
    return {
        "losses": losses.tolist(), "args": args, "nlpd": score,
        "repeat_rel": repeat_rel(runs),
        "min_var": float(var.min()),
        "mean_rel_vs_cpu": rel_err(mean, mean_c), "var_rel_vs_cpu": rel_err(var, var_c),
        "cpu_plain_predict_s": cpu_s,
        "launches": {"seeding": seed_launches, "step": step_launches, "fit": runs["launches"],
                     "predict": predict_launches},
        "ms_per_step": float(np.median([s * 1e3 / SVGP_STEPS for s in runs["seconds"]])),
        "ms_per_step_all": [s * 1e3 / SVGP_STEPS for s in runs["seconds"]],
    }


def serving_path(device, x, y, x_test, y_test, m: int, batch: int) -> dict:
    """Phases 3 and 4: the serving path on ``device`` with fresh counters."""
    from asvgp_tpu_torch.banded import core
    from asvgp_tpu_torch.stats import compute_stats
    from asvgp_tpu_torch.train import nlpd

    xt = torch.as_tensor(x_test, dtype=torch.float64, device=device)
    yt = torch.as_tensor(y_test, dtype=torch.float64, device=device)
    core.reset_counters()
    model = make_model(x, y, m, device)
    with torch.no_grad():
        loss = float(model.training_loss())
    post = model.posterior()
    mean, var = post.predict_f(xt, batch=batch)
    score = float(nlpd(post.predict_log_density((xt, yt))))
    torch.cuda.synchronize(device)
    launches = dict(core.LAUNCHES)
    plain_calls = dict(core.PLAIN_CALLS)

    if not (mean.shape == var.shape == (x_test.shape[0], 1)):
        raise AssertionError(f"predict_f shapes {tuple(mean.shape)}, {tuple(var.shape)}")
    if not (bool(torch.isfinite(mean).all()) and bool(torch.isfinite(var).all())):
        raise AssertionError("non-finite predictions")
    if not bool((var > 0).all()):
        raise AssertionError(f"non-positive variance: min {float(var.min())}")
    if not math.isfinite(score):
        raise AssertionError(f"NLPD {score} is not finite")

    # the statistics are built in a fixed order of summation: a second build
    # from the same data must give the same bits
    again = compute_stats(
        model.basis,
        torch.as_tensor(x, dtype=torch.float64, device=device),
        torch.as_tensor(y, dtype=torch.float64, device=device),
    )
    stats_repeatable = bool(
        torch.equal(again.kuf_y, model.kuf_y)
        and torch.equal(again.kufkfu_band, model.kufkfu_band)
    )

    # the same posterior from the plain versions, on a CPU copy
    cpu_model = copy.deepcopy(model).to("cpu")
    t0 = time.perf_counter()
    cpu_post = cpu_model.posterior()
    cpu_posterior_s = time.perf_counter() - t0
    mean_c, var_c = cpu_post.predict_f(torch.as_tensor(x_test), batch=batch)
    return {
        "model": model,
        "posterior": post,
        "x_test": xt,
        "loss": loss,
        "nlpd": score,
        "min_var": float(var.min()),
        "mean_rel_vs_cpu": rel_err(mean, mean_c),
        "var_rel_vs_cpu": rel_err(var, var_c),
        "cpu_plain_posterior_s": cpu_posterior_s,
        "stats_repeatable": stats_repeatable,
        "launches": launches,
        "plain_calls": plain_calls,
    }


def value_and_grad(model) -> tuple[float, dict]:
    """training_loss() and its gradient by backward(), on a fresh graph."""
    model.zero_grad(set_to_none=True)
    loss = model.training_loss()
    loss.backward()
    grads = {name: float(getattr(model, name).grad) for name in PARAM_NAMES}
    return float(loss.detach()), grads


def snelson_data():
    X = np.loadtxt(SNELSON_DIR / "train_inputs").reshape(-1, 1)
    y = np.loadtxt(SNELSON_DIR / "train_outputs").reshape(-1, 1)
    return X, y


def read_launches(device, route: str, want: dict) -> dict:
    """The launch counts read just after ``route`` ran on fresh counters.
    Each kernel must have launched exactly as ``want`` says (one not named
    there: never), and no plain version may have run on a CUDA tensor."""
    from asvgp_tpu_torch.banded import core

    torch.cuda.synchronize(device)
    got = {name: core.LAUNCHES.get(name, 0) for name in KERNELS}
    expected = {name: want.get(name, 0) for name in KERNELS}
    if got != expected or core.PLAIN_CALLS.get("cuda", 0) != 0:
        raise AssertionError(f"{route}: launches {got}, expected {expected}; "
                             f"plain calls {dict(core.PLAIN_CALLS)}")
    return got


def route_step(device, model, route: str, want: dict):
    """One value-and-grad step on fresh counters, held to ``want``."""
    from asvgp_tpu_torch.banded import core

    core.reset_counters()
    loss, grads = value_and_grad(model)
    return loss, grads, read_launches(device, route, want)


def fit_runs(device, model, route: str, per_eval: dict, reps: int = REPS, **kwargs) -> dict:
    """``fit_lbfgs`` ``reps`` + 1 times from the model's parameters, each on
    fresh counters: each kernel of ``per_eval`` must launch that many times
    per evaluation and nothing else at all.  The first run is the warm-up;
    the times (host clock, the fit syncs once per evaluation) are of the
    other ``reps``."""
    from asvgp_tpu_torch.banded import core
    from asvgp_tpu_torch.train import fit_lbfgs
    from asvgp_tpu_torch.train.lbfgs import tree_map

    start = model.params()
    runs = []
    for _ in range(reps + 1):
        info = {}
        core.reset_counters()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        params, loss, iters = fit_lbfgs(model.training_loss, start, info=info, **kwargs)
        torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
        launches = read_launches(device, route,
                                 {name: n * info["ls_evals"] for name, n in per_eval.items()})
        runs.append({"params": params, "loss": loss, "iters": iters, "info": info,
                     "s": seconds, "launches": launches})
    first = runs[0]
    ms_per_iter = [r["s"] * 1e3 / r["iters"] for r in runs[1:]]
    return {
        "loss": first["loss"], "iters": first["iters"], "info": first["info"],
        "launches": first["launches"],
        "params": tree_map(float, first["params"]), "params_out": first["params"],
        "losses": [r["loss"] for r in runs], "iter_counts": [r["iters"] for r in runs],
        "eval_counts": [r["info"]["ls_evals"] for r in runs],
        "ms_per_iter": float(np.median(ms_per_iter)), "ms_per_iter_all": ms_per_iter,
    }


def training_path(device, x, y, m: int) -> dict:
    """Phases 5 and 6: the training path on ``device``, each route and fit
    on fresh counters: value and gradient on the twisted route (K5, K6) and
    the single-ended one (K3, K4), the north-star fit, the Snelson fits."""
    from asvgp_tpu_torch.banded import twist_scope
    from asvgp_tpu_torch.basis import B3Spline
    from asvgp_tpu_torch.models import GPR1D, ExactGPR, Matern32

    twisted = ("chol_quad_solve_tan", "tak_quad_solve_tan")
    single = ("chol_pair_solve_tan", "tak_pair_solve_tan")
    model = make_model(x, y, m, device)
    loss_tw, grad_tw, launches_tw = route_step(device, model, "twisted step",
                                               dict.fromkeys(twisted, 1))
    with twist_scope(False):
        loss_se, grad_se, launches_se = route_step(device, model, "single-ended step",
                                                   dict.fromkeys(single, 1))
    fit = fit_runs(device, model, "north-star fit", dict.fromkeys(twisted, 1), max_iters=10,
                   curv_rtol=10.0)

    X, Y = snelson_data()
    snelson = GPR1D((X, Y), Matern32(), B3Spline(-3.5, 10.5, 100), device=device)
    sn_fit = fit_runs(device, snelson, "Snelson fit", dict.fromkeys(twisted, 1))
    exact = ExactGPR((X, Y), Matern32(), device=device)
    ex_fit = fit_runs(device, exact, "exact-GP fit", {})
    return {
        "model": model, "snelson_model": snelson,
        "loss_twist": loss_tw, "grad_twist": grad_tw,
        "loss_single": loss_se, "grad_single": grad_se,
        "launches": {"twisted_step": launches_tw, "single_ended_step": launches_se,
                     "north_star_fit": fit["launches"], "snelson_fit": sn_fit["launches"],
                     "exact_fit": ex_fit["launches"]},
        "fit": fit, "snelson_fit": sn_fit, "exact_fit": ex_fit,
    }


def pair_phase(device, rng, bands) -> dict:
    """Phase 6f: K15 and K23 against their plain versions for k = 1..6 on
    random bands, then each driven on fresh counters at the north star's
    shape: ``banded.cholesky_band_pair`` of Kuu and P with a gradient (K15
    forward, K8 with a batch of two backward), and ``core.tak_bwd_pair`` on
    K1's and K2's outputs for the two matrices (K23 with K1's reciprocal
    pivots).  Returns the errors, the launches and the main-shape
    inputs of each kernel for phase 7."""
    from asvgp_tpu_torch import banded
    from asvgp_tpu_torch.banded import core, ops, single
    from asvgp_tpu_torch.banded.tan import band_weights

    res: dict = {"random": []}
    for k in range(1, 7):
        a, b = (torch.as_tensor(spd_band(k, PARITY_M, rng)) for _ in range(2))
        l2 = torch.stack(single.chol_fwd_pair_plain(a, b))
        s2 = torch.stack([ops.takahashi_inverse_band_plain(x) for x in l2])
        cot = torch.as_tensor(rng.randn(2, k + 1, PARITY_M))
        iv = (1.0 / l2[:, 0]).contiguous()
        got15 = single.chol_fwd_pair(a.to(device), b.to(device))
        got23 = core.tak_bwd_pair(*(t.to(device) for t in (l2, s2, cot, iv)))
        res["random"].append({
            "k": k, **_errs("chol_fwd_pair", got15, single.chol_fwd_pair_plain(a, b)),
            **_errs("tak_bwd_pair", (got23,), (core.tak_bwd_pair_plain(l2, s2, cot, iv),))})
    kuu, _, p_band, b = bands
    kk, m = kuu.shape[0] - 1, kuu.shape[1]
    core.reset_counters()
    kv, pv = kuu.clone().requires_grad_(), p_band.clone().requires_grad_()
    la, lp = banded.cholesky_band_pair(kv, pv)
    (torch.sum(torch.log(la[0])) + torch.sum(torch.log(lp[0]))).backward()
    launches15 = read_launches(device, "pair Cholesky", {"chol_fwd_pair": 1, "chol_bwd_pair": 1})
    with torch.no_grad():
        k1 = core.chol_pair_solve(kuu, p_band, b)
        s_kuu, s_p, _ = core.tak_pair_solve(*k1)
        w = band_weights(kk, m, kuu)
        l2 = torch.stack([k1[0], k1[1]])
        s2 = torch.stack([s_kuu, s_p])
        # banded cotangents at the path's scale: w∘T (T = ∂Kuu/∂ℓ) and w∘Kuu
        cot = torch.stack([w * bands[1], w * kuu]).contiguous()
        iv = k1[2]
    core.reset_counters()
    out23 = core.tak_bwd_pair(l2, s2, cot, iv)
    launches23 = read_launches(device, "pair Takahashi adjoint", {"tak_bwd_pair": 1})
    res["main"] = {
        **_errs("chol_fwd_pair", (la, lp), single.chol_fwd_pair_plain(kuu.cpu(), p_band.cpu())),
        **_errs("tak_bwd_pair", (out23,),
                (core.tak_bwd_pair_plain(*(t.cpu() for t in (l2, s2, cot, iv))),))}
    res["launches"] = {"chol_fwd_pair": launches15["chol_fwd_pair"],
                       "tak_bwd_pair": launches23["tak_bwd_pair"]}
    res["io"] = {"chol_fwd_pair": ((kuu, p_band), (la.detach(), lp.detach())),
                 "tak_bwd_pair": ((l2, s2, cot, iv), (out23,))}
    return res


def random_spd_block(seed: int, b: int, kappa: float) -> np.ndarray:
    """tests/test_pallas_ds_block.py's SPD block: eigenvalues log-spaced
    from 1 down to 1/κ."""
    rng = np.random.RandomState(seed)
    q, _ = np.linalg.qr(rng.randn(b, b))
    return q @ np.diag(np.logspace(0.0, -np.log10(max(kappa, 1.0)), b)) @ q.T


def k16_parity(device) -> dict:
    """Phase 6g: K16 on batches of three random SPD blocks at each B and κ
    against its plain version on a CPU copy, which it must equal bit for
    bit; the strict upper triangles of both outputs must be exactly
    zero."""
    from asvgp_tpu_torch.banded import dense_block

    rows = []
    for b in K16_SIZES:
        for kappa in K16_KAPPAS:
            ms = torch.as_tensor(np.stack([random_spd_block(s, b, kappa) for s in range(3)]))
            got = dense_block.chol_inv_dense(ms.to(device))
            want = dense_block.chol_inv_dense_plain(ms)
            upper_zero = all(bool((torch.triu(g, 1) == 0).all()) for g in got)
            bit_equal = all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
            rows.append({"B": b, "kappa": kappa, "upper_zero": upper_zero,
                         "bit_equal": bit_equal, **_errs("chol_inv_dense", got, want)})
    return {"rows": rows, "bit_equal": all(r["bit_equal"] for r in rows),
            "max_rel_well": max(r["chol_inv_dense_rel"] for r in rows if r["kappa"] <= 1e4),
            "max_rel_ill": max(r["chol_inv_dense_rel"] for r in rows if r["kappa"] > 1e4),
            "upper_zero": all(r["upper_zero"] for r in rows)}


def map_request(device) -> torch.Tensor:
    """The map cell's request (benchmark/entries/map.py's ``request`` at
    D = 2): MAP_GRID² points in the map's row-major order."""
    step = (MAP_HI - MAP_LO) / MAP_GRID
    base = torch.arange(MAP_GRID, dtype=torch.float64, device=device)
    u, v = (MAP_LO + (base + shift) * step for shift in MAP_SHIFT)
    return torch.stack([u[:, None].expand(MAP_GRID, MAP_GRID).reshape(-1),
                        v[None, :].expand(MAP_GRID, MAP_GRID).reshape(-1)], dim=1)


def block_window_phase(device, post) -> dict:
    """Phase 6i's K24 rows: the windows of one map request, taken from
    ``post.predict_f`` (one launch a request) in the map's order and in a
    shuffled order; K24 on them against its plain version on the card, two
    launches bit-equal, the shuffled result the ordered one permuted bit
    for bit.  Returns the errors and both sets of windows."""
    from asvgp_tpu_torch.banded import core
    from asvgp_tpu_torch.banded.block_window import block_window_quad, block_window_quad_plain

    kron = importlib.import_module("asvgp_tpu_torch.models.kron")
    x = map_request(device)
    perm = torch.randperm(x.shape[0], generator=torch.Generator().manual_seed(MAP_SHUFFLE_SEED))
    perm = perm.to(device)
    windows: dict = {}
    core.reset_counters()
    with capture(windows, kron, "block_window_quad"):
        post.predict_f(x)
        post.predict_f(x[perm])
    launches = read_launches(device, "a map request and its shuffled copy",
                             {"block_window_quad": 2})
    ordered, shuffled = windows["block_window_quad"]
    core.reset_counters()
    got, again = block_window_quad(*ordered), block_window_quad(*ordered)
    got_shuffled = block_window_quad(*shuffled)
    read_launches(device, "K24 on the map's windows", {"block_window_quad": 3})
    want = block_window_quad_plain(*ordered)
    torch.cuda.synchronize(device)
    return {"n": x.shape[0], "K": ordered[0].shape[0], "T": ordered[3].shape[1],
            "launches": launches, "bit_equal": bool(torch.equal(got, again)),
            "shuffled_bit_equal": bool(torch.equal(got_shuffled, got[perm])),
            "errs": _errs("block_window_quad", (got,), (want,)),
            "ordered": ordered, "shuffled": shuffled}


def block_window_bound(windows) -> dict:
    """K24's bound on one map request (D = 2): its useful operations, T²
    products and sums a block pair and 3 to weigh and add it (795 a point at
    K = T = 5, benchmark/arith/kron.py's quad_p), at the FP64 rate of its
    scalar fma; against the band entries a window can reach (T − 1 either
    side of the diagonal of each M2 × M2 block), the windows and the output,
    each moved once."""
    sp, v1, c1, v_t, r_t = windows
    K, m1, M2 = sp.shape[:3]
    n, T = v_t.shape
    ops = n * K * (K + 1) // 2 * (2 * T * T + 3)
    reach = K * m1 * M2 * (2 * T - 1) * sp.element_size()
    return bound(ops, reach + tensor_bytes((v1, c1, v_t, r_t)) + n * sp.element_size())


def synthetic_ssh(n: int, seed: int = KRON_SEED):
    """experiments/spatial_2d/ocean_ssh.py's field: long swirls and eddies
    on (0.02, 0.98)², noise 0.15."""
    rng = np.random.RandomState(seed)
    X = rng.uniform(0.02, 0.98, (n, 2))
    u, v = X[:, 0], X[:, 1]
    f = np.sin(9 * u + 3 * v) + 0.6 * np.cos(14 * v) * np.sin(5 * u) + 0.3 * np.sin(31 * u * v + 2)
    return X, (f + 0.15 * rng.randn(n)).reshape(-1, 1)


def stat_summary(a: torch.Tensor) -> dict:
    """tools/kron_anchors.py's summary of one statistic: sum, sum of
    absolute values, sum of squares, and a projection on fixed random
    weights with the sum of its absolute terms."""
    a = a.detach().cpu().numpy()
    w = np.random.RandomState(STAT_SUMMARY_SEED).randn(*a.shape)
    return {"sum": float(a.sum()), "abs_sum": float(np.abs(a).sum()),
            "sumsq": float((a * a).sum()), "proj": float((w * a).sum()),
            "proj_abs": float(np.abs(w * a).sum())}


def stats_errors(got: dict, anchors: dict) -> dict:
    """Each summary against its anchor, relative to the scale of its terms;
    the scalars relative to their anchors."""
    errs = {}
    for name, w in anchors.items():
        g = got[name]
        if isinstance(w, dict):
            errs[name] = max(abs(g["sum"] - w["sum"]) / w["abs_sum"],
                             abs(g["sumsq"] - w["sumsq"]) / w["sumsq"],
                             abs(g["proj"] - w["proj"]) / w["proj_abs"])
        else:
            errs[name] = rel(g, w)
    return errs


def per_dim_value_and_grad(model) -> tuple[float, list]:
    """training_loss() of a model with one kernel per dimension (GPRKron,
    GPRAdditive) and its gradient by backward(), in the JAX package's
    flattening order."""
    model.zero_grad(set_to_none=True)
    loss = model.training_loss()
    loss.backward()
    grads = []
    for var, ell in zip(model.raw_variances, model.raw_lengthscales):
        grads += [float(ell.grad), float(var.grad)]
    return float(loss.detach()), grads + [float(model.raw_noise_variance.grad)]


def synthetic_field_3d(n: int, seed: int = ND_SEED):
    """tools/kron_nd_anchors.py's 3-D field on (0.02, 0.98)³, noise 0.1:
    f = sin(6u + 2v) + ½ cos(5w) sin(4v) + 0.3 sin(11uw + 1)."""
    rng = np.random.RandomState(seed)
    X = rng.uniform(0.02, 0.98, (n, 3))
    u, v, w = X[:, 0], X[:, 1], X[:, 2]
    f = np.sin(6 * u + 2 * v) + 0.5 * np.cos(5 * w) * np.sin(4 * v) + 0.3 * np.sin(11 * u * w + 1)
    return X, (f + 0.1 * rng.randn(n)).reshape(-1, 1)


def kron_path(device, data, n_test: int, d: int, m: int, order: int, ell: float, noise: float,
              step: dict, posterior: dict, fit_reps: int = REPS) -> dict:
    """Phases 6h and 6i (D = 2) or 6r and 6s (D = 3): GPRKron on ``data``
    with the first ``n_test`` points held out, ``d`` × BSplineBasis(0, 1,
    m, order), ``d`` × Matern32(ℓ = ell), each stage on fresh counters: the
    statistics (built twice), one value-and-grad step (the arguments K16
    and K9-K12 got kept) held to ``step``, fit_lbfgs ``fit_reps`` + 1 times,
    the posterior at the fitted parameters held to ``posterior``,
    predictions (K24 once a chunk), MSE and NLPD, and the same predictions
    from a posterior built by the plain versions on a CPU copy."""
    from asvgp_tpu_torch.banded import block, core, single
    from asvgp_tpu_torch.basis import BSplineBasis
    from asvgp_tpu_torch.models import GPRKron, Matern32
    from asvgp_tpu_torch.stats import compute_kron_stats, compute_kron_stats_nd
    from asvgp_tpu_torch.train import mse, nlpd
    from asvgp_tpu_torch.train.lbfgs import tree_map

    X, y = data
    Xtr, ytr = X[n_test:], y[n_test:]
    Xte, yte = X[:n_test], y[:n_test]
    bases = [BSplineBasis(0.0, 1.0, m, order)] * d
    kernels = [Matern32(lengthscales=ell) for _ in range(d)]
    where = f"GPRKron (D = {d})"

    core.reset_counters()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    model = GPRKron((Xtr, ytr), kernels, bases, noise_variance=noise, device=device)
    torch.cuda.synchronize(device)
    build_s = time.perf_counter() - t0
    build_launches = read_launches(device, f"{where} construction", {})
    xtr_d = torch.as_tensor(Xtr, device=device)
    ytr_d = torch.as_tensor(ytr, device=device)
    again = (compute_kron_stats if d == 2 else compute_kron_stats_nd)(bases, xtr_d, ytr_d)
    repeatable = bool(torch.equal(again.kuf_y, model.kuf_y)
                      and torch.equal(again.t_band, model.t_band))
    del again
    summary = {"kuf_y": stat_summary(model.kuf_y), "t_band": stat_summary(model.t_band),
               "yty": float(model.yty), "n": float(model.n)}

    args: dict = {}
    core.reset_counters()
    with capture(args, block, "chol_inv_dense"), capture(args, single, "chol_fwd", "chol_bwd",
                                                        "tak_fwd", "tak_bwd"):
        loss, grad = per_dim_value_and_grad(model)
    step_launches = read_launches(device, f"{where} value-and-grad step", step)

    fit = fit_runs(device, model, f"{where} fit", step, reps=fit_reps, max_iters=10,
                   curv_rtol=10.0)
    params = fit["params_out"]

    core.reset_counters()
    post = model.posterior(params)
    posterior_launches = read_launches(device, f"{where} posterior", posterior)
    core.reset_counters()
    mean, var = post.predict_f(Xte, batch=PREDICT_BATCH)
    log_density = post.predict_log_density((Xte, yte), batch=PREDICT_BATCH)
    yte_d = torch.as_tensor(yte, device=device)
    score_mse, score_nlpd = float(mse(yte_d, mean)), float(nlpd(log_density))
    # predict_f and predict_log_density, each in chunks of PREDICT_BATCH
    predict_launches = read_launches(device, f"{where} predict",
                                     {"block_window_quad": 2 * math.ceil(n_test / PREDICT_BATCH)})
    if not (mean.shape == var.shape == (n_test, 1)):
        raise AssertionError(f"{where} predict_f shapes {tuple(mean.shape)}, {tuple(var.shape)}")
    if not (bool(torch.isfinite(mean).all()) and bool(torch.isfinite(var).all())
            and bool((var > 0).all())):
        raise AssertionError(f"non-finite or non-positive {where} predictions")

    cpu_model = copy.deepcopy(model).to("cpu")
    t0 = time.perf_counter()
    cpu_post = cpu_model.posterior(tree_map(lambda v: v.cpu(), params))
    cpu_posterior_s = time.perf_counter() - t0
    mean_c, var_c = cpu_post.predict_f(Xte, batch=PREDICT_BATCH)
    del cpu_model, cpu_post
    return {
        "model": model, "post": post, "params": params, "x_test": torch.as_tensor(Xte, device=device),
        "xy_train": (xtr_d, ytr_d), "build_s": build_s, "stats_repeatable": repeatable,
        "stats": summary, "loss": loss, "grad": grad, "args": args, "fit": fit,
        "mse": score_mse, "nlpd": score_nlpd, "min_var": float(var.min()),
        "mean_rel_vs_cpu": rel_err(mean, mean_c), "var_rel_vs_cpu": rel_err(var, var_c),
        "cpu_plain_posterior_s": cpu_posterior_s,
        "launches": {"construction": build_launches, "step": step_launches,
                     "fit": fit["launches"], "posterior": posterior_launches,
                     "predict": predict_launches},
    }


def enatl_leg(device) -> dict:
    """Phase 6q: the eNATL60 protocol's torch leg (``ocean_ssh_torch.run``)
    at its defaults with ENATL_ITERS iterations, each stage on fresh
    counters: construction launches nothing, the fit KRON_STEP per
    evaluation, the predict stage ENATL_PREDICT (one posterior serves both
    metrics).  Returns the artifact, the launches and host seconds per
    stage."""
    from asvgp_tpu_torch.banded import core

    spec = importlib.util.spec_from_file_location("ocean_ssh_torch", ENATL_LEG)
    leg = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(leg)
    args = leg.parser().parse_args(["--iters", str(ENATL_ITERS), "--device", str(device)])
    launches, seconds = {}, {}

    @contextlib.contextmanager
    def stage(name):
        core.reset_counters()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize(device)
        seconds[name] = time.perf_counter() - t0
        launches[name] = {n: core.LAUNCHES.get(n, 0) for n in KERNELS}
        if core.PLAIN_CALLS.get("cuda", 0) != 0:
            raise AssertionError(f"eNATL60 leg {name}: plain calls {dict(core.PLAIN_CALLS)}")

    art = leg.run(args, stage=stage)
    evals = art["opt_info"]["ls_evals"]
    want = {"precompute": {}, "optimize": {n: c * evals for n, c in KRON_STEP.items()},
            "predict": ENATL_PREDICT}
    for name, per in want.items():
        expected = {n: per.get(n, 0) for n in KERNELS}
        if launches[name] != expected:
            raise AssertionError(f"eNATL60 leg {name}: launches {launches[name]}, "
                                 f"expected {expected}")
    return {"artifact": art, "launches": launches, "seconds": seconds}


def spread_bar(spread: float) -> float:
    """The float32 trainers' bar: 10 × the JAX run's one-rounding spread,
    or 1e-6 where that is larger."""
    return max(10.0 * spread, 1e-6)


def raw_params(params) -> list:
    """(ℓ, σ², noise), raw, of a 1-D params pytree."""
    return [float(params["kernel"]["raw_lengthscales"]), float(params["kernel"]["raw_variance"]),
            float(params["likelihood"]["raw_variance"])]


def f32_trainers(device, model_ns, x_d, y_d) -> dict:
    """Phase 6t: fit_lbfgs of the float32 GPR1D on Snelson (the defaults)
    and at the north star (``model_ns``, 10 iterations, curv_rtol 10), and
    fit_adam_minibatch(..., dtype=float32) at the north star, each once on
    fresh counters: every evaluation and every Adam step launches F32_STEP
    exactly, nothing else, no plain version; the parameters stay float32.
    Host-clock ms of each run."""
    from asvgp_tpu_torch.banded import core
    from asvgp_tpu_torch.basis import B3Spline
    from asvgp_tpu_torch.models import GPR1D, Matern32
    from asvgp_tpu_torch.models.gpr1d import default_params
    from asvgp_tpu_torch.train import fit_adam_minibatch, fit_lbfgs
    from asvgp_tpu_torch.train.adam import minibatch_loss

    X, Y = snelson_data()
    snelson = GPR1D((X, Y), Matern32(), B3Spline(-3.5, 10.5, 100), device=device,
                    dtype=torch.float32)
    out = {}
    for name, model, kw in (("snelson", snelson, {}),
                            ("north_star", model_ns, {"max_iters": 10, "curv_rtol": 10.0})):
        info = {}
        core.reset_counters()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        params, loss, iters = fit_lbfgs(model.training_loss, model.params(), info=info, **kw)
        torch.cuda.synchronize(device)
        ms = (time.perf_counter() - t0) * 1e3
        launches = read_launches(device, f"float32 {name} fit",
                                 {k: n * info["ls_evals"] for k, n in F32_STEP.items()})
        if not all(t.dtype == torch.float32 for d in params.values() for t in d.values()):
            raise AssertionError(f"float32 {name} fit: parameters left float32")
        out[name] = {"loss": loss, "params": raw_params(params), "iters": iters,
                     "evals": info["ls_evals"], "converged": info["converged"],
                     "grad_norm": info["grad_norm"], "ms": ms, "ms_per_iter": ms / iters,
                     "ms_per_eval": ms / info["ls_evals"], "launches": launches}
    idx = index_stream(ADAM_INDEX_SEED, ADAM_STEPS, ADAM_BATCH, N)
    basis = B3Spline(0.0, 1.0, M)
    params0 = default_params(Matern32(1.0, 1e-3), 0.1)
    ms = []
    for _ in range(2):  # the first run is the warm-up
        core.reset_counters()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        params, losses = fit_adam_minibatch(
            basis, 3, x_d, y_d, params0, batch_size=ADAM_BATCH, steps=ADAM_STEPS,
            learning_rate=ADAM_LR, indices=idx, device=device, dtype=torch.float32)
        torch.cuda.synchronize(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        launches = read_launches(device, "float32 Adam fit",
                                 {k: n * ADAM_STEPS for k, n in F32_STEP.items()})
    if losses.dtype != torch.float32 or not all(
            t.dtype == torch.float32 for d in params.values() for t in d.values()):
        raise AssertionError("float32 Adam: losses or parameters left float32")
    # one float32 step (the batch's statistics, the loss, its gradient) under
    # the profiler: where an Adam step's time goes
    xb = x_d[torch.as_tensor(idx[0], device=device)].float()
    yb = y_d[torch.as_tensor(idx[0], device=device)].float()
    p32 = {g: {k: torch.tensor(float(v), dtype=torch.float32, device=device,
                               requires_grad=True) for k, v in d.items()}
           for g, d in params0.items()}

    def step():
        minibatch_loss(basis, 3, N, p32, xb, yb).backward()

    out["adam"] = {"loss_1": float(losses[0]), "loss_last": float(losses[-1]),
                   "params": raw_params(params), "ms_first": ms[0], "ms": ms[1],
                   "ms_per_step": ms[1] / ADAM_STEPS, "launches": launches,
                   "step_profile": device_profile(step, reps=3)}
    return out


def f32_trainer_errors(runs: dict) -> tuple[dict, list]:
    """Each float32 run against F32_FITS / F32_ADAM: relative errors, and
    what misses its bar (max(10 × spread, 1e-6); the counts where the
    spread fixed them; the final loss within 10 × the JAX float32 run's
    distance from its float64 run)."""
    errs, bad = {}, []
    for name, want in F32_FITS.items():
        got = runs[name]
        e = {"loss": rel(got["loss"], want["loss"]),
             "params": [rel(g, w) for g, w in zip(got["params"], want["params"])],
             "vs_f64": rel(got["loss"], want["f64"]),
             "jax_vs_f64": rel(want["loss"], want["f64"])}
        errs[name] = e
        if not e["loss"] <= spread_bar(want["spread"]["loss"]):
            bad.append(f"{name} loss")
        bad += [f"{name} param {i}" for i, (v, s) in enumerate(zip(e["params"],
                                                                   want["spread"]["params"]))
                if not v <= spread_bar(s)]
        if got["iters"] != want["iters"] or got["converged"] != want["converged"]:
            bad.append(f"{name} counts")
        if not e["vs_f64"] <= 10 * e["jax_vs_f64"]:
            bad.append(f"{name} vs float64")
    got, want = runs["adam"], F32_ADAM
    e = {key: rel(got[key], want[key]) for key in ("loss_1", "loss_last")}
    e["params"] = [rel(g, w) for g, w in zip(got["params"], want["params"])]
    e["vs_f64"], e["jax_vs_f64"] = rel(got["loss_last"], want["f64"]), rel(want["loss_last"],
                                                                           want["f64"])
    errs["adam"] = e
    bad += [f"adam {key}" for key in ("loss_1", "loss_last")
            if not e[key] <= spread_bar(want["spread"][key])]
    bad += [f"adam param {i}" for i, (v, s) in enumerate(zip(e["params"],
                                                             want["spread"]["params"]))
            if not v <= spread_bar(s)]
    if not e["vs_f64"] <= 10 * e["jax_vs_f64"]:
        bad.append("adam vs float64")
    return errs, bad


def dp_phase(device, x_d, y_d, leg_artifact: dict) -> dict:
    """Phase 6u: data parallelism on a world of one rank over NCCL (this
    process, on ``device``): each family's statistics at full width by the
    sharded build (one all_reduce) and without it, which must be equal
    bit for bit, the all_reduce timed alone; two data-parallel Adam steps of
    each family (full batch, num_data_total = N) from the initial
    parameters, each on fresh counters held exactly to the family's step
    launches, each loss bit-equal to the same step without the all_reduce;
    then the eNATL60 leg with --mesh 1 (a rank process of its own), whose
    ELBO, MSE and NLL must equal phase 6q's."""
    import os
    import shutil
    import tempfile

    import torch.distributed as dist

    from asvgp_tpu_torch.banded import core
    from asvgp_tpu_torch.basis import B3Spline, BSplineBasis
    from asvgp_tpu_torch.models import Matern32
    from asvgp_tpu_torch.models.gpr1d import default_params
    from asvgp_tpu_torch.parallel import (
        make_dp_train_step,
        make_dp_train_step_additive,
        make_dp_train_step_kron,
    )
    from asvgp_tpu_torch.stats import (
        all_reduce_stats,
        compute_additive_stats,
        compute_additive_stats_sharded,
        compute_kron_stats,
        compute_kron_stats_sharded,
        compute_stats,
        compute_stats_sharded,
    )

    def per_dim(kernels, noise):
        return {"kernels": [default_params(k)["kernel"] for k in kernels],
                "likelihood": default_params(kernels[0], noise)["likelihood"]}

    Xk, yk = synthetic_ssh(N_KRON + N_KRON_TEST)
    Xa, ya = probe_data(N_ADD, ADD_SEED)
    kron_bases = [BSplineBasis(0.0, 1.0, KRON_M, KRON_ORDER)] * 2
    add_bases = [B3Spline(0.0, 1.0, ADD_M)] * ADD_D
    basis = B3Spline(0.0, 1.0, M)

    def dev(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)

    families = {
        "gpr1d": (x_d, y_d.reshape(-1), lambda x, y: compute_stats(basis, x, y),
                  lambda x, y, g: compute_stats_sharded(basis, x, y, g),
                  lambda g: make_dp_train_step(basis, 3, g, num_data_total=N),
                  default_params(Matern32(1.0, 1e-3), 0.1), dict.fromkeys(ADAM_KERNELS, 1)),
        "kron": (dev(Xk[N_KRON_TEST:]), dev(yk[N_KRON_TEST:]).reshape(-1),
                 lambda x, y: compute_kron_stats(kron_bases, x, y),
                 lambda x, y, g: compute_kron_stats_sharded(kron_bases, x, y, g),
                 lambda g: make_dp_train_step_kron(kron_bases, [3, 3], g, num_data_total=N_KRON),
                 per_dim([Matern32(lengthscales=KRON_ELL)] * 2, KRON_NOISE), KRON_STEP),
        "additive": (dev(Xa), dev(ya).reshape(-1),
                     lambda x, y: compute_additive_stats(add_bases, x, y),
                     lambda x, y, g: compute_additive_stats_sharded(add_bases, x, y, g),
                     lambda g: make_dp_train_step_additive(add_bases, [3] * ADD_D, g,
                                                           num_data_total=N_ADD),
                     per_dim([Matern32(lengthscales=ADD_ELL)] * ADD_D, ADD_NOISE), ADD_STEP),
    }
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    tmp = tempfile.mkdtemp(prefix="asvgp_dp_")
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                            rank=0, world_size=1)
    group = dist.group.WORLD
    out = {"stats": {}, "steps": {}}
    try:
        for name, (x, y, local, sharded, make, params0, per_step) in families.items():
            want = local(x, y)
            core.reset_counters()
            got = sharded(x, y, group)
            read_launches(device, f"{name} sharded statistics", {})
            equal = all(torch.equal(getattr(got, f), getattr(want, f)) for f in vars(want))
            numel = sum(getattr(want, f).numel() for f in vars(want))
            out["stats"][name] = {"n": int(x.shape[0]), "numel": numel, "bit_equal": equal,
                                  "all_reduce_ms": cuda_ms(
                                      lambda w=want: all_reduce_stats(w, group))["median_ms"]}
            step, opt = make(group)
            plain, _ = make(None)
            p, state, p0, state0 = params0, opt.init(params0), params0, opt.init(params0)
            losses, plain_losses, launches, ms = [], [], [], []
            for _ in range(2):
                core.reset_counters()
                torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                p, state, loss = step(p, state, x, y)
                torch.cuda.synchronize(device)
                ms.append((time.perf_counter() - t0) * 1e3)
                launches.append(read_launches(device, f"{name} data-parallel step", per_step))
                p0, state0, loss0 = plain(p0, state0, x, y)
                losses.append(float(loss))
                plain_losses.append(float(loss0))
            out["steps"][name] = {
                "losses": losses, "launches": launches[0], "ms": ms,
                "bit_equal": losses == plain_losses and all(
                    torch.equal(a, b) for a, b in zip(_tree_leaves(p), _tree_leaves(p0)))}
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)

    spec = importlib.util.spec_from_file_location("ocean_ssh_torch", ENATL_LEG)
    leg = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(leg)
    t0 = time.perf_counter()
    art = leg.run_mesh(leg.parser().parse_args(["--iters", str(ENATL_ITERS), "--mesh", "1"]),
                       timeout=900)
    out["leg"] = {"artifact": art, "seconds": time.perf_counter() - t0,
                  "equal": {k: art[k] == leg_artifact[k] for k in ("elbo", "mse", "nll")}}
    return out


def _tree_leaves(tree) -> list:
    from asvgp_tpu_torch.train.lbfgs import _leaves

    return list(_leaves(tree))


def probe_data(n: int, seed: int):
    """tools/additive_probe.py's data (lines 42-45): n points uniform on
    (0.02, 0.98)^ADD_D, y = Σ_d sin((3 + 2d) x_d) + 0.2 ε."""
    rng = np.random.RandomState(seed)
    X = rng.uniform(0.02, 0.98, (n, ADD_D))
    y = sum(np.sin((3 + 2 * d) * X[:, d]) for d in range(ADD_D))
    return X, (y + 0.2 * rng.randn(n)).reshape(-1, 1)


def additive_path(device) -> dict:
    """Phases 6m and 6n: GPRAdditive at ADDITIVE_PROBE.json's shape, each
    stage on fresh counters: the statistics (built twice), one
    value-and-grad step (the arguments K9-K12 and K16 got kept),
    fit_lbfgs REPS + 1 times, the posterior at the fitted parameters,
    predictions on the held-out points, MSE and NLPD, and the same
    predictions from a posterior built by the plain versions on a CPU
    copy."""
    from asvgp_tpu_torch.banded import block, core, single
    from asvgp_tpu_torch.basis import B3Spline
    from asvgp_tpu_torch.models import GPRAdditive, Matern32
    from asvgp_tpu_torch.stats import compute_additive_stats
    from asvgp_tpu_torch.train import mse, nlpd
    from asvgp_tpu_torch.train.lbfgs import tree_map

    Xtr, ytr = probe_data(N_ADD, ADD_SEED)
    Xte, yte = probe_data(N_ADD_TEST, ADD_TEST_SEED)
    bases = [B3Spline(0.0, 1.0, ADD_M)] * ADD_D
    kernels = [Matern32(lengthscales=ADD_ELL) for _ in range(ADD_D)]

    core.reset_counters()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    model = GPRAdditive((Xtr, ytr), kernels, bases, noise_variance=ADD_NOISE, device=device)
    torch.cuda.synchronize(device)
    build_s = time.perf_counter() - t0
    build_launches = read_launches(device, "GPRAdditive construction", {})
    xtr_d = torch.as_tensor(Xtr, device=device)
    ytr_d = torch.as_tensor(ytr, device=device)
    again = compute_additive_stats(bases, xtr_d, ytr_d)
    repeatable = bool(torch.equal(again.kuf_y, model.kuf_y)
                      and torch.equal(again.kufkfu, model.kufkfu))
    del again
    summary = {"kuf_y": stat_summary(model.kuf_y), "kufkfu": stat_summary(model.kufkfu),
               "yty": float(model.yty), "n": float(model.n)}

    args: dict = {}
    core.reset_counters()
    with capture(args, block, "chol_inv_dense"), capture(args, single, "chol_fwd", "chol_bwd",
                                                        "tak_fwd", "tak_bwd"):
        loss, grad = per_dim_value_and_grad(model)
    step_launches = read_launches(device, "GPRAdditive value-and-grad step", ADD_STEP)

    fit = fit_runs(device, model, "GPRAdditive fit", ADD_STEP, max_iters=10, curv_rtol=10.0)
    params = fit["params_out"]

    core.reset_counters()
    post = model.posterior(params)
    posterior_launches = read_launches(device, "GPRAdditive posterior", ADD_POSTERIOR)
    core.reset_counters()
    mean, var = post.predict_f(Xte, batch=PREDICT_BATCH)
    log_density = post.predict_log_density((Xte, yte), batch=PREDICT_BATCH)
    yte_d = torch.as_tensor(yte, device=device)
    score_mse, score_nlpd = float(mse(yte_d, mean)), float(nlpd(log_density))
    predict_launches = read_launches(device, "GPRAdditive predict", {})
    if not (mean.shape == var.shape == (N_ADD_TEST, 1)):
        raise AssertionError(f"GPRAdditive predict_f shapes {tuple(mean.shape)}, "
                             f"{tuple(var.shape)}")
    if not (bool(torch.isfinite(mean).all()) and bool(torch.isfinite(var).all())
            and bool((var > 0).all())):
        raise AssertionError("non-finite or non-positive GPRAdditive predictions")

    cpu_model = copy.deepcopy(model).to("cpu")
    t0 = time.perf_counter()
    cpu_post = cpu_model.posterior(tree_map(lambda v: v.cpu(), params))
    cpu_posterior_s = time.perf_counter() - t0
    mean_c, var_c = cpu_post.predict_f(Xte, batch=PREDICT_BATCH)
    return {
        "model": model, "post": post, "params": params,
        "x_test": torch.as_tensor(Xte, device=device), "xy_train": (xtr_d, ytr_d),
        "build_s": build_s, "stats_repeatable": repeatable, "stats": summary,
        "stats_rel": stats_errors(summary, ANCHOR_ADD_STATS),
        "loss": loss, "grad": grad, "args": args, "fit": fit,
        "mse": score_mse, "nlpd": score_nlpd, "min_var": float(var.min()),
        "mean_rel_vs_cpu": rel_err(mean, mean_c), "var_rel_vs_cpu": rel_err(var, var_c),
        "cpu_plain_posterior_s": cpu_posterior_s,
        "launches": {"construction": build_launches, "step": step_launches,
                     "fit": fit["launches"], "posterior": posterior_launches,
                     "predict": predict_launches},
    }


# ---- phase 6o: the chunk-length rule of the linear sweeps -----------------
# GPRAdditive past the two-chunk limit: ADDITIVE_PROBE.json's data with
# REPAIR_M features a dimension at the additive model's ℓ/δ = 49.4
# (κ(Kuu) = 3.5e6); the step's gradient against the same step with K9-K12
# all plain, each component (1.1e-6 with 64-column chunks), and
# K10, K11 against their plain versions on the step's arguments (were
# 1.4e-11, 1.5e-11)
REPAIR_M = 1000
REPAIR_ELL = ADD_ELL * (ADD_M - 3) / (REPAIR_M - 3)
TOL_REPAIR_GRAD = 1e-8
TOL_REPAIR_SWEEP = 1e-12
# float64's own determination of that gradient, printed beside it: the
# all-plain step whose adjoints take each dimension's factor L perturbed by
# one rounding (1e-16 relative), what another order of operations leaves in
# L, over REPAIR_SEEDS
REPAIR_SEEDS = (0, 1, 2)
# the large-regression protocol's Kuu (B3 × Matérn-5/2, m = 1000, ℓ = 0.05,
# κ = 7.8e9) and its P on make_data(RULE_N, 0) at the model's default noise
# 1.0: every sweep the rule chunks within RULE_SPREAD times the one-chunk
# run's own spread, the plain version's distance when its factors are
# perturbed by one rounding (1e-16 relative; float32 6e-8)
RULE_N, RULE_M, RULE_ELL = 20_000, 1000, 0.05
RULE_SPREAD = 5.0
RULE_EPS = {torch.float64: 1e-16, torch.float32: 6e-8}
# the lengths the rule keeps at the north star (the partitions' own)
RULE_NORTH_STAR = 64


def protocol_leg():
    """experiments/large_regression/synthetic_1m_torch.py, as a module."""
    import importlib.util

    path = Path(__file__).resolve().parent / "experiments" / "large_regression" / \
        "synthetic_1m_torch.py"
    spec = importlib.util.spec_from_file_location("synthetic_1m_torch", path)
    leg = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(leg)
    return leg


def perturbed(t: torch.Tensor, seed: int) -> torch.Tensor:
    """``t`` (on the CPU) times 1 + eps·N(0, 1) entrywise: one rounding."""
    g = torch.Generator().manual_seed(seed)
    noise = torch.randn(t.shape, generator=g, dtype=torch.float64)
    return (t.double() * (1.0 + RULE_EPS[t.dtype] * noise)).to(t.dtype)


def chosen_cols(sweep: str, factors, m: int | None = None) -> dict:
    """The chunk length ``sweep``'s rule chose on the card for ``factors``
    and the numpy copy's (banded/chunk_rule.py) on CPU copies."""
    from asvgp_tpu_torch.banded import chunk_rule, core

    dev = [f.to("cuda") for f in factors]
    card = core.chosen_chunk_cols(sweep, *dev, m=m)
    host = [f.cpu().numpy() for f in factors]
    if sweep == "linear":
        host = list(host[0]) if host[0].ndim == 3 else host
        k, n = host[0].shape[0] - 1, host[0].shape[1]
        lc0 = partition_cols((1, 1), ((k * (k + 1) // 2) ** 2 + k * (k + 1) // 2, 64), n)[1]
        if n <= TWO_CHUNK_COLS:
            return {"card": card, "numpy": None}
        return {"card": card, "numpy": chunk_rule.sweep_cols(host, lc0, chunk_rule.TAU)}
    k = host[0].shape[-2] - 1
    if sweep == "twist":
        from asvgp_tpu_torch.banded.twisted import split_point

        h = split_point(m, k)
        lc0 = twist_chunk_cols(k, m)[1]
        return {"card": card, "numpy": chunk_rule.sweep_cols(list(host[0]), lc0,
                                                             chunk_rule.TAU_TAN, m - h - k)}
    lc0 = (core_chunk_cols if sweep == "core" else tan_chunk_cols)(k, host[0].shape[1])[1]
    tau = chunk_rule.TAU if sweep == "core" else chunk_rule.TAU_TAN
    return {"card": card, "numpy": chunk_rule.sweep_cols(host, lc0, tau)}


def repair_additive(device) -> dict:
    """GPRAdditive at REPAIR_M features a dimension: one value-and-grad step
    with the kernels (the arguments K9-K12 got kept), one with K9-K12 all
    swapped for their plain versions on CPU copies, one with each swapped
    alone, and REPAIR_SEEDS all-plain steps whose adjoints (K10, K12) take
    the factor L perturbed by one rounding (1e-16 relative), as another
    order of operations in the forward sweep leaves it: how far float64
    fixes the gradient at this shape; each of
    K9-K12 against its plain version on the step's first arguments; the
    length the linear sweeps chose for dimension 0's factor."""
    from asvgp_tpu_torch.banded import single
    from asvgp_tpu_torch.basis import B3Spline
    from asvgp_tpu_torch.models import GPRAdditive, Matern32

    X, y = probe_data(N_ADD, ADD_SEED)
    model = GPRAdditive((X, y), [Matern32(lengthscales=REPAIR_ELL) for _ in range(ADD_D)],
                        [B3Spline(0.0, 1.0, REPAIR_M)] * ADD_D, noise_variance=ADD_NOISE,
                        device=device)
    sweeps = ("chol_fwd", "chol_bwd", "tak_fwd", "tak_bwd")
    kernels = {n: getattr(single, n) for n in sweeps}
    plains = {n: getattr(single, f"{n}_plain") for n in sweeps}
    args = {n: [] for n in sweeps}

    def keep(name):
        def fn(*a):
            args[name].append(tuple(t.detach().clone() for t in a))
            return kernels[name](*a)
        return fn

    def plain_on_cpu(name, seed=None):
        calls = iter(range(1_000_000))

        def fn(*a):
            a = [t.cpu() for t in a]
            if seed is not None:  # the adjoint's factor, one perturbation a call
                a[0] = perturbed(a[0], 1000 * seed + next(calls))
            return plains[name](*a).to(device)
        return fn

    def step(plain=(), seed=None):
        try:
            for n in sweeps:
                setattr(single, n, plain_on_cpu(n, seed if n in ("chol_bwd", "tak_bwd") else None)
                        if n in plain else kernels[n])
            return per_dim_value_and_grad(model)
        finally:
            for n in sweeps:
                setattr(single, n, kernels[n])

    def grad_rel(g, ref):
        g, ref = np.asarray(g), np.asarray(ref)
        return float(np.max(np.abs(g - ref) / np.abs(ref)))

    try:
        for n in sweeps:
            setattr(single, n, keep(n))
        loss, grad = per_dim_value_and_grad(model)
    finally:
        for n in sweeps:
            setattr(single, n, kernels[n])
    first = {n: a[0] for n, a in args.items()}
    loss_plain, grad_plain = step(sweeps)
    alone = {n: grad_rel(step((n,))[1], grad_plain) for n in sweeps}
    spread = [grad_rel(step(sweeps, seed)[1], grad_plain) for seed in REPAIR_SEEDS]
    vs_plain = {n: rel_err(kernels[n](*first[n]), plains[n](*[t.cpu() for t in first[n]]))
                for n in sweeps}
    return {"m_per_dim": REPAIR_M, "ell": REPAIR_ELL, "loss": loss, "loss_plain": loss_plain,
            "grad_rel_vs_plain": grad_rel(grad, grad_plain), "grad_rel_one_plain": alone,
            "plain_spread": spread, "kernel_vs_plain": vs_plain,
            "chunk_cols": chosen_cols("linear", [first["tak_fwd"][0]])}


def rule_bands():
    """(Kuu, T = ∂Kuu/∂ℓ, P, Kuf·y) of the large-regression protocol's
    GPR1D at init on make_data(RULE_N, 0), float64 on the CPU."""
    from asvgp_tpu_torch.basis import B3Spline
    from asvgp_tpu_torch.features.spline_features import make_kuu
    from asvgp_tpu_torch.models import GPR1D, Matern

    x, y = protocol_leg().make_data(RULE_N, 0)
    basis = B3Spline(0.0, 1.0, RULE_M)
    model = GPR1D((x, y), Matern(1.0, RULE_ELL, nu2=5), basis, device="cpu")
    with torch.no_grad():
        e = torch.tensor(RULE_ELL, dtype=torch.float64)
        v = torch.tensor(1.0, dtype=torch.float64)
        kuu, tanb = torch.func.jvp(lambda l_: make_kuu(Matern(v, l_, nu2=5), basis),
                                   (e,), (torch.ones_like(e),))
        p = model.kufkfu_band + kuu  # noise 1.0
    return kuu, tanb, p, model.kuf_y


def rule_sweeps(device) -> dict:
    """Each sweep the rule chunks, on the card at the protocol's Kuu and P
    (K7, K8, K10-K12, K23 and, on float32 casts of the factors, K18-K20;
    K2, K4, K6 on their plain producers' outputs), against its plain
    version on a CPU copy, beside the plain version's own move when its
    factors are perturbed by one rounding; and the length each chose."""
    from asvgp_tpu_torch.banded import core, ops, single, tan, twist
    from asvgp_tpu_torch.banded.twisted import split_point

    kuu, tanb, p, b = rule_bands()
    m = kuu.shape[1]
    rng = np.random.RandomState(12)
    out = {}

    def rel_all(got, want):
        got, want = ((t,) if isinstance(t, torch.Tensor) else t for t in (got, want))
        return max(rel_err(g, w) for g, w in zip(got, want, strict=True))

    def hold(name, kernel, plain, args, pert_args, sweep, factors, **kw):
        want = plain(*args)
        got = kernel(*(a.to(device) for a in args))
        spread = rel_all(plain(*pert_args), want)
        out[name] = {"rel": rel_all(got, want), "spread": spread,
                     "chunk_cols": chosen_cols(sweep, factors, **kw)}

    lk, lp = ops.cholesky_band_plain(kuu), ops.cholesky_band_plain(p)
    for dt in (torch.float64, torch.float32):
        tag = "" if dt == torch.float64 else "_f32"
        l = lk.to(dt)
        s = ops.takahashi_inverse_band_plain(l)
        cot = torch.from_numpy(rng.randn(*l.shape)).to(dt)
        lpert = perturbed(l, 99)
        hold("chol_bwd" + tag, single.chol_bwd, single.chol_bwd_plain, (l, cot), (lpert, cot),
             "linear", [l])
        hold("tak_fwd" + tag, single.tak_fwd, single.tak_fwd_plain, (l,), (lpert,),
             "linear", [l])
        hold("tak_bwd" + tag, single.tak_bwd, single.tak_bwd_plain, (l, s, cot),
             (lpert, s, cot), "linear", [l])
    l2 = torch.stack([lk, lp])
    s2 = torch.stack([ops.takahashi_inverse_band_plain(t) for t in (lk, lp)])
    cot2 = torch.from_numpy(rng.randn(*l2.shape))
    iv2 = (1.0 / l2[:, 0]).contiguous()
    l2p = perturbed(l2, 98)
    hold("tak_bwd_vec", core.tak_bwd_vec, core.tak_bwd_vec_plain, (lk, s2[0], cot2[0], iv2[0]),
         (l2p[0], s2[0], cot2[0], iv2[0]), "linear", [lk])
    hold("chol_bwd_pair", core.chol_bwd_pair, core.chol_bwd_pair_plain, (l2, cot2), (l2p, cot2),
         "linear", [l2])
    hold("tak_bwd_pair", core.tak_bwd_pair, core.tak_bwd_pair_plain, (l2, s2, cot2, iv2),
         (l2p, s2, cot2, iv2), "linear", [l2])
    k1 = core.chol_pair_solve_plain(kuu, p, b)
    k1p = (perturbed(k1[0], 97), perturbed(k1[1], 96), *k1[2:])
    hold("tak_pair_solve", core.tak_pair_solve, core.tak_pair_solve_plain, k1, k1p,
         "core", k1[:2])
    k3 = tan.chol_pair_solve_tan_plain(kuu, tanb, p, b)
    k3p = (perturbed(k3[0], 95), perturbed(k3[1], 94), *k3[2:])
    hold("tak_pair_solve_tan", tan.tak_pair_solve_tan, tan.tak_pair_solve_tan_plain, k3, k3p,
         "tan", k3[:2])
    k5 = twist.chol_quad_solve_tan_plain(kuu, tanb, p, b)
    _, z, x2, _ = twist.mid_step(kuu, tanb, p, b, k5[0], k5[1], k5[4])
    k5p = (perturbed(k5[0], 93), *k5[1:])
    z, x2 = z.contiguous(), x2.contiguous()
    hold("tak_quad_solve_tan",
         lambda *a: twist.tak_quad_solve_tan(*a, m),
         lambda *a: twist.tak_quad_solve_tan_plain(*a, m),
         (*k5, z, x2), (*k5p, z, x2), "twist", [k5[0]], m=m)
    out["kuu_kappa"] = float(torch.linalg.cond(lower_band_dense(kuu)))
    out["stream_cols"] = m - split_point(m, 3) - 3
    return out


def lower_band_dense(band: torch.Tensor) -> torch.Tensor:
    """The symmetric dense matrix of a lower band."""
    from asvgp_tpu_torch.banded import lower_band_to_dense

    dense = lower_band_to_dense(band)
    return dense + torch.tril(dense, -1).mT


def north_star_cols(main_bands) -> dict:
    """The lengths the rule chose at the north star (m = 10⁴) for each
    sweep it chunks, on the main path's Kuu and P and the producers'
    outputs."""
    from asvgp_tpu_torch.banded import core, ops, tan, twist

    kuu, tanb, p, b = main_bands
    m = kuu.shape[1]
    lk, lp = (ops.cholesky_band_plain(t.cpu()) for t in (kuu, p))
    k1 = core.chol_pair_solve(kuu, p, b)
    k3 = tan.chol_pair_solve_tan(*main_bands)
    k5 = twist.chol_quad_solve_tan(*main_bands)
    return {"linear_kuu": chosen_cols("linear", [lk]), "linear_p": chosen_cols("linear", [lp]),
            "linear_kuu_f32": chosen_cols("linear", [lk.float()]),
            "tak_pair_solve": chosen_cols("core", k1[:2]),
            "tak_pair_solve_tan": chosen_cols("tan", k3[:2]),
            "tak_quad_solve_tan": chosen_cols("twist", [k5[0]], m=m)}


# ---- phase 6p: the large-regression protocol at full width ---------------
# the torch leg's run_split (experiments/large_regression/synthetic_1m_torch.py)
# on make_data(10⁶, 0), 95/5 split, B3 × m = 1000, Matérn-5/2 at ℓ = 0.05,
# noise 1.0 (κ(Kuu) = 7.8e9), only the counts cut: fit_lbfgs 10 iterations
# without restarts, Adam 20 steps at batch 4096 on RandomState(2) indices,
# SVGP 20 steps at batch 100 on RandomState(3), VFF with 100 frequencies
# (m = 201) and a 10-iteration fit
LR_N, LR_M, LR_SEED = 1_000_000, 1000, 0
LR_ADAM = {"steps": 20, "batch": 4096, "index_seed": 2}
LR_SVGP = {"steps": 20, "batch": 100, "index_seed": 3}
# the JAX package on a CPU in float64, set_impl("scan")
# (tools/large_regression_anchors.py): GPR1D's loss and gradient (ℓ, σ²,
# noise) at init, its 10-iteration fit (loss, iterations, evaluations),
# NLPD and MSE on the 5·10⁴ held-out points; Adam's and SVGP's step-1 and
# step-20 losses; VFF's loss, gradient, fit, NLPD and MSE
ANCHOR_LR = {
    "loss": 925000.2615772524,
    "grad": (8770.170103850107, 5767.706927633629, 267509.52907025535),
    "fit": 639367.6438254892, "fit_iters": 10, "fit_evals": 38,
    "nlpd": 0.6681685311262755, "mse": 0.08984610987469131,
    "adam": (924722.63249443, 869065.6845341403),
    "svgp": (1088121.8855550557, 1195282.2364916536),
    "vff_loss": 941727.0070194807,
    "vff_grad": (25898.450151544, 16298.747990050144, 256944.94342445538),
    "vff_fit": 247867.4489940568, "vff_fit_iters": 10, "vff_fit_evals": 17,
    "vff_nlpd": 0.2232888032060818, "vff_mse": 0.08986251934838763,
}
# relative bars (PERF.md §2): GPRKron's and phase 6's (loss 1e-9, gradient
# 1e-8 each, fits 1e-8 in the same counts, NLPD and MSE 1e-8, Adam and SVGP
# losses 1e-9), raised to 10× the JAX package's own spread where
# tools/large_regression_anchors.py --spread finds that larger.  At κ(Kuu)
# = 7.8e9 Kuu perturbed by 1e-15 relative, the statistics by 1e-15, every
# banded factor by one rounding, or only the factors the adjoints see,
# move its GPR1D loss by up to 8.8e-8, the gradient 5.7e-5 / 8.5e-6 /
# 1.9e-7 (ℓ, σ², noise), the 10-iteration fit 1.9e-5 (its evaluations from
# 38 to 39-70), NLPD 1.9e-5, Adam's losses 9.0e-8 / 7.1e-8 (steps 1, 20),
# SVGP's 6.6e-8 / 2.0e-7; VFF's values move ≤ 2.3e-14 and keep GPRKron's
# bars, its fit its counts.  The GPR1D fit is held to its iterations, not
# its evaluations
TOL_LR = {"loss": 8.8e-7, "grad": (5.7e-4, 8.5e-5, 1.9e-6), "fit": 1.9e-4, "nlpd": 1.9e-4,
          "mse": 1e-8, "adam": (9.0e-7, 7.1e-7), "svgp": (6.6e-7, 2.0e-6), "vff_loss": 1e-9,
          "vff_grad": 1e-8, "vff_fit": 1e-8, "vff_nlpd": 1e-8, "vff_mse": 1e-8}
# launches of each stage: the fit's per evaluation (the twisted route), the
# others in all; VFF launches none of K1-K23
LR_FIT_PER_EVAL = {"chol_quad_solve_tan": 1, "tak_quad_solve_tan": 1}
LR_STAGES = {
    "precompute": {},
    "predict": {"chol_pair_solve": 2, "tak_pair_solve": 2},
    "adam": {n: LR_ADAM["steps"] for n in ADAM_KERNELS},
    "svgp": {n: c * LR_SVGP["steps"] + SVGP_SEED.get(n, 0) for n, c in SVGP_STEP.items()},
    "svgp_predict": {n: 2 * c for n, c in SVGP_PREDICT.items()},
    "vff_precompute": {}, "vff_fit": {}, "vff_predict": {},
}


def protocol_path(device) -> dict:
    """Phase 6p: one split of the large-regression protocol through the torch
    leg's ``run_split``, each stage on fresh counters (its launches read just
    after it, its time by the host clock and CUDA events); then, on the
    leg's own GPR1D, the loss and gradient at init and the times of a
    value-and-grad step, the posterior and the prediction; and VFF's loss
    and gradient at init."""
    from asvgp_tpu_torch.banded import core

    leg = protocol_leg()
    args = leg.parser().parse_args([])
    for key, value in dict(n=LR_N, m=LR_M, iters=10, restarts=0, adam_baseline=True,
                           adam_steps=LR_ADAM["steps"], batch=LR_ADAM["batch"],
                           svgp_baseline=True, svgp_steps=LR_SVGP["steps"],
                           svgp_batch=LR_SVGP["batch"], vff_baseline=True,
                           vff_frequencies=100, device=str(device)).items():
        setattr(args, key, value)
    n_train = LR_N - LR_N // 20
    idx = {"adam": index_stream(LR_ADAM["index_seed"], LR_ADAM["steps"], LR_ADAM["batch"],
                                n_train),
           "svgp": index_stream(LR_SVGP["index_seed"], LR_SVGP["steps"], LR_SVGP["batch"],
                                n_train)}
    stages = {}

    class Stage:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            core.reset_counters()
            torch.cuda.synchronize(device)
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)
            self.t0 = time.perf_counter()
            self.start.record()
            return self

        def __exit__(self, *exc):
            self.end.record()
            torch.cuda.synchronize(device)
            if exc[0] is None:
                stages[self.name] = {
                    "host_ms": (time.perf_counter() - self.t0) * 1e3,
                    "event_ms": self.start.elapsed_time(self.end),
                    "launches": {n: c for n, c in core.LAUNCHES.items() if c},
                    "plain_on_cuda": core.PLAIN_CALLS.get("cuda", 0)}
            return False

    record = {}
    row = leg.run_split(args, LR_SEED, indices=idx, stage=Stage, record=record)
    errors = {k: v for k, v in row.items() if k.endswith("_error")}
    if errors:
        raise AssertionError(f"a baseline of the protocol failed: {errors}")
    evals = record["fit_info"]["ls_evals"]
    want = dict(LR_STAGES, fit={n: c * evals for n, c in LR_FIT_PER_EVAL.items()})
    for name, w in want.items():
        got = stages[name]
        if got["launches"] != w or got["plain_on_cuda"]:
            raise AssertionError(f"protocol stage {name}: launches {got['launches']}, "
                                 f"expected {w}; plain calls {got['plain_on_cuda']}")

    model, fitted = record["model"], record["params"]
    model.load_jax_params(model.init_params())
    core.reset_counters()
    loss, grads = value_and_grad(model)
    read_launches(device, "protocol value-and-grad step",
                  {n: c for n, c in LR_FIT_PER_EVAL.items()})
    times = {"step": cuda_ms(lambda: value_and_grad(model))}
    model.load_jax_params(fitted)
    post = model.posterior()
    x_test = torch.as_tensor(leg.make_data(LR_N, LR_SEED)[0][: LR_N // 20], device=device)
    times["posterior"] = cuda_ms(model.posterior)
    times["predict"] = cuda_ms(lambda: post.predict_f(x_test))
    vff = record["vff"]
    vff.zero_grad(set_to_none=True)
    vff.load_jax_params(vff.init_params())
    vff_loss = vff.training_loss()
    vff_loss.backward()
    vff_grad = [float(getattr(vff, n).grad) for n in PARAM_NAMES]
    return {
        "row": row, "stages": stages, "times": times,
        "loss": loss, "grad": [grads[n] for n in PARAM_NAMES],
        "fit": row["elbo"] * -1.0, "fit_iters": row["iters"], "fit_evals": evals,
        "nlpd": row["nlpd"], "mse": row["mse"],
        "adam": [float(record["adam_losses"][0]), float(record["adam_losses"][-1])],
        "svgp": [float(record["svgp_losses"][0]), float(record["svgp_losses"][-1])],
        "vff_loss": float(vff_loss.detach()), "vff_grad": vff_grad,
        "vff_fit": row["elbo_vff"] * -1.0, "vff_fit_iters": int(record["vff_iters"]),
        "vff_fit_evals": record["vff_info"]["ls_evals"],
        "vff_nlpd": row["nlpd_vff"], "vff_mse": row["mse_vff"],
    }


def protocol_errors(lr: dict) -> dict:
    """Each value of phase 6p against its anchor, relative: a scalar, or
    each component of a gradient or of the two-step losses."""
    out = {}
    for key in TOL_LR:
        got, want = lr[key], ANCHOR_LR[key]
        if isinstance(want, tuple):
            out[key] = [rel(g, w) for g, w in zip(got, want, strict=True)]
        else:
            out[key] = rel(got, want)
    return out


def protocol_misses(errs: dict) -> dict:
    """The values of phase 6p beyond their bars (TOL_LR: one bar, or one a
    component)."""
    out = {}
    for key, err in errs.items():
        tol = TOL_LR[key]
        if isinstance(err, list):
            tols = tol if isinstance(tol, tuple) else (tol,) * len(err)
            if any(not e <= t for e, t in zip(err, tols, strict=True)):
                out[key] = err
        elif not err <= tol:
            out[key] = err
    return out


def random_f32_inputs(k: int, m: int, rng, device) -> dict:
    """K13/K14's and K17-K22's arguments at a random SPD band A = L Lᵀ, S
    its Takahashi band, random cotangents and right-hand sides (a vector
    and SOLVE_RHS columns); the float32 ones rounded once from float64."""
    from asvgp_tpu_torch.banded import ops

    a = torch.as_tensor(spd_band(k, m, rng), dtype=torch.float64)
    l = ops.cholesky_band_plain(a)
    s = ops.takahashi_inverse_band_plain(l)
    l_bar, s_bar = (torch.as_tensor(rng.randn(k + 1, m)) for _ in range(2))
    bv, bm = torch.as_tensor(rng.randn(m)), torch.as_tensor(rng.randn(m, SOLVE_RHS))
    l64, bv64, bm64 = (t.to(device) for t in (l, bv, bm))
    a32, l32, s32, lb32, sb32, bv32, bm32 = (
        t.to(device, torch.float32) for t in (a, l, s, l_bar, s_bar, bv, bm))
    return {"solve_lower": [(l64, bv64), (l64, bm64)],
            "solve_upper_t": [(l64, bv64), (l64, bm64)],
            "chol_fwd_f32": [(a32,)], "chol_bwd_f32": [(l32, lb32)],
            "tak_fwd_f32": [(l32,)], "tak_bwd_f32": [(l32, s32, sb32)],
            "solve_lower_f32": [(l32, bv32), (l32, bm32)],
            "solve_upper_t_f32": [(l32, bv32), (l32, bm32)]}


def f32_tol(name: str) -> float:
    """Phase 6j's bar for kernel ``name`` (K13/K14 and K17-K22)."""
    if not name.endswith("_f32"):
        return TOL_PARITY_ADJOINT
    return TOL_F32_ADJOINT if name in F32_ADJOINTS else TOL_F32_FWD


def check_each(res: dict, tol_of, where: str) -> None:
    """Every ``<name>_rel`` of ``res`` within ``tol_of(name)``."""
    bad = {key: v for key, v in res.items()
           if key.endswith("_rel") and not v <= tol_of(key.removesuffix("_rel"))}
    if bad:
        raise AssertionError(f"kernel parity {where}: {bad}")


def solve_function_parity(device, rng) -> dict:
    """The solves' autograd Functions on the card (forward, then the
    gradient in L and b: each backward is the other solve's kernel) against
    torch.autograd through the plain loops on a CPU, in float64 and in
    float32, at k = 3, m = PARITY_M."""
    from asvgp_tpu_torch import banded
    from asvgp_tpu_torch.banded import ops

    l = ops.cholesky_band_plain(torch.as_tensor(spd_band(3, PARITY_M, rng)))
    b, cot = torch.as_tensor(rng.randn(PARITY_M)), torch.as_tensor(rng.randn(PARITY_M))
    res = {}
    for dtype, suffix in ((torch.float64, ""), (torch.float32, "_f32")):
        for name, fn, plain in (
                ("solve_lower_band", banded.solve_lower_band, ops.solve_lower_band_plain),
                ("solve_upper_band_transpose", banded.solve_upper_band_transpose,
                 ops.solve_upper_band_transpose_plain)):
            def run(f, dev):
                lv = l.to(dev, dtype).requires_grad_()
                bv = b.to(dev, dtype).requires_grad_()
                x = f(lv, bv)
                return (x,) + torch.autograd.grad(x, (lv, bv), cot.to(dev, dtype))

            res[f"{name}{suffix}_rel"] = max(
                rel_err(g, w) for g, w in zip(run(fn, device), run(plain, "cpu")))
    return res


def solve_north_star(device, bands) -> dict:
    """Phase 6j at the north star: banded.cholesky_solve_band on L_P =
    chol(P) and Kuf·y on fresh counters (K9, K13, K14 once each) against
    banded_posterior's u (K1 + K2); K13 and K14 against their plain versions
    on the arguments they got there."""
    from asvgp_tpu_torch import banded
    from asvgp_tpu_torch.banded import core, solve

    kuu, _, p_band, b = bands
    args: dict = {}
    with torch.no_grad():
        core.reset_counters()
        l_p = banded.cholesky_band(p_band)
        with capture(args, solve, "solve_lower", "solve_upper_t"):
            u = banded.cholesky_solve_band(l_p, b)
        launches = read_launches(device, "cholesky_solve_band at the north star",
                                 {"chol_fwd": 1, "solve_lower": 1, "solve_upper_t": 1})
        u_ref = banded.banded_posterior(kuu, p_band, b)[2]
    return {"u_rel": rel_err(u, u_ref), "launches": launches, "args": args,
            "main": adjoint_parity(args, f32_calls())}


def solve_edge_parity(device, rng) -> dict:
    """Phase 6j: K13, K21, K14 and K22 on random SPD bands at SOLVE_EDGES
    against their plain versions on CPU copies, at phase 6j's random-band
    bars."""
    from asvgp_tpu_torch.banded import ops, solve

    rows = []
    for k, m, r in SOLVE_EDGES:
        l = ops.cholesky_band_plain(torch.as_tensor(spd_band(k, m, rng)))
        b = torch.as_tensor(rng.randn(m) if r == 1 else rng.randn(m, r))
        row = {"k": k, "m": m, "r": r}
        for dtype, suffix in ((torch.float64, ""), (torch.float32, "_f32")):
            lh, bh = l.to(dtype), b.to(dtype)
            for name, fn, plain in (
                    ("solve_lower", solve.solve_lower, solve.solve_lower_plain),
                    ("solve_upper_t", solve.solve_upper_t, solve.solve_upper_t_plain)):
                got = fn(lh.to(device), bh.to(device))
                row |= _errs(name + suffix, (got,), (plain(lh, bh),))
        rows.append(row)
    return {"rows": rows,
            **{f"{n}_rel": max(r[f"{n}_rel"] for r in rows) for n in SOLVES}}


def solve_maps(name: str, l_band: torch.Tensor, b: torch.Tensor) -> dict:
    """The chunks of solve ``name`` (K13/K21 or K14/K22) on (L, b) and the
    largest entry of their composed maps: one direct launch of the C entry
    point (not counted) with a workspace kept here, whose first
    (chunks − 1)·k² entries are the maps' homogeneous parts H_j
    (csrc/banded_solve.cu)."""
    from asvgp_tpu_torch.banded import _build
    from asvgp_tpu_torch.banded.single import route

    lib = _build.load()
    k, m = l_band.shape[0] - 1, l_band.shape[1]
    r = 1 if b.ndim == 1 else b.shape[1]
    n = lib.asvgp_solve_workspace(k, m, r)
    maps = n // (k * (k + 2 * r))
    if maps == 0:
        return {"chunks": 1, "h_max": 0.0}
    ws = l_band.new_empty(n)
    x = torch.empty_like(b)
    _, entry = route(name, l_band)
    with torch.cuda.device(l_band.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, entry)(k, m, r, l_band.data_ptr(), b.data_ptr(), x.data_ptr(),
                                 ws.data_ptr(), stream)
    _build.check(lib, rc, entry)
    return {"chunks": maps + 1, "h_max": float(ws[: maps * k * k].abs().max())}


def adjoint_edge_parity(device, rng) -> dict:
    """Phase 2: the partitioned adjoints on random SPD bands at
    ADJOINT_EDGES against their plain versions on CPU copies, at the
    random-band bars: one matrix K10, K12, their float32 forms K18, K20
    (the float32 inputs rounded once from float64), K7 and K8; two K8 and
    K23."""
    from asvgp_tpu_torch.banded import core, ops, single

    rows = []
    for k, m, nb in ADJOINT_EDGES:
        ls = [ops.cholesky_band_plain(torch.as_tensor(spd_band(k, m, rng))) for _ in range(nb)]
        l = torch.stack(ls)
        s = torch.stack([ops.takahashi_inverse_band_plain(x) for x in ls])
        l_bar, s_bar = (torch.as_tensor(rng.randn(nb, k + 1, m)) for _ in range(2))
        iv = (1.0 / l[:, 0]).contiguous()
        row = {"k": k, "m": m, "nb": nb}

        def hold(name, fn, plain, *args):
            row.update(_errs(name, (fn(*[t.to(device) for t in args]),), (plain(*args),)))

        if nb == 1:
            hold("chol_bwd_pair", core.chol_bwd_pair, core.chol_bwd_pair_plain, l[0], l_bar[0])
            hold("tak_bwd_vec", core.tak_bwd_vec, core.tak_bwd_vec_plain,
                 l[0], s[0], s_bar[0], iv[0])
            for dtype, suffix in ((torch.float64, ""), (torch.float32, "_f32")):
                lh, sh, lbh, sbh = (t.to(dtype) for t in (l[0], s[0], l_bar[0], s_bar[0]))
                hold("chol_bwd" + suffix, single.chol_bwd, single.chol_bwd_plain, lh, lbh)
                hold("tak_bwd" + suffix, single.tak_bwd, single.tak_bwd_plain, lh, sh, sbh)
        else:
            hold("chol_bwd_pair", core.chol_bwd_pair, core.chol_bwd_pair_plain, l, l_bar)
            hold("tak_bwd_pair", core.tak_bwd_pair, core.tak_bwd_pair_plain, l, s, s_bar, iv)
        rows.append(row)
    return {"rows": rows,
            **{f"{n}_rel": max(r[f"{n}_rel"] for r in rows if f"{n}_rel" in r)
               for n in ADJOINTS}}


def rule_maps(ws: torch.Tensor, n: int, walk: int) -> tuple[int, int]:
    """(chunk length, maps) a sweep's chunk-length rule chose, from the
    workspace of n elements it ran with (the length sits in its last
    element, csrc/forward_sweeps.cuh) on a walk of ``walk`` positions."""
    lc = int(ws[n - 1:n].view(torch.int32)[0])
    return lc, -(-walk // lc) - 1


def adjoint_maps(args) -> dict:
    """The chunks of an adjoint (K7, K8, K10, K12, K18, K20, K23) on its
    wrapper's arguments ``args`` and the largest entry of their composed
    maps: one direct launch of the C entry point (not counted) with a
    workspace kept here, whose first nb·(chunks − 1)·D² entries are the
    maps' homogeneous parts H_j, D = k(k+1)/2 (csrc/banded_adjoint.cu).
    Two arguments are (L, L̄) of the Cholesky adjoint, three or four (L, S,
    S̄[, 1/diag L]) of the Takahashi one; the maps depend on L (and
    1/diag L) alone."""
    from asvgp_tpu_torch.banded import _build

    lib = _build.load()
    l_band = args[0]
    nb = 1 if l_band.ndim == 2 else l_band.shape[0]
    k, m = l_band.shape[-2] - 1, l_band.shape[-1]
    d = k * (k + 1) // 2
    n = lib.asvgp_carry_workspace(k, m, nb)
    maps = n // (nb * (d * d + 2 * d))
    if maps == 0:
        return {"chunks": 1, "h_max": 0.0}
    ws = l_band.new_empty(n)
    out = torch.empty_like(l_band)
    suffix = "_f32" if l_band.dtype == torch.float32 else ""
    if len(args) == 2:
        entry, ptrs = "asvgp_chol_bwd", (args[0].data_ptr(), args[1].data_ptr())
    else:
        iv = args[3].data_ptr() if len(args) == 4 else None
        entry, ptrs = "asvgp_tak_bwd", (*(t.data_ptr() for t in args[:3]), iv)
    with torch.cuda.device(l_band.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, entry + suffix)(k, m, nb, *ptrs, out.data_ptr(), ws.data_ptr(), stream)
    _build.check(lib, rc, entry + suffix)
    lc, used = rule_maps(ws, n, m) if m > TWO_CHUNK_COLS else (None, maps)
    h = ws[: nb * maps * d * d].view(nb, maps, d * d)[:, :used]
    return {"chunks": used + 1, "lc": lc, "h_max": float(h.abs().max()) if used else 0.0}


def adjoint_maps_of(calls: dict) -> dict:
    """adjoint_maps of every captured call, by wrapper: the chunks and the
    largest entry over its calls, and each call's."""
    out = {}
    for name, arg_lists in calls.items():
        each = [adjoint_maps(args) for args in arg_lists]
        out[name] = {"chunks": each[0]["chunks"], "h_max": max(e["h_max"] for e in each),
                     "h_max_each": [e["h_max"] for e in each]}
    return out


def first_chunk_equal(fn, bands, down: bool, first: int = FIRST_CHUNK,
                      band_outputs=None) -> bool:
    """Whether the first ``first`` columns of the walk of ``fn`` (a forward
    sweep's wrapper) over ``bands`` (its band and vector arguments) on the
    card (columns 0.. of the Cholesky walking up, ..m-1 of the Takahashi
    walking down) equal bit for bit the same wrapper on those columns
    alone, where the kernel runs one pass, the one-chain recursion.  Of the
    Cholesky's outputs at the indices ``band_outputs`` (all by default),
    its factors' bands, the entries in rows past those columns are left
    out; every other output is compared whole."""
    m = bands[0].shape[-1]
    c = min(first, m)
    cut = (lambda x: x[..., m - c:]) if down else (lambda x: x[..., :c])
    full = fn(*bands)
    one = fn(*(cut(x).contiguous() for x in bands))
    full, one = ((t,) if isinstance(t, torch.Tensor) else t for t in (full, one))
    band_outputs = range(len(one)) if band_outputs is None else band_outputs

    def equal(j, f, o):
        if down or j not in band_outputs:
            return torch.equal(cut(f), o)
        inside = (torch.arange(o.shape[0])[:, None] + torch.arange(c)[None] < c).to(o.device)
        return torch.equal(cut(f)[inside], o[inside])

    return all(equal(j, f, o) for j, (f, o) in enumerate(zip(full, one)))


def forward_edge_parity(device, rng) -> dict:
    """Phase 2: the partitioned forward sweeps on random SPD bands at
    FORWARD_EDGES against their plain versions on CPU copies, at the
    random-band bars: one matrix K9, K11 and their float32 forms K17, K19
    (the float32 inputs rounded once from float64), two K15; and each
    walk's first chunk against the kernel on that chunk alone."""
    from asvgp_tpu_torch.banded import ops, single

    rows = []
    for k, m, nb in FORWARD_EDGES:
        a = [torch.as_tensor(spd_band(k, m, rng)) for _ in range(nb)]
        row = {"k": k, "m": m, "nb": nb}
        if nb == 2:
            got = single.chol_fwd_pair(*(x.to(device) for x in a))
            row |= _errs("chol_fwd_pair", got, single.chol_fwd_pair_plain(*a))
            row["first_chunk_equal"] = first_chunk_equal(
                single.chol_fwd_pair, [x.to(device) for x in a], False)
        else:
            l = ops.cholesky_band_plain(a[0])
            equal = []
            for dtype, suffix in ((torch.float64, ""), (torch.float32, "_f32")):
                ah, lh = a[0].to(dtype), l.to(dtype)
                row |= _errs("chol_fwd" + suffix, (single.chol_fwd(ah.to(device)),),
                             (single.chol_fwd_plain(ah),))
                row |= _errs("tak_fwd" + suffix, (single.tak_fwd(lh.to(device)),),
                             (single.tak_fwd_plain(lh),))
                equal += [first_chunk_equal(single.chol_fwd, [ah.to(device)], False),
                          first_chunk_equal(single.tak_fwd, [lh.to(device)], True)]
            row["first_chunk_equal"] = all(equal)
        rows.append(row)
    return {"rows": rows, "first_chunk_equal": all(r["first_chunk_equal"] for r in rows),
            **{f"{n}_rel": max(r[f"{n}_rel"] for r in rows if f"{n}_rel" in r)
               for n in FORWARDS}}


def forward_maps(name: str, args) -> dict:
    """The chunks of forward sweep ``name`` on its wrapper's arguments
    ``args``: one direct launch of the C entry point (not counted) with a
    workspace kept here (csrc/banded_adjoint.cu).  The Takahashi sweep
    (K11, K19; one factor L): the largest entry of its composed maps, the
    first (chunks − 1)·D² entries.  The Cholesky sweep (K9, K17; K15 with
    two bands): the largest entry of the walked Schur-complement updates W
    and the smallest singular value of I − W_c P_c over the chunks c whose
    W is not 0, P_c = U Uᵀ from the chunk's triple."""
    from asvgp_tpu_torch.banded import _build

    lib = _build.load()
    band = args[0] if len(args) == 1 else torch.stack(args)
    nb = 1 if band.ndim == 2 else band.shape[0]
    k, m = band.shape[-2] - 1, band.shape[-1]
    d = k * (k + 1) // 2
    chol = name.startswith("chol")
    n = (lib.asvgp_schur_workspace if chol else lib.asvgp_carry_workspace)(k, m, nb)
    per = k * k + 3 * d if chol else d * d + 2 * d
    maps = n // (nb * per)
    if maps == 0:
        return {"chunks": 1}
    ws = band.new_empty(n)
    out = torch.empty_like(band)
    entry = ("asvgp_chol_fwd" if chol else "asvgp_tak_fwd") + (
        "_f32" if band.dtype == torch.float32 else "")
    with torch.cuda.device(band.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, entry)(k, m, nb, band.data_ptr(), out.data_ptr(), ws.data_ptr(),
                                 stream)
    _build.check(lib, rc, entry)
    if not chol:
        lc, used = rule_maps(ws, n, m) if m > TWO_CHUNK_COLS else (None, maps)
        h = ws[: nb * maps * d * d].view(nb, maps, d * d)[:, :used]
        return {"chunks": used + 1, "lc": lc, "h_max": float(h.abs().max()) if used else 0.0}
    tri = ws[: nb * maps * (k * k + 2 * d)].view(nb, maps, -1).double()
    packed = ws[nb * maps * (k * k + 2 * d):].view(nb, maps, d).double()
    lo, up = torch.tril_indices(k, k), torch.triu_indices(k, k)
    u = tri.new_zeros(nb, maps, k, k)
    u[..., lo[0], lo[1]] = tri[..., :d]
    w = tri.new_zeros(nb, maps, k, k)
    w[..., up[0], up[1]] = packed
    w = w + torch.triu(w, 1).mT
    # W_c = w[:, c-1] meets the triple of chunk c, c = 1..maps-1
    res = {"chunks": maps + 1, "w_max": float(w.abs().max())}
    if maps > 1:
        eye = torch.eye(k, dtype=torch.float64, device=band.device)
        p = u[:, 1:] @ u[:, 1:].mT
        res["sigma_min"] = float(torch.linalg.svdvals(eye - w[:, :-1] @ p).min())
    return res


def forward_maps_of(calls: dict) -> dict:
    """forward_maps of every captured call, by wrapper: the chunks and the
    extremes over its calls, and each call's."""
    out = {}
    for name, arg_lists in calls.items():
        each = [forward_maps(name, args) for args in arg_lists]
        res = {"chunks": each[0]["chunks"], "each": each}
        for key, pick in (("h_max", max), ("w_max", max), ("sigma_min", min)):
            vals = [e[key] for e in each if key in e]
            if vals:
                res[key] = pick(vals)
        out[name] = res
    return out


def partition_cols(walk: tuple[int, int], scan: tuple[int, int], n: int) -> tuple[int, int]:
    """Columns per chunk of a partitioned Cholesky (``walk``) and Takahashi
    (``scan``) sweep on walks of n columns, as csrc/chunk_scan.cuh's
    partition_cols gives them for each (doubles its pass 2 stages a chunk,
    least columns): at least the least, at most MAX_CHUNKS chunks and as
    many as fit in shared memory, a multiple of the tile; n for one
    chunk."""
    out = []
    for per, least in (walk, scan):
        cap = min(MAX_CHUNKS, SMEM_LIMIT // (per * 8) + 1)
        lc = max(least, -(-n // cap))
        out.append(min(-(-lc // TILE) * TILE, n))
    return out[0], out[1]


def twist_chunk_cols(k: int, m: int) -> tuple[int, int]:
    """(K5's, K6's) columns per chunk at (k, m), as csrc/banded_tan.cu's
    chol_quad_chunk_cols and tak_quad_chunk_cols give them for streams of
    at most h columns: K5's walk stages 2(k² + k(k+1)) doubles a chunk, at
    least 128 columns; K6's scan (2D)² + 2D, 2D = k(k+1), at least 64."""
    from asvgp_tpu_torch.banded.twisted import split_point

    dd = k * (k + 1)
    return partition_cols((2 * (k * k + dd), 128), (dd * dd + dd, 64), split_point(m, k))


def twist_short(bands, c: int):
    """K5's arguments of a problem whose two streams are the first c
    columns of each stream of ``bands`` (F reads band columns < h, R the
    last g + k: so the first c and the last c + k, m' = 2c + k), on which
    K5 runs one pass, the one-chain recursion."""
    m, tail = bands[0].shape[-1], c + bands[0].shape[0] - 1
    return [torch.cat([t[..., :c], t[..., m - tail:]], -1).contiguous() for t in bands]


def twist_edge_parity(device, rng) -> dict:
    """Phase 2: K5 and K6 on random SPD Kuu and P, a random symmetric
    tangent band and a random b at TWIST_EDGES against their plain versions
    on CPU copies (K6 on the plain K5's outputs and their mid step), at the
    random-band bar; and each stream's first chunk against the kernel on a
    problem made of that chunk alone: K5 on twist_short's bands, K6 on the
    last c columns of each stream's K5 outputs (m' = 2c + k), whose every
    output is the long run's, shifted by h - c, but the band entries of R's
    last k columns (beyond the short R stream's end)."""
    from asvgp_tpu_torch.banded import twist
    from asvgp_tpu_torch.banded.twisted import split_point

    rows = []
    for k, m in TWIST_EDGES:
        host = [torch.as_tensor(a) for a in (spd_band(k, m, rng), sym_band(k, m, rng),
                                              spd_band(k, m, rng), rng.randn(m))]
        bands = [t.to(device) for t in host]
        h = split_point(m, k)
        g = m - h - k
        row = {"k": k, "m": m, "h": h, "g": g, "chunks": twist_chunk_cols(k, m)}
        k5 = twist.chol_quad_solve_tan(*bands)
        want5 = twist.chol_quad_solve_tan_plain(*host)
        row |= _errs("chol_quad_solve_tan", k5, want5)
        _, z, x2, _ = twist.mid_step(*host, want5[0], want5[1], want5[4])
        z, x2 = z.contiguous(), x2.contiguous()
        in6 = [t.to(device) for t in (*want5, z, x2)]
        k6 = twist.tak_quad_solve_tan(*in6, m)
        row |= _errs("tak_quad_solve_tan", k6, twist.tak_quad_solve_tan_plain(*want5, z, x2, m))
        c = min(FIRST_CHUNK, g)
        one5 = twist.chol_quad_solve_tan(*twist_short(bands, c))
        equal = all(torch.equal(a[..., :c], o[..., :c]) for a, o in zip(k5, one5))
        # K6's inputs of the short problem: each stream's last c columns
        def last(t, ends):
            return torch.stack([t[i, ..., n - c: n] for i, n in enumerate(ends)]).contiguous()

        short6 = [last(in6[0], (h, h, g, g)), last(in6[1], (h, g)), last(in6[2], (h, h, g, g)),
                  last(in6[3], (h, g)), last(in6[4], (h, g))]
        m1 = 2 * c + k
        one6 = twist.tak_quad_solve_tan(*short6, z.to(device), x2.to(device), m1)
        for a, o in zip(k6, one6):
            if a.ndim == 1:
                equal &= torch.equal(a[h - c: h - c + m1], o)
            else:
                equal &= torch.equal(a[:, h - c: h - c + m1 - k], o[:, : m1 - k])
        row["first_chunk_equal"] = bool(equal)
        rows.append(row)
    return {"rows": rows, "first_chunk_equal": all(r["first_chunk_equal"] for r in rows),
            **{f"{n}_rel": max(r[f"{n}_rel"] for r in rows) for n in TWISTED}}


def tan_walk_record(tri, win, kuu_role: bool, k: int) -> dict:
    """One matrix's Schur walk in K5's or K3's workspace (csrc/banded_tan.cu:
    its triples ``tri`` (chunks, kQuadTriStride), Kuu's in dual numbers,
    value and tangent interleaved, and its walked carries ``win`` (chunks,
    k(k+1))): the largest entries of W and of Ẇ (Kuu) or β (P), and the
    smallest eigenvalue of I − UᵀWU over the chunks whose incoming W is not
    0 (U from the chunk's triple; its singular values are its
    eigenvalues)."""
    nm, stride = tri.shape
    d = k * (k + 1) // 2
    lo, up = torch.tril_indices(k, k), torch.triu_indices(k, k)
    tv = tri.view(nm, stride // 2, 2)[..., 0] if kuu_role else tri
    wv = win.view(nm, d, 2) if kuu_role else win
    u = tv.new_zeros(nm, k, k)
    u[:, lo[0], lo[1]] = tv[:, :d]
    w = tv.new_zeros(nm, k, k)
    w[:, up[0], up[1]] = wv[..., 0] if kuu_role else wv[:, :d]
    w = w + torch.triu(w, 1).mT
    row = {"w_max": float(w.abs().max())}
    if kuu_role:
        row["wdot_max"] = float(wv[..., 1].abs().max())
    else:
        row["beta_max"] = float(wv[:, d: d + k].abs().max())
    if nm > 1:
        eye = torch.eye(k, dtype=tri.dtype, device=tri.device)
        row["sigma_min"] = float(torch.linalg.eigvalsh(eye - u[1:].mT @ w[:-1] @ u[1:]).min())
    return row


def twist_maps(bands) -> dict:
    """K5's and K6's chunks on the arguments ``bands`` = (Kuu, T, P, b):
    one direct launch of each C entry point (not counted), with a
    workspace kept here, filled with NaN first (csrc/banded_tan.cu's
    layout).  For each of [F Kuu, F P, R Kuu, R P]: the largest entries of
    the walked W (and of Ẇ on Kuu, of β on P) and the smallest eigenvalue
    of I − UᵀWU over the chunks c whose W is not 0 (U from the chunk's
    triple; its singular values are its eigenvalues); and the largest entry
    of K6's composed maps (chunk 0's is 0)."""
    from asvgp_tpu_torch.banded import _build, twist
    from asvgp_tpu_torch.banded.twisted import split_point

    lib = _build.load()
    kuu, tanb, p, b = bands
    k, m = kuu.shape[0] - 1, kuu.shape[1]
    h = split_point(m, k)
    g = m - h - k
    dd = k * (k + 1)
    lc5, lc6 = twist_chunk_cols(k, m)
    n5, n6 = -(-h // lc5) - 1, -(-h // lc6) - 1
    stride = 2 * (k * k + dd)
    n = lib.asvgp_twist_workspace(k, m)
    want = max(4 * n5 * (stride + dd), 4 * n6 * (dd * dd + 2 * dd))
    if n != (want + 1 if want else 0):  # and K6's chunk length
        raise AssertionError(f"twist_chunk_cols {lc5, lc6} disagrees with the kernels' "
                             f"workspace of {n} at k={k}, m={m}")
    ws = torch.full((max(n, 1),), float("nan"), dtype=torch.float64, device=kuu.device)
    k5 = [kuu.new_empty(shape) for shape in ((4, k + 1, h), (2, k + 1, h), (4, h), (2, h), (2, h))]
    with torch.cuda.device(kuu.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.asvgp_chol_quad_solve_tan(k, m, h, *(t.data_ptr() for t in (*bands, *k5, ws)),
                                           stream)
        _build.check(lib, rc, "asvgp_chol_quad_solve_tan")
        res = {"chunks": [n5 + 1, n6 + 1]}
        tri = ws[: 4 * n5 * stride].view(4, n5, stride)
        win = ws[4 * n5 * stride: 4 * n5 * (stride + dd)].view(4, n5, dd)
        for t, name in enumerate(("F_kuu", "F_p", "R_kuu", "R_p")):
            nm = -(-(h if t < 2 else g) // lc5) - 1
            if nm >= 1:  # more than one chunk: a walk
                res[name] = tan_walk_record(tri[t, :nm], win[t, :nm], t % 2 == 0, k)
        _, z, x2, _ = twist.mid_step(*bands, k5[0], k5[1], k5[4])
        ws.fill_(float("nan"))
        out6 = [kuu.new_empty(shape) for shape in ((k + 1, m), (k + 1, m), (m,), (k + 1, m))]
        rc = lib.asvgp_tak_quad_solve_tan(k, m, h, *(t.data_ptr() for t in (
            *k5, z.contiguous(), x2.contiguous(), *out6, ws)), stream)
        _build.check(lib, rc, "asvgp_tak_quad_solve_tan")
    if n6 > 0:
        res["k6_lc"], used = rule_maps(ws, n, h)
        res["chunks"][1] = used + 1
        if used > 1:
            hmap = ws[: 4 * n6 * dd * dd].view(4, n6, dd, dd)
            res["k6_h_max"] = float(hmap[:, 1:used].abs().max())
    return res


def core_chunk_cols(k: int, m: int) -> tuple[int, int]:
    """(K1's, K2's) columns per chunk at (k, m), as csrc/banded_core.cu's
    core_chol_cols and core_tak_cols give them: K1's walk stages k² +
    k(k+1) + 2k doubles a chunk, at least 128 columns; K2's scan DD² + DD,
    DD = k(k+1)/2 + k, at least 64."""
    dd = k * (k + 1) // 2 + k
    return partition_cols((k * k + k * (k + 1) + 2 * k, 128), (dd * dd + dd, 64), m)


def core_edge_parity(device, rng) -> dict:
    """Phase 2: K1 and K2 on random SPD Kuu and P and a random b at
    CORE_EDGES against their plain versions on CPU copies (K2 on the plain
    K1's outputs), at the random-band bar; and each walk's first chunk
    against the kernel on that chunk alone: K1 on the first CORE_FIRST[0]
    columns of Kuu, P and b, K2 on the last CORE_FIRST[1] columns of K1's
    outputs."""
    from asvgp_tpu_torch.banded import core

    rows = []
    for k, m in CORE_EDGES:
        host = [torch.as_tensor(a) for a in (spd_band(k, m, rng), spd_band(k, m, rng),
                                              rng.randn(m))]
        bands = [t.to(device) for t in host]
        want1 = core.chol_pair_solve_plain(*host)
        in2 = [t.to(device) for t in want1]
        row = {"k": k, "m": m, "chunks": core_chunk_cols(k, m),
               **_errs("chol_pair_solve", core.chol_pair_solve(*bands), want1),
               **_errs("tak_pair_solve", core.tak_pair_solve(*in2),
                       core.tak_pair_solve_plain(*want1))}
        row["first_chunk_equal"] = (
            first_chunk_equal(core.chol_pair_solve, bands, False, CORE_FIRST[0], (0, 1))
            and first_chunk_equal(core.tak_pair_solve, in2, True, CORE_FIRST[1]))
        rows.append(row)
    return {"rows": rows, "first_chunk_equal": all(r["first_chunk_equal"] for r in rows),
            **{f"{n}_rel": max(r[f"{n}_rel"] for r in rows) for n in SERVING_KERNELS}}


def core_maps(bands) -> dict:
    """K1's and K2's chunks on the arguments ``bands`` = (Kuu, T, P, b) (T
    unused): one direct launch of each C entry point (not counted), with a
    workspace kept here, filled with NaN first (csrc/banded_core.cu's
    layout).  For Kuu and P: the largest entry of the walked W (and of β on
    P) and the smallest eigenvalue of I − UᵀWU over the chunks c whose W is
    not 0 (U from the chunk's triple); and the largest entry of K2's maps
    of the chunks that take a carry (chunk 0's meets 0), by matrix."""
    from asvgp_tpu_torch.banded import _build

    lib = _build.load()
    kuu, _, p, b = bands
    k, m = kuu.shape[0] - 1, kuu.shape[1]
    d = k * (k + 1) // 2
    dd = d + k
    lc1, lc2 = core_chunk_cols(k, m)
    n1, n2 = -(-m // lc1) - 1, -(-m // lc2) - 1
    stride = k * k + 2 * d + 2 * k
    n = lib.asvgp_core_workspace(k, m)
    want = max(2 * n1 * (stride + dd), 2 * n2 * (dd * dd + 2 * dd))
    if n != (want + 1 if want else 0):  # and K2's chunk length
        raise AssertionError(f"core_chunk_cols {lc1, lc2} disagrees with the kernels' "
                             f"workspace of {n} at k={k}, m={m}")
    ws = torch.full((max(n, 1),), float("nan"), dtype=torch.float64, device=kuu.device)
    k1 = [torch.empty_like(kuu), torch.empty_like(p), kuu.new_empty((2, m)), kuu.new_empty(m)]
    k2 = [torch.empty_like(kuu), torch.empty_like(p), kuu.new_empty(m)]
    res = {"chunks": [n1 + 1, n2 + 1]}
    with torch.cuda.device(kuu.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.asvgp_chol_pair_solve(k, m, *(t.data_ptr() for t in (kuu, p, b, *k1, ws)),
                                       stream)
        _build.check(lib, rc, "asvgp_chol_pair_solve")
        tri = ws[: 2 * n1 * stride].view(2, n1, stride)
        win = ws[2 * n1 * stride: 2 * n1 * (stride + dd)].view(2, n1, dd)
        lo, up = torch.tril_indices(k, k), torch.triu_indices(k, k)
        eye = torch.eye(k, dtype=torch.float64, device=kuu.device)
        for t, name in ((0, "kuu"), (1, "p")) if n1 > 0 else ():
            u = tri.new_zeros(n1, k, k)
            u[:, lo[0], lo[1]] = tri[t, :, :d]
            w = tri.new_zeros(n1, k, k)
            w[:, up[0], up[1]] = win[t, :, :d]
            w = w + torch.triu(w, 1).mT
            row = {"w_max": float(w.abs().max())}
            if t == 1:
                row["beta_max"] = float(win[t, :, d:].abs().max())
            if n1 > 1:
                nmat = eye - u[1:].mT @ w[:-1] @ u[1:]
                row["sigma_min"] = float(torch.linalg.eigvalsh(nmat).min())
            res[name] = row
        ws.fill_(float("nan"))
        rc = lib.asvgp_tak_pair_solve(k, m, *(t.data_ptr() for t in (*k1, *k2, ws)), stream)
        _build.check(lib, rc, "asvgp_tak_pair_solve")
    if n2 > 0:
        res["k2_lc"], used = rule_maps(ws, n, m)
        res["chunks"][1] = used + 1
        if used > 1:
            hmap = ws[: 2 * n2 * dd * dd].view(2, n2, dd, dd)[:, 1:used]
            res["k2_h_max"] = {"kuu": float(hmap[0].abs().max()),
                               "p": float(hmap[1].abs().max())}
    return res


def tan_chunk_cols(k: int, m: int) -> tuple[int, int]:
    """(K3's, K4's) columns per chunk at (k, m): K5's and K6's rule
    (``twist_chunk_cols``) on one stream of m columns."""
    dd = k * (k + 1)
    return partition_cols((2 * (k * k + dd), 128), (dd * dd + dd, 64), m)


def tan_edge_parity(device, rng) -> dict:
    """Phase 2: K3 and K4 on random SPD Kuu and P, a random symmetric
    tangent band and a random b at TAN_EDGES against their plain versions
    on CPU copies (K4 on the plain K3's outputs), at the random-band bar;
    and each walk's first chunk against the kernel on that chunk alone: K3
    on the first TAN_FIRST[0] columns of the bands and b (its factors' and
    tangent's rows past them left out), K4 on the last TAN_FIRST[1]
    columns of K3's outputs."""
    from asvgp_tpu_torch.banded import tan

    rows = []
    for k, m in TAN_EDGES:
        host = [torch.as_tensor(a) for a in (spd_band(k, m, rng), sym_band(k, m, rng),
                                              spd_band(k, m, rng), rng.randn(m))]
        bands = [t.to(device) for t in host]
        want3 = tan.chol_pair_solve_tan_plain(*host)
        in4 = [t.to(device) for t in want3]
        row = {"k": k, "m": m, "chunks": tan_chunk_cols(k, m),
               **_errs("chol_pair_solve_tan", tan.chol_pair_solve_tan(*bands), want3),
               **_errs("tak_pair_solve_tan", tan.tak_pair_solve_tan(*in4),
                       tan.tak_pair_solve_tan_plain(*want3))}
        row["first_chunk_equal"] = (
            first_chunk_equal(tan.chol_pair_solve_tan, bands, False, TAN_FIRST[0], (0, 1, 4))
            and first_chunk_equal(tan.tak_pair_solve_tan, in4, True, TAN_FIRST[1]))
        rows.append(row)
    return {"rows": rows, "first_chunk_equal": all(r["first_chunk_equal"] for r in rows),
            **{f"{n}_rel": max(r[f"{n}_rel"] for r in rows) for n in TAN}}


def tan_maps(bands) -> dict:
    """K3's and K4's chunks on the arguments ``bands`` = (Kuu, T, P, b): one
    direct launch of each C entry point (not counted), with a workspace
    kept here, filled with NaN first (csrc/banded_tan.cu's layout).  For
    Kuu and P, K3's walk record (``tan_walk_record``); and the largest
    entry of K4's maps of the chunks that take a carry (chunk 0's meets
    0), by matrix."""
    from asvgp_tpu_torch.banded import _build

    lib = _build.load()
    kuu = bands[0]
    k, m = kuu.shape[0] - 1, kuu.shape[1]
    dd = k * (k + 1)
    lc3, lc4 = tan_chunk_cols(k, m)
    n3, n4 = -(-m // lc3) - 1, -(-m // lc4) - 1
    stride = 2 * (k * k + dd)
    n = lib.asvgp_tan_workspace(k, m)
    want = max(2 * n3 * (stride + dd), 2 * n4 * (dd * dd + 2 * dd))
    if n != (want + 1 if want else 0):  # and K4's chunk length
        raise AssertionError(f"tan_chunk_cols {lc3, lc4} disagrees with the kernels' "
                             f"workspace of {n} at k={k}, m={m}")
    ws = torch.full((max(n, 1),), float("nan"), dtype=torch.float64, device=kuu.device)
    k3 = [torch.empty_like(kuu), torch.empty_like(kuu), kuu.new_empty((2, m)), kuu.new_empty(m),
          torch.empty_like(kuu), kuu.new_empty(m)]
    k4 = [torch.empty_like(kuu), torch.empty_like(kuu), kuu.new_empty(m), torch.empty_like(kuu)]
    res = {"chunks": [n3 + 1, n4 + 1]}
    with torch.cuda.device(kuu.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.asvgp_chol_pair_solve_tan(k, m, *(t.data_ptr() for t in (*bands, *k3, ws)),
                                           stream)
        _build.check(lib, rc, "asvgp_chol_pair_solve_tan")
        tri = ws[: 2 * n3 * stride].view(2, n3, stride)
        win = ws[2 * n3 * stride: 2 * n3 * (stride + dd)].view(2, n3, dd)
        for t, name in ((0, "kuu"), (1, "p")) if n3 > 0 else ():
            res[name] = tan_walk_record(tri[t], win[t], t == 0, k)
        ws.fill_(float("nan"))
        rc = lib.asvgp_tak_pair_solve_tan(k, m, *(t.data_ptr() for t in (*k3, *k4, ws)), stream)
        _build.check(lib, rc, "asvgp_tak_pair_solve_tan")
    if n4 > 0:
        res["k4_lc"], used = rule_maps(ws, n, m)
        res["chunks"][1] = used + 1
        if used > 1:
            hmap = ws[: 2 * n4 * dd * dd].view(2, n4, dd, dd)[:, 1:used]
            res["k4_h_max"] = {"kuu": float(hmap[0].abs().max()),
                               "p": float(hmap[1].abs().max())}
    return res


def f32_path(device, x_d, y_d, x_test, y_test) -> dict:
    """Phases 6k and 6l: GPR1D(..., dtype=float32) at the north star, each
    stage on fresh counters: construction, one value-and-grad step and the
    posterior (the arguments K17-K22 got in both kept, under the kernels'
    names), predictions on the held-out points in batches and NLPD, and the
    same predictions from a posterior built by the plain float32 versions
    on a CPU copy."""
    from asvgp_tpu_torch.banded import core, single, solve
    from asvgp_tpu_torch.train import nlpd

    core.reset_counters()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    model = make_model(x_d, y_d, M, device, dtype=torch.float32)
    torch.cuda.synchronize(device)
    build_s = time.perf_counter() - t0
    build_launches = read_launches(device, "float32 GPR1D construction", {})

    args: dict = {}
    singles, solves = ("chol_fwd", "chol_bwd", "tak_fwd", "tak_bwd"), ("solve_lower", "solve_upper_t")
    core.reset_counters()
    with capture(args, single, *singles), capture(args, solve, *solves):
        loss, grads = value_and_grad(model)
    step_launches = read_launches(device, "float32 value-and-grad step", F32_STEP)
    core.reset_counters()
    with capture(args, single, *singles), capture(args, solve, *solves):
        post = model.posterior()
    posterior_launches = read_launches(device, "float32 posterior", F32_POSTERIOR)

    xt = torch.as_tensor(x_test, dtype=torch.float32, device=device)
    yt = torch.as_tensor(y_test, dtype=torch.float32, device=device)
    core.reset_counters()
    mean, var = post.predict_f(xt, batch=PREDICT_BATCH)
    score = float(nlpd(post.predict_log_density((xt, yt))))
    predict_launches = read_launches(device, "float32 predict", {})
    if not (mean.shape == var.shape == (x_test.shape[0], 1)
            and mean.dtype == var.dtype == torch.float32 and model.kuf_y.dtype == torch.float32):
        raise AssertionError(f"float32 predict_f: {tuple(mean.shape)}, {mean.dtype}")
    if not (bool(torch.isfinite(mean).all()) and bool(torch.isfinite(var).all())
            and math.isfinite(score) and math.isfinite(loss)):
        raise AssertionError("non-finite float32 loss, predictions or NLPD")

    cpu_model = copy.deepcopy(model).to("cpu")
    t0 = time.perf_counter()
    cpu_post = cpu_model.posterior()
    cpu_posterior_s = time.perf_counter() - t0
    mean_c, var_c = cpu_post.predict_f(xt.cpu(), batch=PREDICT_BATCH)
    return {
        "model": model, "post": post, "x_test": xt, "build_s": build_s,
        "loss": loss, "grad": grads, "nlpd": score,
        "mean": stat_summary(mean.double()), "var": stat_summary(var.double()),
        "min_var": float(var.min()),
        "mean_rel_vs_cpu": rel_err(mean, mean_c), "var_rel_vs_cpu": rel_err(var, var_c),
        "cpu_plain_posterior_s": cpu_posterior_s,
        "args": {f"{name}_f32": a for name, a in args.items()},
        "launches": {"construction": build_launches, "step": step_launches,
                     "posterior": posterior_launches, "predict": predict_launches},
    }


def summary_rel(got: dict, want: dict) -> float:
    """tools/f32_anchors.py's distance of two summaries: the larger of the
    sums' and the projections' distances, each relative to the sum of the
    absolute terms it is made of."""
    return max(abs(got["sum"] - want["sum"]) / want["abs_sum"],
               abs(got["proj"] - want["proj"]) / want["proj_abs"])


def dense_spd(a_band: torch.Tensor) -> torch.Tensor:
    """The dense symmetric (m, m) matrix of a lower band (k+1, m)."""
    from asvgp_tpu_torch.banded import band_to_dense, symmetrise_lower_band

    k = a_band.shape[0] - 1
    return band_to_dense(symmetrise_lower_band(a_band), k, k)


def dense_block_ops(B: int) -> int:
    """Floating-point operations (an fma counts 2) of K16 on one B×B block,
    per the column steps of csrc/block_chol_inv.cu: the rank-1 updates of M
    (Σ_c (B−1−c)(B−c)/2 fma) and of T (Σ_c (B−1−c)(c+1) fma), the column
    and row scalings, and a square root and a divide per column."""
    fma = sum((B - 1 - c) * (B - c) // 2 + (B - 1 - c) * (c + 1) for c in range(B))
    scale = sum((B - 1 - c) + (c + 1) for c in range(B)) + B
    return 2 * fma + scale + 2 * B


def dense_block_bytes(B: int) -> int:
    """Bytes K16 must move for one B×B float64 block: the lower triangle of
    the input, which is all it reads (B(B+1)/2 entries), and the two full
    B×B outputs, upper triangles zero."""
    return 8 * (B * (B + 1) // 2 + 2 * B * B)


def ptxas_summary(log: str) -> list[str]:
    """'kernel<K>: registers, spill bytes' for every entry ptxas compiled."""
    out, name = [], None
    for line in log.splitlines():
        hit = re.search(r"Compiling entry function '.*\d([a-z_]+_kernel)(?:ILi(\d)E([fd]?))?", line)
        if hit:
            name = hit.group(1)
            if hit.group(2):
                scalar = {"f": ", float", "d": ", double"}.get(hit.group(3), "")
                name += f"<{hit.group(2)}{scalar}>"
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill and name:
            out.append(f"{name}: spill {spill.group(1)}/{spill.group(2)} B")
        regs = re.search(r"Used (\d+) registers", line)
        if regs and name and out and out[-1].startswith(name + ":"):
            out[-1] += f", {regs.group(1)} registers"
    return out


def sweep_ops(name: str, k: int, m: int, r: int = 1) -> int:
    """Floating-point operations (an fma counts 2) of a sweep's useful work,
    per the column recursions of csrc/*.cu, over all its columns; a float32
    kernel does its float64 form's work, a solve that per column of its
    right-hand side (``r`` of them)."""
    chol = k * (k + 1) + 3 + 2 * k          # Cholesky column
    lsolve = 2 * k + 2                      # lower-solve entry
    chol_t = 2 * k * (k + 1) + 4 * (k + 1) + 5  # its tangent
    tak = 2 * k * k + 3 * k + 3             # Takahashi column
    usolve = 2 * k + 2                      # upper-solve entry
    tak_t = 4 * k * k + 7 * k + 6           # its tangent
    chol_b = 2 * k * (k + 1) + 6 * k + 7    # Cholesky adjoint column
    tak_b = 4 * k * k + 11 * k + 10         # Takahashi adjoint column
    per_col = {
        "chol_pair_solve": 2 * chol + lsolve,
        "tak_pair_solve": 2 * tak + usolve,
        "chol_pair_solve_tan": 2 * chol + lsolve + chol_t,
        "tak_pair_solve_tan": 2 * tak + usolve + tak_t,
        "chol_quad_solve_tan": 2 * chol + lsolve + chol_t,
        "tak_quad_solve_tan": 2 * tak + usolve + tak_t,
        "tak_bwd_vec": tak_b,
        "chol_bwd_pair": chol_b,
        "chol_fwd": chol,
        "chol_bwd": chol_b,
        "tak_fwd": tak + 1,
        "tak_bwd": tak_b + 1,
        "chol_fwd_pair": 2 * chol,
        "tak_bwd_pair": 2 * tak_b,
        "solve_lower": lsolve * r,
        "solve_upper_t": usolve * r,
    }[name.removesuffix("_f32")]
    # the twisted sweeps walk m - k columns in two streams; the k×k middle
    # block is the mid step's
    cols = m - k if "quad" in name else m
    return per_col * cols


def tensor_bytes(tensors) -> int:
    """Bytes of ``tensors``: a sweep reads each input and writes each
    output whole."""
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(ops: int, nbytes: int, peak: float = PEAK_FP64_PER_S) -> dict:
    """The least time the card could take for ``ops`` operations moving
    ``nbytes`` (each input read once and each output written once): the
    bytes at the HBM rate against the operations at ``peak`` (the FP64 or
    the FP32 rate by the kernel's type, the FP64 tensor-core rate for
    K16); the larger one bounds."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def dense_block_bound(B: int) -> dict:
    """K16's bound on one B×B block: its Cholesky and triangular inverse
    are matmul-shaped, so its operations go at the FP64 tensor-core rate."""
    return bound(dense_block_ops(B), dense_block_bytes(B), PEAK_FP64_TC_PER_S)


def once_ms(fn) -> float:
    """One call's time (ms) between CUDA events, after one warm-up call:
    for the plain versions, which take seconds at the main path's shape."""
    return cuda_ms(fn, reps=1)["median_ms"]


def backward_ms(model, reps: int = REPS) -> dict:
    """The backward alone: a fresh forward before each timed backward."""
    ts = []
    for _ in range(reps + 1):
        model.zero_grad(set_to_none=True)
        loss = model.training_loss()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss.backward()
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end))
    ts = ts[1:]  # the first is the warm-up
    return {"median_ms": float(np.median(ts)), "ms": ts}


def device_profile(fn, reps: int = REPS) -> dict:
    """Where a step's time goes: its wall time per call over ``reps`` calls
    (host clock to a synchronize, no profiler), the device time of its
    kernels and copies per call over PROFILE_REPS profiled calls
    (torch.profiler), their ratio (the device's busy share), the device
    operations per call and the six largest by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_REPS):
            fn()
        torch.cuda.synchronize()
    # the device's own entries (kernels, copies); a host op's entry repeats
    # the device time of what it launched
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3 / PROFILE_REPS
    ops = sum(e.count for e in events) / PROFILE_REPS
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:6]
    return {
        "wall_ms": wall_ms,
        "device_ms": device_ms if device_ms > 0 else "not measured",
        "busy_share": device_ms / wall_ms if device_ms > 0 else "not measured",
        "device_ops": ops,
        "top": [[e.key[:80], e.self_device_time_total / 1e3 / PROFILE_REPS] for e in top],
    }


def kernel_device_ms(fn, reps: int = REPS) -> dict:
    """Device time per call of ``fn`` (torch.profiler, after a warm-up),
    by kernel: what a call costs the card, without the host's launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    per = {e.key[:80]: e.self_device_time_total / 1e3 / reps for e in events}
    return {"device_ms": sum(per.values()) if per else "not measured", "by_kernel": per}


CR_REPS = 3  # timed calls of each side of phase 6v's A/B (a CR step takes ~0.1 s)


def cr_ab(fn) -> dict:
    """One side of phase 6v's A/B: the host-clock median of
    ``utils.profiling.timed`` and ``device_profile``'s wall and device ms,
    busy share and device operations, all in this call."""
    from asvgp_tpu_torch.utils import timed

    seconds, _ = timed(fn, reps=CR_REPS)
    return {"timed_ms": seconds * 1e3, **device_profile(fn, reps=CR_REPS)}


def cr_phase(device, x, x_d, y_d, run, tr, bands) -> dict:
    """Phase 6v: GPR1D(..., backend="cr") at the north star.  On fresh
    counters, each held to launch none of K1–K23: the loss and its gradient
    by backward(), the posterior (S_Kuu, S_P, u beside banded_posterior's
    K1 + K2 results; predictions on the 10⁵ test points beside the default
    route's), fit_lbfgs (10 iterations, curv_rtol 10).  A step and a
    posterior under ``set_sync_debug_mode("error")``; a step traced by
    ``utils.trace_to``; the fitted parameters through ``save_pytree`` /
    ``load_pytree``; Kuf of 10⁴ points by ``kuf_to_scipy`` from the card
    and from the CPU.  Then the A/B against the serial walks on the same
    inputs: the CR step against the twisted (K5 + mid + K6) and the
    single-ended (K3 + K4) steps, the CR posterior against K1 + K2's,
    ``cr_inverse_band(Kuu)`` against K9 + K11 and ``cr_logdet_solve(P, b)``
    against K9 + K13 + K14.  ``seconds`` times each part on the host
    clock."""
    import tempfile

    from asvgp_tpu_torch import banded
    from asvgp_tpu_torch.banded import core, cyclic
    from asvgp_tpu_torch.train import fit_lbfgs, load_pytree, save_pytree
    from asvgp_tpu_torch.utils import kuf_to_scipy, trace_to

    kuu, _, p_band, b = bands
    seconds = {}
    t_part = time.perf_counter()
    model = make_model(x_d, y_d, M, device, backend="cr")
    init = model.params()
    # one warm-up step and posterior: the basis tables reach the card once
    value_and_grad(model)
    model.posterior()

    core.reset_counters()
    loss, grad = value_and_grad(model)
    step_launches = read_launches(device, "CR step", {})

    with torch.no_grad():
        ref = banded.banded_posterior(kuu, p_band, b)
        core.reset_counters()
        with banded.cr_scope(True):
            got = banded.banded_posterior(kuu, p_band, b)
    post_launches = read_launches(device, "CR posterior", {})
    posterior_rel = {name: rel_err(g, r) for name, g, r in zip(("s_kuu", "s_p", "u"), got, ref)}
    core.reset_counters()
    post = model.posterior()
    mean, var = post.predict_f(run["x_test"], batch=PREDICT_BATCH)
    predict_launches = read_launches(device, "CR posterior and predict", {})
    mean_ref, var_ref = run["posterior"].predict_f(run["x_test"], batch=PREDICT_BATCH)
    predict_rel = {"mean": rel_err(mean, mean_ref), "var": rel_err(var, var_ref)}

    # no host synchronisation in a step or a posterior
    torch.cuda.synchronize(device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        model.zero_grad(set_to_none=True)
        model.training_loss().backward()
        model.posterior()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize(device)
    seconds["checks"] = time.perf_counter() - t_part

    # the A/B against the serial walks, on the same inputs, in this call
    t_part = time.perf_counter()
    tmodel = tr["model"]

    def single_step():
        with banded.twist_scope(False):
            return value_and_grad(tmodel)

    def k9_k11():
        with torch.no_grad():
            return banded.takahashi_inverse_band(banded.cholesky_band(kuu))

    def k9_k13_k14():
        with torch.no_grad():
            l_p = banded.cholesky_band(p_band)
            return banded.log_det_from_cholesky(l_p), banded.cholesky_solve_band(l_p, b)

    def cr_logdet_solve():
        with torch.no_grad():
            return cyclic.cr_logdet_solve(p_band, b)

    pairs = {
        "step": {"cr": lambda: value_and_grad(model),
                 "twisted_k5_mid_k6": lambda: value_and_grad(tmodel),
                 "single_ended_k3_k4": single_step},
        "posterior": {"cr": model.posterior, "k1_k2": tmodel.posterior},
        "inverse_band_kuu": {"cr": lambda: cyclic.cr_inverse_band(kuu), "k9_k11": k9_k11},
        "logdet_solve_p": {"cr": cr_logdet_solve, "k9_k13_k14": k9_k13_k14},
    }
    ab = {what: {side: cr_ab(fn) for side, fn in sides.items()} for what, sides in pairs.items()}
    inv_cr, inv_k = cyclic.cr_inverse_band(kuu), k9_k11()
    (ld_cr, u_cr), (ld_k, u_k) = cr_logdet_solve(), k9_k13_k14()
    ab_rel = {"inverse_band_kuu": rel_err(inv_cr, inv_k),
              "logdet_solve_p": {"logdet": rel(float(ld_cr), float(ld_k)),
                                 "solve": rel_err(u_cr, u_k)}}
    seconds["ab"] = time.perf_counter() - t_part

    # trace one step
    t_part = time.perf_counter()
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        with trace_to(tmp):
            value_and_grad(model)
        files = sorted(Path(tmp).glob("*.json"))
        events = json.loads(files[0].read_text())["traceEvents"] if len(files) == 1 else []
    trace = {"files": len(files), "events": len(events),
             "kernel_events": sum(1 for e in events if e.get("cat") == "kernel")}
    seconds["trace"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    # the fit, on fresh counters
    info = {}
    core.reset_counters()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    params, fit_loss, iters = fit_lbfgs(model.training_loss, init, max_iters=10, curv_rtol=10.0,
                                        info=info)
    fit_s = time.perf_counter() - t0
    fit_launches = read_launches(device, "CR fit", {})

    # checkpoint the fitted parameters and load them back on the card
    model.load_jax_params(params)
    with torch.no_grad():
        saved_loss = model.training_loss()
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        path = str(Path(tmp) / "cr_fit.pkl")
        save_pytree(path, model.params())
        model.load_jax_params(init)
        loaded = load_pytree(path, model.params())
    model.load_jax_params(loaded)
    with torch.no_grad():
        loaded_loss = model.training_loss()
    ckpt = {"saved_loss": float(saved_loss), "loaded_loss": float(loaded_loss),
            "bit_equal": bool(torch.equal(saved_loss, loaded_loss)),
            "on_card": all(v.is_cuda for d in loaded.values() for v in d.values())}
    model.load_jax_params(init)

    # Kuf of the first 10⁴ points from the card and from the CPU: the same
    # sparsity pattern; the values as the two devices' arithmetic gives them
    kuf_card = kuf_to_scipy(model.basis, x_d[:10_000])
    kuf_cpu = kuf_to_scipy(model.basis, x[:10_000], device="cpu")
    diff = abs(kuf_card - kuf_cpu)
    kuf = {"shape": list(kuf_card.shape), "nnz": kuf_card.nnz,
           "pattern_equal": bool(kuf_card.shape == kuf_cpu.shape
                                 and np.array_equal(kuf_card.indptr, kuf_cpu.indptr)
                                 and np.array_equal(kuf_card.indices, kuf_cpu.indices)),
           "values_differing": int((kuf_card != kuf_cpu).nnz),
           "max_abs_diff": float(diff.max()) if diff.nnz else 0.0}
    seconds["fit_checkpoint_kuf"] = time.perf_counter() - t_part
    return {"loss": loss, "grad": grad, "posterior_rel": posterior_rel,
            "predict_rel": predict_rel, "fit_loss": fit_loss, "fit_iters": iters,
            "fit_evals": info["ls_evals"], "fit_s": fit_s, "ab": ab, "ab_rel": ab_rel,
            "trace": trace, "checkpoint": ckpt, "kuf": kuf, "seconds": seconds,
            "launches": {"step": step_launches, "posterior": post_launches,
                         "posterior_and_predict": predict_launches, "fit": fit_launches}}


def main() -> None:
    # ---- phase 0: card check ------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit(
            "chip_smoke: torch.cuda.is_available() is false; this script runs "
            "only on an NVIDIA GPU"
        )
    from asvgp_tpu_torch.banded import _build, core, tan, twist, twist_scope

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    card = {"name_power": smi, "kind": torch.cuda.get_device_name(0)}
    emit("0_card", **card, torch=torch.__version__, cuda=torch.version.cuda)
    t_start = time.perf_counter()

    # ---- phase 1: build ----------------------------------------------------
    t0 = time.perf_counter()
    info = _build.build()
    _build.load()
    emit("1_build", seconds=time.perf_counter() - t0, nvcc_seconds=info["seconds"],
         library=info["path"], ptxas=ptxas_summary(info["log"]))

    # ---- phase 2: kernel parity --------------------------------------------
    rng = np.random.RandomState(SEED)
    for k in range(1, 7):
        host = [spd_band(k, PARITY_M, rng), sym_band(k, PARITY_M, rng),
                spd_band(k, PARITY_M, rng), rng.randn(PARITY_M)]
        bands = [torch.as_tensor(a, dtype=torch.float64, device=device) for a in host]
        res = kernel_parity(bands)
        emit("2_parity_random", **res, tol=TOL_PARITY)
        check_parity(res, TOL_PARITY, f"at k={k}")
    for k in range(1, 7):
        res = adjoint_parity(random_adjoint_inputs(k, PARITY_M, rng, device))
        emit("2_parity_adjoint_random", k=k, m=PARITY_M, **res, tol=TOL_PARITY_ADJOINT)
        check_parity(res, TOL_PARITY_ADJOINT, f"of K7-K12 at k={k}")
    adj_edges = adjoint_edge_parity(device, rng)
    emit("2_parity_adjoint_edges", **adj_edges, tol={n: f32_tol(n) for n in ADJOINTS})
    check_each(adj_edges, f32_tol, "of the adjoints at the edges of their partitions")
    fwd_edges = forward_edge_parity(device, rng)
    emit("2_parity_forward_edges", **fwd_edges, tol={n: f32_tol(n) for n in FORWARDS})
    check_each(fwd_edges, f32_tol, "of the forward sweeps at the edges of their partitions")
    if not fwd_edges["first_chunk_equal"]:
        raise AssertionError(f"a forward sweep's first chunk is not the one-pass recursion: "
                             f"{fwd_edges['rows']}")
    core_edges = core_edge_parity(device, rng)
    emit("2_parity_core_edges", **core_edges, tol=TOL_PARITY_ADJOINT)
    check_parity(core_edges, TOL_PARITY_ADJOINT, "of K1/K2 at the edges of their partitions")
    if not core_edges["first_chunk_equal"]:
        raise AssertionError(f"a serving sweep's first chunk is not the one-pass recursion: "
                             f"{core_edges['rows']}")
    tw_edges = twist_edge_parity(device, rng)
    emit("2_parity_twist_edges", **tw_edges, tol=TOL_PARITY_ADJOINT)
    check_parity(tw_edges, TOL_PARITY_ADJOINT, "of K5/K6 at the edges of their partitions")
    if not tw_edges["first_chunk_equal"]:
        raise AssertionError(f"a twisted sweep's first chunk is not the one-pass recursion: "
                             f"{tw_edges['rows']}")
    tan_edges = tan_edge_parity(device, rng)
    emit("2_parity_tan_edges", **tan_edges, tol=TOL_PARITY_ADJOINT,
         ptxas=[line for line in ptxas_summary(info["log"])
                if line.startswith(("chol_pair_tan", "tak_pair_tan", "chol_quad_walk",
                                    "chunk_scan"))])
    check_parity(tan_edges, TOL_PARITY_ADJOINT, "of K3/K4 at the edges of their partitions")
    if not tan_edges["first_chunk_equal"]:
        raise AssertionError(f"a single-ended tangent sweep's first chunk is not the one-pass "
                             f"recursion: {tan_edges['rows']}")

    x, y = bench_data(N, SEED)
    x_test, y_test = bench_data(N_TEST, TEST_SEED)
    x_d = torch.as_tensor(x, dtype=torch.float64, device=device)
    y_d = torch.as_tensor(y, dtype=torch.float64, device=device)
    parity_model = make_model(x_d, y_d, M, device)
    main_bands = model_bands(parity_model)
    main_parity = kernel_parity(main_bands)
    emit("2_parity_main_shape", **main_parity, tol=TOL_PARITY_MAIN)
    check_parity(main_parity, TOL_PARITY_MAIN, "at the main path's shape")

    # ---- phase 3: serving path ---------------------------------------------
    run = serving_path(device, x, y, x_test, y_test, M, PREDICT_BATCH)
    loss_rel = abs(run["loss"] - ANCHOR_LOSS) / abs(ANCHOR_LOSS)
    emit("3_serving_path", n=N, m=M, n_test=N_TEST, batch=PREDICT_BATCH,
         training_loss=run["loss"], anchor=ANCHOR_LOSS, loss_rel_err=loss_rel,
         nlpd=run["nlpd"], min_var=run["min_var"],
         mean_rel_vs_cpu=run["mean_rel_vs_cpu"], var_rel_vs_cpu=run["var_rel_vs_cpu"],
         cpu_plain_posterior_s=run["cpu_plain_posterior_s"],
         stats_repeatable=run["stats_repeatable"])
    if not loss_rel <= TOL_LOSS:
        raise AssertionError(f"training_loss {run['loss']} vs {ANCHOR_LOSS}: rel {loss_rel}")
    if not max(run["mean_rel_vs_cpu"], run["var_rel_vs_cpu"]) <= TOL_PREDICT:
        raise AssertionError(f"predictions differ from the CPU posterior: {run}")
    if not run["stats_repeatable"]:
        raise AssertionError("a second stats build from the same data gave other bits")

    # ---- phase 4: proof of the serving path --------------------------------
    launches = {name: run["launches"][name] for name in SERVING_KERNELS}
    emit("4_proof_of_serving_path", launches=launches, plain_calls=run["plain_calls"])
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the serving path never launched: {launches}")
    if run["plain_calls"].get("cuda", 0) != 0:
        raise AssertionError(f"a plain version ran on a CUDA tensor: {run['plain_calls']}")

    # ---- phase 5: training path --------------------------------------------
    tr = training_path(device, x, y, M)
    fit, sn_fit, ex_fit = tr["fit"], tr["snelson_fit"], tr["exact_fit"]
    grad_rel = {n: rel(tr["grad_twist"][n], ANCHOR_GRAD[n]) for n in PARAM_NAMES}
    route_rel = max([rel(tr["loss_single"], tr["loss_twist"])]
                    + [rel(tr["grad_single"][n], tr["grad_twist"][n]) for n in PARAM_NAMES])
    fit_rel = max(rel(v, ANCHOR_FIT_LOSS) for v in fit["losses"])
    snelson_rel = max(rel(v, ANCHOR_SNELSON_LOSS) for v in sn_fit["losses"])
    emit("5_training_path", n=N, m=M,
         loss_twist=tr["loss_twist"], loss_rel_err=rel(tr["loss_twist"], ANCHOR_LOSS),
         grad_twist=tr["grad_twist"], grad_rel_err=grad_rel,
         loss_single=tr["loss_single"], grad_single=tr["grad_single"],
         routes_rel_err=route_rel,
         fit_loss=fit["loss"], fit_anchor=ANCHOR_FIT_LOSS, fit_rel_err=fit_rel,
         fit_iters=fit["iter_counts"], fit_info=fit["info"],
         snelson_loss=sn_fit["loss"], snelson_rel_err=snelson_rel,
         snelson_iters=sn_fit["iter_counts"], snelson_info=sn_fit["info"],
         snelson_params=sn_fit["params"],
         snelson_elbo=-sn_fit["loss"], exact_log_marginal=-ex_fit["loss"],
         exact_rel_err=rel(ex_fit["loss"], ANCHOR_EXACT_LOSS),
         exact_iters=ex_fit["iters"])
    if not rel(tr["loss_twist"], ANCHOR_LOSS) <= TOL_LOSS:
        raise AssertionError(f"training loss with grad {tr['loss_twist']} vs {ANCHOR_LOSS}")
    if not max(grad_rel.values()) <= TOL_GRAD:
        raise AssertionError(f"gradient vs the CPU-float64 anchors: {grad_rel}")
    if not route_rel <= TOL_ROUTES:
        raise AssertionError(f"twisted and single-ended routes differ: {route_rel}")
    if not (fit_rel <= TOL_FIT and set(fit["iter_counts"]) == {ANCHOR_FIT_ITERS}):
        raise AssertionError(f"north-star fits {fit['losses']} in {fit['iter_counts']} iterations")
    if not snelson_rel <= TOL_FIT:
        raise AssertionError(f"Snelson fits {sn_fit['losses']} vs {ANCHOR_SNELSON_LOSS}")
    if not -sn_fit["loss"] <= -ex_fit["loss"]:
        raise AssertionError(f"ELBO {-sn_fit['loss']} above exact logZ {-ex_fit['loss']}")

    # ---- phase 6: proof of the training path -------------------------------
    # each route's counts were read and held exactly in training_path; the
    # kernels line reports the north star's: K3/K4 from the single-ended
    # step, K5/K6 from the fit (the default, twisted route)
    emit("6_proof_of_training_path", launches=tr["launches"])
    path_launches = {**launches,
                     **{n: tr["launches"]["single_ended_step"][n] for n in TRAINING_KERNELS[:2]},
                     **{n: tr["launches"]["north_star_fit"][n] for n in TRAINING_KERNELS[2:]}}
    # ---- phase 6a: minibatch Adam -------------------------------------------
    ad = adam_path(device, x_d, y_d)
    adam_rel = {
        "loss_1": rel(ad["loss1"], ANCHOR_ADAM_LOSS_1),
        "fit_loss_1": rel(ad["losses"][0], ANCHOR_ADAM_LOSS_1),
        "fit_loss_20": rel(ad["losses"][-1], ANCHOR_ADAM_LOSS_20),
        "grad_1": max(rel(ad["grad1"][n], ANCHOR_ADAM_GRAD_1[n]) for n in PARAM_NAMES),
        "params_20": max(rel(ad["params"][n], ANCHOR_ADAM_PARAMS[n]) for n in PARAM_NAMES),
    }
    emit("6a_adam_path", n=N, m=M, batch=ADAM_BATCH, steps=ADAM_STEPS, lr=ADAM_LR,
         loss_1=ad["loss1"], grad_1=ad["grad1"], losses=ad["losses"], params=ad["params"],
         rel_err=adam_rel, repeat_rel=ad["repeat_rel"])
    if not max(adam_rel["loss_1"], adam_rel["fit_loss_1"], adam_rel["fit_loss_20"]) <= TOL_ADAM_LOSS:
        raise AssertionError(f"Adam losses vs the CPU-float64 anchors: {adam_rel}")
    if not max(adam_rel["grad_1"], adam_rel["params_20"]) <= TOL_ADAM_GRAD:
        raise AssertionError(f"Adam gradient or parameters vs the anchors: {adam_rel}")

    # ---- phase 6b: proof of the Adam path ----------------------------------
    # held exactly in adam_path: the step K1 = K2 = K7 = K8 = 1, the fit 20
    emit("6b_proof_of_adam_path", launches=ad["launches"])

    # ---- phase 6c: SVGP ------------------------------------------------------
    sv = svgp_path(device, x_d, y_d, x_test, y_test)
    svgp_rel = {"loss_1": rel(sv["losses"][0], ANCHOR_SVGP_LOSS_1),
                "loss_20": rel(sv["losses"][-1], ANCHOR_SVGP_LOSS_20)}
    emit("6c_svgp_path", n=N, m=M, batch=SVGP_BATCH, steps=SVGP_STEPS, lr=SVGP_LR,
         losses=sv["losses"], rel_err=svgp_rel, repeat_rel=sv["repeat_rel"],
         nlpd=sv["nlpd"], min_var=sv["min_var"],
         mean_rel_vs_cpu=sv["mean_rel_vs_cpu"], var_rel_vs_cpu=sv["var_rel_vs_cpu"],
         cpu_plain_predict_s=sv["cpu_plain_predict_s"])
    if not max(svgp_rel.values()) <= TOL_SVGP_LOSS:
        raise AssertionError(f"SVGP losses vs the CPU-float64 anchors: {svgp_rel}")
    if not max(sv["mean_rel_vs_cpu"], sv["var_rel_vs_cpu"]) <= TOL_PREDICT:
        raise AssertionError(f"SVGP predictions differ from the plain CPU ones: {sv}")

    # ---- phase 6d: proof of the SVGP path ----------------------------------
    # held exactly in svgp_path: seeding K9 = 1; a step K9 = K10 = 4,
    # K11 = K12 = 3; the fit 20 steps of that; a prediction K9 = K11 = 2
    emit("6d_proof_of_svgp_path", launches=sv["launches"])
    path_launches |= {n: ad["launches"]["fit"][n] for n in ("tak_bwd_vec", "chol_bwd_pair")}
    path_launches |= {n: sv["launches"]["fit"][n] for n in SVGP_STEP}
    if min(path_launches.values()) < 1:
        raise AssertionError(f"a kernel of the main path never launched: {path_launches}")

    # ---- phase 6e: K7-K12 at the main path's shapes -------------------------
    main_args = {**{n: ad["args"][n] for n in ("tak_bwd_vec", "chol_bwd_pair")}, **sv["args"]}
    main_adjoint = adjoint_parity(main_args)
    emit("6e_parity_adjoint_main_shape", **main_adjoint,
         calls={n: len(a) for n, a in main_args.items()}, tol=TOL_PARITY_MAIN)
    check_parity(main_adjoint, TOL_PARITY_MAIN, "of K7-K12 at the main path's shapes")
    main_parity |= main_adjoint

    # ---- phase 6f: K15 and K23 -----------------------------------------------
    pair = pair_phase(device, rng, main_bands)
    emit("6f_pair_kernels", random=pair["random"], main_shape=pair["main"],
         launches=pair["launches"], tol_random=TOL_PARITY_ADJOINT, tol_main=TOL_PARITY_MAIN)
    for row in pair["random"]:
        check_parity(row, TOL_PARITY_ADJOINT, f"of K15/K23 at k={row['k']}")
    check_parity(pair["main"], TOL_PARITY_MAIN, "of K15/K23 at the main path's shape")
    main_parity |= pair["main"]
    path_launches |= pair["launches"]

    # ---- phase 6g: K16 on random blocks --------------------------------------
    k16 = k16_parity(device)
    emit("6g_parity_k16_random", **k16, tol_well=TOL_K16, tol_ill=TOL_K16_ILL)
    if not (k16["max_rel_well"] <= TOL_K16 and k16["max_rel_ill"] <= TOL_K16_ILL
            and k16["upper_zero"] and k16["bit_equal"]):
        raise AssertionError(f"K16 against its plain version: {k16}")

    # ---- phase 6h: GPRKron at the eNATL60 protocol's shape --------------------
    kr = kron_path(device, synthetic_ssh(N_KRON + N_KRON_TEST), N_KRON_TEST, 2, KRON_M,
                   KRON_ORDER, KRON_ELL, KRON_NOISE, KRON_STEP, KRON_POSTERIOR)
    kr["stats_rel"] = stats_errors(kr["stats"], ANCHOR_KRON_STATS)
    kfit = kr["fit"]
    kron_rel = {
        "stats": max(kr["stats_rel"].values()),
        "loss": rel(kr["loss"], ANCHOR_KRON_LOSS),
        "grad": max(rel(g, a) for g, a in zip(kr["grad"], ANCHOR_KRON_GRAD)),
        "fit": max(rel(v, ANCHOR_KRON_FIT_LOSS) for v in kfit["losses"]),
        "mse": rel(kr["mse"], ANCHOR_KRON_MSE),
        "nlpd": rel(kr["nlpd"], ANCHOR_KRON_NLPD),
    }
    emit("6h_kron_path", n=N_KRON, n_test=N_KRON_TEST, m=KRON_M, order=KRON_ORDER,
         build_s=kr["build_s"], stats_repeatable=kr["stats_repeatable"], stats=kr["stats"],
         stats_rel_err=kr["stats_rel"], loss=kr["loss"], grad=kr["grad"],
         fit_losses=kfit["losses"], fit_iters=kfit["iter_counts"], fit_evals=kfit["eval_counts"],
         fit_params=kfit["params"], mse=kr["mse"], nlpd=kr["nlpd"], min_var=kr["min_var"],
         mean_rel_vs_cpu=kr["mean_rel_vs_cpu"], var_rel_vs_cpu=kr["var_rel_vs_cpu"],
         cpu_plain_posterior_s=kr["cpu_plain_posterior_s"], rel_err=kron_rel)
    if not kr["stats_repeatable"]:
        raise AssertionError("a second GPRKron stats build from the same data gave other bits")
    if not kron_rel["stats"] <= TOL_KRON_STATS:
        raise AssertionError(f"GPRKron statistics vs the CPU-float64 anchors: {kr['stats_rel']}")
    if not (kron_rel["loss"] <= TOL_KRON_LOSS and kron_rel["grad"] <= TOL_KRON_GRAD):
        raise AssertionError(f"GPRKron loss or gradient vs the anchors: {kron_rel}")
    if not (kron_rel["fit"] <= TOL_KRON_FIT
            and set(kfit["iter_counts"]) == {ANCHOR_KRON_FIT_ITERS}
            and set(kfit["eval_counts"]) == {ANCHOR_KRON_FIT_EVALS}):
        raise AssertionError(f"GPRKron fits {kfit['losses']} in {kfit['iter_counts']} "
                             f"iterations, {kfit['eval_counts']} evaluations")
    if not max(kron_rel["mse"], kron_rel["nlpd"]) <= TOL_KRON_METRICS:
        raise AssertionError(f"GPRKron MSE or NLPD vs the anchors: {kron_rel}")
    if not max(kr["mean_rel_vs_cpu"], kr["var_rel_vs_cpu"]) <= TOL_PREDICT:
        raise AssertionError(f"GPRKron predictions differ from the plain CPU ones: "
                             f"{kr['mean_rel_vs_cpu']}, {kr['var_rel_vs_cpu']}")

    # ---- phase 6i: proof of the Kron path; K16 on the blocks it got ----------
    # held exactly in kron_path: construction and predict nothing; a step
    # K9 = K10 = K11 = K12 = 2 and K16 = KRON_M; the fit that per
    # evaluation; the posterior K9 = K11 = 2 and K16 = KRON_M
    from asvgp_tpu_torch.banded import dense_block

    k16_blocks = [a[0] for a in kr["args"]["chol_inv_dense"]]
    k16_host = torch.stack([blk.cpu() for blk in k16_blocks])
    eig = torch.linalg.eigvalsh(k16_host)
    k16_kappa = float((eig[:, -1] / eig[:, 0]).max())
    k16_main = {"chol_inv_dense_rel": 0.0, "chol_inv_dense_abs": 0.0}
    for blk, host in zip(k16_blocks, k16_host):
        errs = _errs("chol_inv_dense", dense_block.chol_inv_dense(blk),
                     dense_block.chol_inv_dense_plain(host))
        k16_main = {key: max(k16_main[key], errs[key]) for key in k16_main}
    tol_k16_main = TOL_K16 if k16_kappa <= 1e4 else TOL_K16_ILL
    emit("6i_proof_of_kron_path", launches=kr["launches"], k16_blocks=len(k16_blocks),
         k16_max_kappa=k16_kappa, **k16_main, tol=tol_k16_main)
    check_parity(k16_main, tol_k16_main, "of K16 on the Kron step's diagonal blocks")
    main_parity |= k16_main
    path_launches["chol_inv_dense"] = kfit["launches"]["chol_inv_dense"]
    # K24 at the map cell's shape on this posterior's band of P⁻¹
    bw = block_window_phase(device, kr["post"])
    emit("6i_block_window", card=smi, n=bw["n"], K=bw["K"], T=bw["T"],
         launches=bw["launches"], bit_equal=bw["bit_equal"],
         shuffled_bit_equal=bw["shuffled_bit_equal"], **bw["errs"], tol=TOL_K24)
    check_parity(bw["errs"], TOL_K24, "of K24 at the map cell's shape")
    if not (bw["bit_equal"] and bw["shuffled_bit_equal"]):
        raise AssertionError(f"K24 is not repeatable bit for bit: two launches equal "
                             f"{bw['bit_equal']}, shuffled equal {bw['shuffled_bit_equal']}")
    main_parity |= bw["errs"]
    path_launches["block_window_quad"] = kr["launches"]["predict"]["block_window_quad"]

    # ---- phase 6j: the solves K13/K14 and the float32 kernels K17-K22 -------
    for k in range(1, 7):
        res = adjoint_parity(random_f32_inputs(k, PARITY_M, rng, device), f32_calls())
        emit("6j_parity_solves_f32_random", k=k, m=PARITY_M, rhs=[1, SOLVE_RHS], **res,
             tol={name: f32_tol(name) for name in f32_calls()})
        check_each(res, f32_tol, f"of K13/K14 and K17-K22 at k={k}")
    fn_parity = solve_function_parity(device, rng)
    emit("6j_parity_solve_functions", k=3, m=PARITY_M, **fn_parity,
         tol={"float64": TOL_PARITY, "float32": TOL_F32_ADJOINT})
    check_each(fn_parity, lambda name: TOL_F32_ADJOINT if name.endswith("_f32") else TOL_PARITY,
               "of the solves' autograd Functions")
    edges = solve_edge_parity(device, rng)
    emit("6j_parity_solve_edges", **edges, tol={n: f32_tol(n) for n in SOLVES})
    check_each(edges, f32_tol, "of K13/K14/K21/K22 at the edges of their partitions")
    sol = solve_north_star(device, main_bands)
    emit("6j_solves_north_star", m=M, u_rel_vs_banded_posterior=sol["u_rel"],
         tol=TOL_SOLVE_NORTH_STAR, launches=sol["launches"], **sol["main"],
         tol_main=TOL_PARITY_MAIN,
         lower_solve_maps=solve_maps("solve_lower", *sol["args"]["solve_lower"][0]),
         upper_solve_maps=solve_maps("solve_upper_t", *sol["args"]["solve_upper_t"][0]))
    if not sol["u_rel"] <= TOL_SOLVE_NORTH_STAR:
        raise AssertionError(f"cholesky_solve_band vs banded_posterior's u: {sol['u_rel']}")
    check_parity(sol["main"], TOL_PARITY_MAIN, "of K13/K14 at the north star")
    main_parity |= sol["main"]
    path_launches |= {n: sol["launches"][n] for n in ("solve_lower", "solve_upper_t")}

    # ---- phase 6k: the float32 GPR1D at the north star ----------------------
    f32 = f32_path(device, x_d, y_d, x_test, y_test)
    f32_rel = {
        "loss": rel(f32["loss"], ANCHOR_F32_LOSS),
        "grad": {n: rel(f32["grad"][n], ANCHOR_F32_GRAD[n]) for n in PARAM_NAMES},
        "mean": summary_rel(f32["mean"], ANCHOR_F32_MEAN),
        "var": summary_rel(f32["var"], ANCHOR_F32_VAR),
        "nlpd": rel(f32["nlpd"], ANCHOR_F32_NLPD),
        "mean_pointwise": f32["mean_rel_vs_cpu"], "var_pointwise": f32["var_rel_vs_cpu"],
    }
    emit("6k_f32_path", n=N, m=M, n_test=N_TEST, batch=PREDICT_BATCH, build_s=f32["build_s"],
         loss=f32["loss"], grad=f32["grad"], nlpd=f32["nlpd"], mean=f32["mean"], var=f32["var"],
         min_var=f32["min_var"], cpu_plain_posterior_s=f32["cpu_plain_posterior_s"],
         rel_err=f32_rel, tol=TOL_F32)
    f32_vs_f64 = rel(f32["loss"], ANCHOR_LOSS)
    emit("6k_f32_loss_vs_f64_anchor", loss=f32["loss"], anchor=ANCHOR_LOSS, rel_err=f32_vs_f64,
         tol=TOL_F32_VS_F64)
    # information: the card's and the JAX float32 route's distances from
    # the float64 values
    emit("6k_f32_vs_f64_values",
         card={"grad": {n: rel(f32["grad"][n], ANCHOR_GRAD[n]) for n in PARAM_NAMES},
               "var": summary_rel(f32["var"], ANCHOR_F64_VAR),
               "nlpd": rel(f32["nlpd"], ANCHOR_F64_NLPD)},
         jax_f32={"loss": rel(ANCHOR_F32_LOSS, ANCHOR_LOSS),
                  "grad": {n: rel(ANCHOR_F32_GRAD[n], ANCHOR_GRAD[n]) for n in PARAM_NAMES},
                  "var": summary_rel(ANCHOR_F32_VAR, ANCHOR_F64_VAR),
                  "nlpd": rel(ANCHOR_F32_NLPD, ANCHOR_F64_NLPD)})
    bad = [key for key in ("loss", "mean", "var", "nlpd", "mean_pointwise", "var_pointwise")
           if not f32_rel[key] <= TOL_F32[key]]
    bad += [n for n in PARAM_NAMES if not f32_rel["grad"][n] <= TOL_F32["grad"][n]]
    if bad or not f32_vs_f64 <= TOL_F32_VS_F64:
        raise AssertionError(f"float32 GPR1D: {bad} outside {TOL_F32}: {f32_rel}; "
                             f"loss vs the float64 anchor {f32_vs_f64}")

    # ---- phase 6l: proof of the float32 path; K17-K22 on its arguments ------
    # held exactly in f32_path: construction and predict nothing, the step
    # F32_STEP, the posterior F32_POSTERIOR, no plain version on the card
    f32_main_args = {name: [calls[0], calls[-1]] if len(calls) > 1 else calls
                     for name, calls in f32["args"].items()}
    f32_main = adjoint_parity(f32_main_args, f32_calls())
    emit("6l_proof_of_f32_path", launches=f32["launches"], **f32_main,
         calls={n: len(a) for n, a in f32["args"].items()}, tol=TOL_F32_MAIN,
         lower_solve_maps=solve_maps("solve_lower", *f32["args"]["solve_lower_f32"][0]),
         upper_solve_maps=solve_maps("solve_upper_t", *f32["args"]["solve_upper_t_f32"][0]))
    check_parity(f32_main, TOL_F32_MAIN, "of K17-K22 on the float32 path's arguments")
    main_parity |= f32_main
    path_launches |= {n: f32["launches"]["step"][n] + f32["launches"]["posterior"][n]
                      for n in F32_STEP}
    # the adjoints' composed chunk maps on the factors the main paths pass
    # them: L_Kuu and L_P at the north star (phase 6f's pair), the Adam
    # step's L_Kuu, the SVGP step's R and L_Kuu, the two GPRKron factors and
    # the float32 step's
    pair_l, pair_s, pair_cot, pair_iv = pair["io"]["tak_bwd_pair"][0]
    emit("6l_adjoint_maps", card=smi,
         north_star=adjoint_maps_of({"chol_bwd_pair": [(pair_l, pair_cot)],
                                     "tak_bwd_pair": [(pair_l, pair_s, pair_cot, pair_iv)]}),
         adam=adjoint_maps_of({n: ad["args"][n] for n in ("tak_bwd_vec", "chol_bwd_pair")}),
         svgp=adjoint_maps_of({n: sv["args"][n] for n in ("chol_bwd", "tak_bwd")}),
         kron=adjoint_maps_of({n: kr["args"][n] for n in ("chol_bwd", "tak_bwd")}),
         f32=adjoint_maps_of({n: f32["args"][n] for n in ("chol_bwd_f32", "tak_bwd_f32")}))
    # the forward sweeps' partitions on the same paths' arguments (the Adam
    # step runs neither): the north star's Kuu and P (K15) and their
    # factors, the SVGP step's, the GPRKron step's and the float32 step's
    # and posterior's
    emit("6l_forward_maps", card=smi,
         north_star=forward_maps_of({"chol_fwd_pair": [pair["io"]["chol_fwd_pair"][0]],
                                     "tak_fwd": [(pair_l[0],), (pair_l[1],)]}),
         svgp=forward_maps_of({n: sv["args"][n] for n in ("chol_fwd", "tak_fwd")}),
         kron=forward_maps_of({n: kr["args"][n] for n in ("chol_fwd", "tak_fwd")}),
         f32=forward_maps_of({n: f32["args"][n] for n in ("chol_fwd_f32", "tak_fwd_f32")}))

    # the twisted sweeps' partitions on the north star's Kuu, T, P and Kuf·y
    # (the bands every twisted step of the fit meets first)
    emit("6l_twist_maps", card=smi, north_star=twist_maps(main_bands))
    # the serving sweeps' partitions on the same bands (the posterior's and
    # the ELBO value's Kuu, P and Kuf·y)
    emit("6l_core_maps", card=smi, north_star=core_maps(main_bands))
    # the single-ended tangent sweeps' partitions on the same bands (every
    # single-ended step meets them first)
    emit("6l_tan_maps", card=smi, north_star=tan_maps(main_bands))

    # ---- phase 6m: GPRAdditive at ADDITIVE_PROBE.json's shape ----------------
    ag = additive_path(device)
    afit = ag["fit"]
    add_rel = {
        "stats": max(ag["stats_rel"].values()),
        "loss": rel(ag["loss"], ANCHOR_ADD_LOSS),
        "grad": max(rel(g, a) for g, a in zip(ag["grad"], ANCHOR_ADD_GRAD, strict=True)),
        "fit": max(rel(v, ANCHOR_ADD_FIT_LOSS) for v in afit["losses"]),
        "mse": rel(ag["mse"], ANCHOR_ADD_MSE),
        "nlpd": rel(ag["nlpd"], ANCHOR_ADD_NLPD),
    }
    emit("6m_additive_path", n=N_ADD, n_test=N_ADD_TEST, d=ADD_D, m=ADD_M,
         build_s=ag["build_s"], stats_repeatable=ag["stats_repeatable"], stats=ag["stats"],
         stats_rel_err=ag["stats_rel"], loss=ag["loss"], grad=ag["grad"],
         fit_losses=afit["losses"], fit_iters=afit["iter_counts"], fit_evals=afit["eval_counts"],
         fit_params=afit["params"], fit_ms_per_iter=afit["ms_per_iter"],
         fit_ms_per_iter_all=afit["ms_per_iter_all"], mse=ag["mse"], nlpd=ag["nlpd"],
         min_var=ag["min_var"], mean_rel_vs_cpu=ag["mean_rel_vs_cpu"],
         var_rel_vs_cpu=ag["var_rel_vs_cpu"], cpu_plain_posterior_s=ag["cpu_plain_posterior_s"],
         rel_err=add_rel, card=smi)
    if not ag["stats_repeatable"]:
        raise AssertionError("a second GPRAdditive stats build from the same data gave other bits")
    if not add_rel["stats"] <= TOL_ADD_STATS:
        raise AssertionError(f"GPRAdditive statistics vs the CPU-float64 anchors: "
                             f"{ag['stats_rel']}")
    if not (add_rel["loss"] <= TOL_ADD_LOSS and add_rel["grad"] <= TOL_ADD_GRAD):
        raise AssertionError(f"GPRAdditive loss or gradient vs the anchors: {add_rel}")
    if not (add_rel["fit"] <= TOL_ADD_FIT
            and set(afit["iter_counts"]) == {ANCHOR_ADD_FIT_ITERS}
            and set(afit["eval_counts"]) == {ANCHOR_ADD_FIT_EVALS}):
        raise AssertionError(f"GPRAdditive fits {afit['losses']} in {afit['iter_counts']} "
                             f"iterations, {afit['eval_counts']} evaluations")
    if not max(add_rel["mse"], add_rel["nlpd"]) <= TOL_ADD_METRICS:
        raise AssertionError(f"GPRAdditive MSE or NLPD vs the anchors: {add_rel}")
    if not max(ag["mean_rel_vs_cpu"], ag["var_rel_vs_cpu"]) <= TOL_PREDICT:
        raise AssertionError(f"GPRAdditive predictions differ from the plain CPU ones: "
                             f"{ag['mean_rel_vs_cpu']}, {ag['var_rel_vs_cpu']}")

    # ---- phase 6n: proof of the additive path; its kernels on its arguments --
    # held exactly in additive_path: construction and predict nothing; a
    # step K9 = K10 = K11 = K12 = ADD_D and K16 = ADD_NB; the fit that per
    # evaluation; the posterior K9 = K11 = ADD_D and K16 = ADD_NB; K16 equal
    # bit for bit to its plain version on the step's diagonal blocks, and
    # K9-K12 against theirs on the step's arguments (m = ADD_M)
    add_blocks = [a[0] for a in ag["args"]["chol_inv_dense"]]
    add_host = torch.stack([blk.cpu() for blk in add_blocks])
    add_eig = torch.linalg.eigvalsh(add_host)
    add_k16 = {"chol_inv_dense_rel": 0.0, "chol_inv_dense_abs": 0.0}
    add_k16_equal = True
    for blk, host in zip(add_blocks, add_host):
        got, want = dense_block.chol_inv_dense(blk), dense_block.chol_inv_dense_plain(host)
        add_k16_equal &= all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
        errs = _errs("chol_inv_dense", got, want)
        add_k16 = {key: max(add_k16[key], errs[key]) for key in add_k16}
    add_single = adjoint_parity({n: ag["args"][n] for n in ("chol_fwd", "chol_bwd", "tak_fwd",
                                                            "tak_bwd")})
    emit("6n_proof_of_additive_path", launches=ag["launches"], k16_blocks=len(add_blocks),
         k16_block_size=add_blocks[0].shape[-1],
         k16_max_kappa=float((add_eig[:, -1] / add_eig[:, 0]).max()),
         k16_bit_equal=add_k16_equal, **add_k16, **add_single,
         calls={n: len(a) for n, a in ag["args"].items()}, tol=TOL_PARITY_MAIN)
    if not (add_k16_equal and len(add_blocks) == ADD_NB):
        raise AssertionError(f"K16 on the additive step's {len(add_blocks)} diagonal blocks "
                             f"is not its plain version bit for bit: {add_k16}")
    check_parity(add_single, TOL_PARITY_MAIN, "of K9-K12 on the additive step's arguments")
    add_launches = ag["launches"]["step"]

    # ---- phase 6o: the linear sweeps' chunk-length rule ----------------------
    # GPRAdditive past the two-chunk limit against the all-plain step; the
    # sweeps the rule chunks at the protocol's Kuu and P against their plain
    # versions, within RULE_SPREAD times the plain version's own spread; the
    # lengths chosen at the north star and at these shapes, the card's equal
    # to banded/chunk_rule.py's
    rep = repair_additive(device)
    emit("6o_repair_additive", card=smi, **rep, tol_grad=TOL_REPAIR_GRAD,
         tol_sweep=TOL_REPAIR_SWEEP)
    if not (rep["grad_rel_vs_plain"] <= TOL_REPAIR_GRAD
            and max(rep["kernel_vs_plain"][n] for n in ("chol_bwd", "tak_fwd"))
            <= TOL_REPAIR_SWEEP):
        raise AssertionError(f"GPRAdditive past the two-chunk limit: the gradient "
                             f"{rep['grad_rel_vs_plain']} from the all-plain step, K10/K11 "
                             f"{rep['kernel_vs_plain']} from their plain versions")
    rule = rule_sweeps(device)
    ns_cols = north_star_cols(main_bands)
    emit("6o_rule_sweeps", card=smi, m=RULE_M, ell=RULE_ELL, sweeps=rule,
         north_star_cols=ns_cols, spread_bar=RULE_SPREAD)
    sweeps = {n: r for n, r in rule.items() if isinstance(r, dict)}
    bad = {n: r for n, r in sweeps.items() if not r["rel"] <= RULE_SPREAD * r["spread"]}
    if bad:
        raise AssertionError(f"sweeps beyond {RULE_SPREAD}x the one-chunk spread at the "
                             f"protocol's Kuu: {bad}")
    cols = [rep["chunk_cols"]] + [r["chunk_cols"] for n, r in sweeps.items()
                                  if not n.endswith("_f32")] + list(ns_cols.values())
    if any(c["numpy"] is not None and c["card"] != c["numpy"] for c in cols):
        raise AssertionError(f"the card's chunk lengths are not the rule's: {cols}")
    if any(c["card"] != RULE_NORTH_STAR for c in ns_cols.values()):
        raise AssertionError(f"the rule moved the north star's chunks: {ns_cols}")

    # ---- phase 6p: the large-regression protocol at full width ---------------
    lr = protocol_path(device)
    lr_rel = protocol_errors(lr)
    emit("6p_protocol", card=smi, n=LR_N, m=LR_M, row=lr["row"], rel_err=lr_rel,
         tol={k: list(v) if isinstance(v, tuple) else v for k, v in TOL_LR.items()},
         anchor_fit_evals=ANCHOR_LR["fit_evals"],
         loss=lr["loss"], grad=lr["grad"], fit_evals=lr["fit_evals"],
         vff_fit_iters=lr["vff_fit_iters"], vff_fit_evals=lr["vff_fit_evals"],
         adam=lr["adam"], svgp=lr["svgp"], vff_loss=lr["vff_loss"], vff_grad=lr["vff_grad"])
    emit("6p_proof_of_protocol", card=smi,
         launches={n: st["launches"] for n, st in lr["stages"].items()},
         stage_ms={n: {"host_ms": st["host_ms"], "event_ms": st["event_ms"]}
                   for n, st in lr["stages"].items()},
         times=lr["times"])
    bad = protocol_misses(lr_rel)
    counts = {"fit": lr["fit_iters"], "vff_fit": (lr["vff_fit_iters"], lr["vff_fit_evals"])}
    want_counts = {"fit": ANCHOR_LR["fit_iters"],
                   "vff_fit": (ANCHOR_LR["vff_fit_iters"], ANCHOR_LR["vff_fit_evals"])}
    if bad or counts != want_counts:
        raise AssertionError(f"the protocol against its anchors: {bad}; iterations and "
                             f"evaluations {counts}, the anchors' {want_counts}")
    lr_launches = {}
    for st in lr["stages"].values():
        for n, c in st["launches"].items():
            lr_launches[n] = lr_launches.get(n, 0) + c

    # ---- phase 6q: the eNATL60 protocol's torch leg at full width ------------
    leg = enatl_leg(device)
    art = leg["artifact"]
    leg_rel = {"elbo": rel(-art["elbo"], ANCHOR_KRON_FIT_LOSS),
               "mse": rel(art["mse"], ANCHOR_KRON_MSE), "nll": rel(art["nll"], ANCHOR_KRON_NLPD)}
    emit("6q_enatl_leg", card=smi, artifact=art, rel_err=leg_rel,
         tol={"elbo": TOL_KRON_FIT, "mse": TOL_KRON_METRICS, "nll": TOL_KRON_METRICS},
         launches=leg["launches"], stage_s=leg["seconds"])
    if set(art) != ENATL_KEYS:
        raise AssertionError(f"the eNATL60 leg's artifact keys: {sorted(set(art) ^ ENATL_KEYS)}")
    if not (leg_rel["elbo"] <= TOL_KRON_FIT
            and max(leg_rel["mse"], leg_rel["nll"]) <= TOL_KRON_METRICS
            and art["iters"] == ANCHOR_KRON_FIT_ITERS
            and art["opt_info"]["ls_evals"] == ANCHOR_KRON_FIT_EVALS):
        raise AssertionError(f"the eNATL60 leg against the GPRKron anchors: {leg_rel}, "
                             f"{art['iters']} iterations, {art['opt_info']['ls_evals']} evaluations")
    leg_launches = {n: sum(st[n] for st in leg["launches"].values()) for n in KERNELS}

    # ---- phase 6r: GPRKron at D = 3 ------------------------------------------
    nd = kron_path(device, synthetic_field_3d(N_ND + N_ND_TEST), N_ND_TEST, ND_D, ND_M, ND_ORDER,
                   ND_ELL, ND_NOISE, ND_STEP, ND_POSTERIOR, fit_reps=ND_FIT_REPS)
    ndfit = nd["fit"]
    nd_stats_rel = stats_errors(nd["stats"], ANCHOR_ND["stats"])
    nd_rel = {
        "stats": max(nd_stats_rel.values()),
        "loss": rel(nd["loss"], ANCHOR_ND["loss"]),
        "grad": max(rel(g, a) for g, a in zip(nd["grad"], ANCHOR_ND["grad"], strict=True)),
        "fit": max(rel(v, ANCHOR_ND["fit_loss"]) for v in ndfit["losses"]),
        "mse": rel(nd["mse"], ANCHOR_ND["mse"]),
        "nlpd": rel(nd["nlpd"], ANCHOR_ND["nlpd"]),
    }
    emit("6r_kron_nd_path", card=smi, n=N_ND, n_test=N_ND_TEST, d=ND_D, m=ND_M, order=ND_ORDER,
         block=ND_B, build_s=nd["build_s"], stats_repeatable=nd["stats_repeatable"],
         stats=nd["stats"], stats_rel_err=nd_stats_rel, loss=nd["loss"], grad=nd["grad"],
         fit_losses=ndfit["losses"], fit_iters=ndfit["iter_counts"],
         fit_evals=ndfit["eval_counts"], fit_params=ndfit["params"], mse=nd["mse"],
         nlpd=nd["nlpd"], min_var=nd["min_var"], mean_rel_vs_cpu=nd["mean_rel_vs_cpu"],
         var_rel_vs_cpu=nd["var_rel_vs_cpu"], cpu_plain_posterior_s=nd["cpu_plain_posterior_s"],
         rel_err=nd_rel, tol=TOL_ND)
    if not nd["stats_repeatable"]:
        raise AssertionError("a second D = 3 stats build from the same data gave other bits")
    bad = {key: v for key, v in nd_rel.items() if not v <= TOL_ND[key]}
    if bad or set(ndfit["iter_counts"]) != {ANCHOR_ND["fit_iters"]} \
            or set(ndfit["eval_counts"]) != {ANCHOR_ND["fit_evals"]}:
        raise AssertionError(f"GPRKron at D = 3 against its anchors: {bad}; fits in "
                             f"{ndfit['iter_counts']} iterations, {ndfit['eval_counts']} "
                             f"evaluations")
    if not max(nd["mean_rel_vs_cpu"], nd["var_rel_vs_cpu"]) <= TOL_PREDICT:
        raise AssertionError(f"D = 3 predictions differ from the plain CPU ones: "
                             f"{nd['mean_rel_vs_cpu']}, {nd['var_rel_vs_cpu']}")

    # ---- phase 6s: proof of the D = 3 path; K16 at B = 400, K9-K12 -----------
    # held exactly in kron_path: construction and predict nothing; a step
    # K9 = K10 = K11 = K12 = ND_D and K16 = ND_M; the fit that per
    # evaluation; the posterior K9 = K11 = ND_D and K16 = ND_M.  K16 equal
    # bit for bit to its plain version on the step's ND_M diagonal blocks of
    # side ND_B; K9-K12 within TOL_PARITY_ADJOINT of theirs on the step's
    # arguments
    nd_blocks = [a[0] for a in nd["args"]["chol_inv_dense"]]
    nd_host = torch.stack([blk.cpu() for blk in nd_blocks])
    nd_eig = torch.linalg.eigvalsh(nd_host)
    nd_plain = dense_block.chol_inv_dense_plain(nd_host)
    nd_k16 = {"chol_inv_dense_rel": 0.0, "chol_inv_dense_abs": 0.0}
    nd_k16_equal = len(nd_blocks) == ND_M and all(blk.shape == (ND_B, ND_B) for blk in nd_blocks)
    for i, blk in enumerate(nd_blocks):
        got, want = dense_block.chol_inv_dense(blk), (nd_plain[0][i], nd_plain[1][i])
        nd_k16_equal &= all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
        errs = _errs("chol_inv_dense", got, want)
        nd_k16 = {key: max(nd_k16[key], errs[key]) for key in nd_k16}
    del nd_host, nd_plain
    nd_single = adjoint_parity({n: nd["args"][n] for n in ("chol_fwd", "chol_bwd", "tak_fwd",
                                                           "tak_bwd")})
    emit("6s_proof_of_kron_nd_path", card=smi, launches=nd["launches"],
         k16_blocks=len(nd_blocks), k16_block_size=ND_B,
         k16_max_kappa=float((nd_eig[:, -1] / nd_eig[:, 0]).max()), k16_bit_equal=nd_k16_equal,
         **nd_k16, **nd_single, calls={n: len(a) for n, a in nd["args"].items()},
         tol=TOL_PARITY_ADJOINT)
    if not nd_k16_equal:
        raise AssertionError(f"K16 on the D = 3 step's {len(nd_blocks)} diagonal blocks is not "
                             f"its plain version bit for bit: {nd_k16}")
    check_parity(nd_single, TOL_PARITY_ADJOINT, "of K9-K12 on the D = 3 step's arguments")
    nd_launches = nd["launches"]["step"]

    # ---- phase 6t: the float32 trainers -----------------------------------
    f32t = f32_trainers(device, f32["model"], x_d, y_d)
    f32t_errs, bad = f32_trainer_errors(f32t)
    emit("6t_f32_trainers", card=smi, runs=f32t, rel_err=f32t_errs,
         spread={n: F32_FITS[n]["spread"] for n in F32_FITS} | {"adam": F32_ADAM["spread"]},
         per_eval=F32_STEP)
    if bad:
        raise AssertionError(f"float32 trainers against tools/f32_fit_anchors.py: {bad}; "
                             f"{f32t_errs}")
    f32t_launches = {n: sum(r["launches"].get(n, 0) for r in f32t.values()) for n in KERNELS}

    # ---- phase 6u: data parallelism, a world of one rank on NCCL ---------------
    dp = dp_phase(device, x_d, y_d, art)
    emit("6u_dp", card=smi, stats=dp["stats"], steps=dp["steps"],
         leg={"elbo": dp["leg"]["artifact"]["elbo"], "mse": dp["leg"]["artifact"]["mse"],
              "nll": dp["leg"]["artifact"]["nll"], "iters": dp["leg"]["artifact"]["iters"],
              "evals": dp["leg"]["artifact"]["opt_info"]["ls_evals"],
              "equal_to_6q": dp["leg"]["equal"], "seconds": dp["leg"]["seconds"],
              "timings_s": dp["leg"]["artifact"]["timings_s"]})
    bad = [f"{n} statistics" for n, st in dp["stats"].items() if not st["bit_equal"]]
    bad += [f"{n} steps" for n, st in dp["steps"].items() if not st["bit_equal"]]
    bad += [f"leg {k}" for k, eq in dp["leg"]["equal"].items() if not eq]
    if bad:
        raise AssertionError(f"a world of one rank differs from the run without it: {bad}")
    dp_launches = {n: sum(st["launches"].get(n, 0) for st in dp["steps"].values())
                   for n in KERNELS}

    # ---- phase 6v: block cyclic reduction (GPR1D(..., backend="cr")) --------
    cr = cr_phase(device, x, x_d, y_d, run, tr, main_bands)
    cr_rel = {"loss_vs_anchor": rel(cr["loss"], ANCHOR_LOSS),
              "loss_vs_twisted": rel(cr["loss"], tr["loss_twist"]),
              "grad_vs_anchor": {n: rel(cr["grad"][n], ANCHOR_GRAD[n]) for n in PARAM_NAMES},
              "fit_vs_anchor": rel(cr["fit_loss"], ANCHOR_FIT_LOSS)}
    emit("6v_cr", card=smi, n=N, m=M, loss=cr["loss"], grad=cr["grad"], rel_err=cr_rel,
         posterior_rel=cr["posterior_rel"], predict_rel=cr["predict_rel"],
         fit_loss=cr["fit_loss"], fit_iters=cr["fit_iters"], fit_evals=cr["fit_evals"],
         fit_s=cr["fit_s"], trace=cr["trace"], checkpoint=cr["checkpoint"],
         kuf_card_vs_cpu=cr["kuf"], launches=cr["launches"], sync_free=True,
         seconds=cr["seconds"],
         tol={"loss": TOL_CR, "grad": TOL_GRAD, "routes": TOL_ROUTES, "posterior": TOL_CR,
              "fit": TOL_FIT})
    for what, sides in cr["ab"].items():
        emit("6v_cr_ab", card=smi, what=what, **sides, cr_vs_walks_rel=cr["ab_rel"].get(what))
    bad = []
    if not cr_rel["loss_vs_anchor"] <= TOL_CR:
        bad.append("loss vs ANCHOR_LOSS")
    if not max(cr_rel["grad_vs_anchor"].values()) <= TOL_GRAD:
        bad.append("gradient vs ANCHOR_GRAD")
    if not cr_rel["loss_vs_twisted"] <= TOL_ROUTES:
        bad.append("loss vs the twisted route")
    if not max(*cr["posterior_rel"].values(), *cr["predict_rel"].values()) <= TOL_CR:
        bad.append("posterior or predictions vs the default route")
    if not (cr_rel["fit_vs_anchor"] <= TOL_FIT and cr["fit_iters"] == ANCHOR_FIT_ITERS):
        bad.append("fit vs ANCHOR_FIT_LOSS")
    if not (cr["trace"]["files"] == 1 and cr["trace"]["kernel_events"] > 0):
        bad.append("trace_to wrote no trace with CUDA kernel events")
    if not (cr["checkpoint"]["bit_equal"] and cr["checkpoint"]["on_card"]):
        bad.append("checkpoint round trip")
    if not (cr["kuf"]["pattern_equal"] and cr["kuf"]["max_abs_diff"] <= TOL_KUF):
        bad.append("kuf_to_scipy from the card vs the CPU")
    if bad:
        raise AssertionError(f"phase 6v (cyclic reduction): {bad}; {cr_rel}")

    # ---- phase 7: times on the card ---------------------------------------
    from asvgp_tpu_torch import banded
    from asvgp_tpu_torch.banded import block, lower_band_to_dense, single
    from asvgp_tpu_torch.features.spline_features import make_kuu
    from asvgp_tpu_torch.models import additive
    from asvgp_tpu_torch.models.kron import _p_blocks as kron_p_blocks
    from asvgp_tpu_torch.stats import (
        compute_additive_stats,
        compute_kron_stats,
        compute_kron_stats_nd,
        compute_stats,
    )

    model, post, xt = run["model"], run["posterior"], run["x_test"]
    tmodel = tr["model"]
    kuu, tanb, p_band, b = main_bands
    k, m = kuu.shape[0] - 1, kuu.shape[1]
    k1 = core.chol_pair_solve(kuu, p_band, b)
    k2 = core.tak_pair_solve(*k1)
    k3 = tan.chol_pair_solve_tan(*main_bands)
    k4 = tan.tak_pair_solve_tan(*k3)
    k5 = twist.chol_quad_solve_tan(*main_bands)
    _, z, x2, _ = twist.mid_step(*main_bands, k5[0], k5[1], k5[4])
    z, x2 = z.contiguous(), x2.contiguous()
    k6 = twist.tak_quad_solve_tan(*k5, z, x2, m)
    io = {  # (inputs, outputs) of each kernel at the main path's shape
        "chol_pair_solve": ((kuu, p_band, b), k1),
        "tak_pair_solve": (k1, k2),
        "chol_pair_solve_tan": (main_bands, k3),
        "tak_pair_solve_tan": (k3, k4),
        "chol_quad_solve_tan": (main_bands, k5),
        "tak_quad_solve_tan": ((*k5, z, x2), k6),
    }
    calls = {
        "chol_pair_solve": (lambda: core.chol_pair_solve(kuu, p_band, b),
                            lambda: core.chol_pair_solve_plain(kuu, p_band, b)),
        "tak_pair_solve": (lambda: core.tak_pair_solve(*k1),
                           lambda: core.tak_pair_solve_plain(*k1)),
        "chol_pair_solve_tan": (lambda: tan.chol_pair_solve_tan(*main_bands),
                                lambda: tan.chol_pair_solve_tan_plain(*main_bands)),
        "tak_pair_solve_tan": (lambda: tan.tak_pair_solve_tan(*k3),
                               lambda: tan.tak_pair_solve_tan_plain(*k3)),
        "chol_quad_solve_tan": (lambda: twist.chol_quad_solve_tan(*main_bands),
                                lambda: twist.chol_quad_solve_tan_plain(*main_bands)),
        "tak_quad_solve_tan": (lambda: twist.tak_quad_solve_tan(*k5, z, x2, m),
                               lambda: twist.tak_quad_solve_tan_plain(*k5, z, x2, m)),
    }
    # K7-K12 on the first arguments each got on the main path (the Adam
    # step's and the SVGP step's), k = 3, m = 10⁴
    for name, (kernel_fn, plain_fn) in adjoint_calls().items():
        args = main_args[name][0]
        io[name] = (args, (kernel_fn(*args),))
        calls[name] = (lambda f=kernel_fn, a=args: f(*a), lambda f=plain_fn, a=args: f(*a))
    # K15 and K23 on their phase-6f inputs, K16 on the Kron step's first
    # diagonal block (B = 100)
    io |= pair["io"]
    pair_args = pair["io"]["tak_bwd_pair"][0]
    calls["chol_fwd_pair"] = (lambda: single.chol_fwd_pair(kuu, p_band),
                              lambda: single.chol_fwd_pair_plain(kuu, p_band))
    calls["tak_bwd_pair"] = (lambda: core.tak_bwd_pair(*pair_args),
                             lambda: core.tak_bwd_pair_plain(*pair_args))
    blk = k16_blocks[0]
    calls["chol_inv_dense"] = (lambda: dense_block.chol_inv_dense(blk),
                               lambda: dense_block.chol_inv_dense_plain(blk))
    blk_batch = torch.stack(k16_blocks)
    eye = torch.eye(blk.shape[0], dtype=blk.dtype, device=device)
    # K24 on one map request's windows (phase 6i), in the map's order; its
    # time on the same points shuffled is block_window_quad_shuffled
    from asvgp_tpu_torch.banded.block_window import block_window_quad, block_window_quad_plain

    calls["block_window_quad"] = (lambda: block_window_quad(*bw["ordered"]),
                                  lambda: block_window_quad_plain(*bw["ordered"]))
    # K13/K14 on the arguments the north star's cholesky_solve_band gave
    # them; K17-K22 on the float32 step's (K17 on its P)
    new_args = {**{n: sol["args"][n][0] for n in ("solve_lower", "solve_upper_t")},
                **{n: f32["args"][n][0] for n in F32_STEP},
                "chol_fwd_f32": f32["args"]["chol_fwd_f32"][1]}
    for name, (kernel_fn, plain_fn) in f32_calls().items():
        args = new_args[name]
        io[name] = (args, (kernel_fn(*args),))
        calls[name] = (lambda f=kernel_fn, a=args: f(*a), lambda f=plain_fn, a=args: f(*a))

    def library_chol_inv(m):
        """The same function by PyTorch's library calls (timed, never used
        by the port): Cholesky, then the triangular solve against I."""
        return torch.linalg.solve_triangular(torch.linalg.cholesky(m), eye.expand_as(m),
                                             upper=False)

    kmodel, kpost, kparams = kr["model"], kr["post"], kr["params"]
    with torch.no_grad():
        kernels_k, lik_k = kmodel._build()
        kuu_k = [make_kuu(kk, bb) for kk, bb in zip(kernels_k, kmodel.bases)]
        p_blocks = kron_p_blocks(kmodel.bases, kuu_k, lik_k.variance, kmodel.t_band)
        core.reset_counters()
        block.cholesky_block_banded(p_blocks)
    read_launches(device, "one block Cholesky", {"chol_inv_dense": KRON_M})

    # GPRKron at D = 3: one block Cholesky of P (ND_M blocks of side ND_B);
    # K16 on the step's first diagonal block, on all ND_M in one launch and
    # as ND_M launches back to back, against the library pair on the same
    # blocks
    ndmodel, ndpost, ndparams = nd["model"], nd["post"], nd["params"]
    with torch.no_grad():
        kernels_n, lik_n = ndmodel._build()
        kuu_n = [make_kuu(kk, bb) for kk, bb in zip(kernels_n, ndmodel.bases)]
        p_blocks_nd = kron_p_blocks(ndmodel.bases, kuu_n, lik_n.variance, ndmodel.t_band)
        core.reset_counters()
        block.cholesky_block_banded(p_blocks_nd)
    read_launches(device, "one D = 3 block Cholesky", {"chol_inv_dense": ND_M})
    nblk = nd_blocks[0]
    nblk_batch = torch.stack(nd_blocks)
    eye_b400 = torch.eye(ND_B, dtype=nblk.dtype, device=device)
    calls[f"chol_inv_dense_b{ND_B}"] = (lambda: dense_block.chol_inv_dense(nblk),
                                        lambda: dense_block.chol_inv_dense_plain(nblk))

    def k16_chain():
        for blk in nd_blocks:
            dense_block.chol_inv_dense(blk)

    def library_b400(blk):
        return torch.linalg.solve_triangular(torch.linalg.cholesky(blk), eye_b400, upper=False)

    def library_chain():
        for blk in nd_blocks:
            library_b400(blk)

    # GPRAdditive: K16 on the step's first diagonal block (B = 128) and on
    # all ADD_NB of them; P at the model's parameters through the block
    # route (log|P| and L⁻¹b as the step, P⁻¹b and P⁻¹ as the posterior) and
    # through the library's dense calls on the same padded P, the yardstick
    amodel, apost, aparams = ag["model"], ag["post"], ag["params"]
    ablk = add_blocks[0]
    ablk_batch = torch.stack(add_blocks)
    calls["chol_inv_dense_b128"] = (lambda: dense_block.chol_inv_dense(ablk),
                                    lambda: dense_block.chol_inv_dense_plain(ablk))
    # K9-K12 on the additive step's first arguments (k = 3, m = ADD_M)
    add_k9_k12 = [f"{name}_m{ADD_M}" for name in ("chol_fwd", "chol_bwd", "tak_fwd", "tak_bwd")]
    for name in ("chol_fwd", "chol_bwd", "tak_fwd", "tak_bwd"):
        kernel_fn, plain_fn = adjoint_calls()[name]
        args = ag["args"][name][0]
        calls[f"{name}_m{ADD_M}"] = (lambda f=kernel_fn, a=args: f(*a),
                                     lambda f=plain_fn, a=args: f(*a))
    eye_b128 = torch.eye(ablk.shape[0], dtype=ablk.dtype, device=device)
    with torch.no_grad():
        kernels_a, lik_a = amodel._build()
        kuu_a = [make_kuu(kk, bb) for kk, bb in zip(kernels_a, amodel.bases)]
        p_add = additive._dense_p(amodel.bases, amodel.stats, kuu_a, lik_a.variance)
        core.reset_counters()
        additive._logdet_halfsolve_block(p_add, amodel.kuf_y)
    read_launches(device, "one additive block Cholesky", {"chol_inv_dense": ADD_NB})
    m_add = p_add.shape[0]
    n_pad = ADD_NB * 128 - m_add
    p_pad = torch.nn.functional.pad(p_add, (0, n_pad, 0, n_pad))
    p_pad.diagonal()[m_add:] = 1.0
    rhs_pad = torch.nn.functional.pad(amodel.kuf_y, (0, n_pad))[:, None]

    def add_block_halfsolve():
        with torch.no_grad():
            additive._logdet_halfsolve_block(p_add, amodel.kuf_y)

    def add_library_halfsolve():
        l_lib = torch.linalg.cholesky(p_pad)
        torch.linalg.solve_triangular(l_lib, rhs_pad, upper=False)

    def add_library_inverse():
        l_lib = torch.linalg.cholesky(p_pad)
        torch.cholesky_solve(rhs_pad, l_lib)
        torch.cholesky_inverse(l_lib)

    l_lib = torch.linalg.cholesky(p_pad)
    with torch.no_grad():
        ld_block, c_block = additive._logdet_halfsolve_block(p_add, amodel.kuf_y)
        w_block, pinv_block = additive._solve_and_inverse_block(p_add, amodel.kuf_y)
    c_lib = torch.linalg.solve_triangular(l_lib, rhs_pad, upper=False)[:m_add, 0]
    pinv_lib = torch.cholesky_inverse(l_lib)[:m_add, :m_add]
    emit("7_additive_p_routes", card=smi, m=m_add, padded=m_add + n_pad, block=128,
         logdet_rel=rel(float(ld_block), float(2.0 * torch.log(l_lib.diagonal()).sum())),
         halfsolve_rel=rel_err(c_block, c_lib), inverse_rel=rel_err(pinv_block, pinv_lib),
         p_kappa=float(torch.linalg.cond(p_add)))
    del l_lib, pinv_lib, w_block, pinv_block

    def elbo_value():
        with torch.no_grad():
            model.training_loss()

    def step_single():
        with twist_scope(False):
            value_and_grad(tmodel)

    f32_model, f32_post, f32_xt = f32["model"], f32["post"], f32["x_test"]
    l_p, kuf_y = sol["args"]["solve_lower"][0]

    def solve_band():
        with torch.no_grad():
            banded.cholesky_solve_band(l_p, kuf_y)

    times = {
        "stats_build": cuda_ms(lambda: compute_stats(model.basis, x_d, y_d)),
        "elbo_value": cuda_ms(elbo_value),
        "posterior": cuda_ms(model.posterior),
        "predict_1e5": cuda_ms(lambda: post.predict_f(xt, batch=PREDICT_BATCH)),
        "factor_takahashi_solve": cuda_ms(lambda: core.factor_takahashi_solve(kuu, p_band, b)),
        "value_and_grad_twisted": cuda_ms(lambda: value_and_grad(tmodel)),
        "value_and_grad_single_ended": cuda_ms(step_single),
        "backward_twisted": backward_ms(tmodel),
        "mid_step": cuda_ms(lambda: twist.mid_step(*main_bands, k5[0], k5[1], k5[4])),
        "twisted_sweeps_k5_mid_k6": cuda_ms(
            lambda: twist.factor_takahashi_solve_tan_twist(*main_bands)),
        "tan_sweeps_k3_k4": cuda_ms(lambda: tan.factor_takahashi_solve_tan(*main_bands)),
        "kron_stats_build": cuda_ms(lambda: compute_kron_stats(kmodel.bases, *kr["xy_train"])),
        "kron_value_and_grad": cuda_ms(lambda: per_dim_value_and_grad(kmodel)),
        "kron_backward": backward_ms(kmodel),
        "kron_block_cholesky": cuda_ms(lambda: block.cholesky_block_banded(p_blocks)),
        "kron_posterior": cuda_ms(lambda: kmodel.posterior(kparams)),
        "kron_predict_1e5": cuda_ms(lambda: kpost.predict_f(kr["x_test"], batch=PREDICT_BATCH)),
        "chol_inv_dense_batch100": cuda_ms(lambda: dense_block.chol_inv_dense(blk_batch)),
        "block_window_quad_shuffled": cuda_ms(lambda: block_window_quad(*bw["shuffled"])),
        "chol_inv_dense_library": cuda_ms(lambda: library_chol_inv(blk)),
        "chol_inv_dense_library_batch100": cuda_ms(lambda: library_chol_inv(blk_batch)),
        "f32_value_and_grad": cuda_ms(lambda: value_and_grad(f32_model)),
        "f32_backward": backward_ms(f32_model),
        "f32_posterior": cuda_ms(f32_model.posterior),
        "f32_predict_1e5": cuda_ms(lambda: f32_post.predict_f(f32_xt, batch=PREDICT_BATCH)),
        "cholesky_solve_band": cuda_ms(solve_band),
        "additive_stats_build": cuda_ms(lambda: compute_additive_stats(amodel.bases,
                                                                       *ag["xy_train"])),
        "additive_value_and_grad": cuda_ms(lambda: per_dim_value_and_grad(amodel)),
        "additive_backward": backward_ms(amodel),
        "additive_posterior": cuda_ms(lambda: amodel.posterior(aparams)),
        "additive_predict_1e5": cuda_ms(lambda: apost.predict_f(ag["x_test"],
                                                                batch=PREDICT_BATCH)),
        "additive_p_block_logdet_halfsolve": cuda_ms(add_block_halfsolve),
        "additive_p_block_solve_inverse": cuda_ms(
            lambda: additive._solve_and_inverse_block(p_add, amodel.kuf_y)),
        "additive_p_library_cholesky_solve_triangular": cuda_ms(add_library_halfsolve),
        "additive_p_library_cholesky_inverse": cuda_ms(add_library_inverse),
        "additive_p_library_cholesky_inverse_alone": cuda_ms(
            lambda: torch.cholesky_inverse(torch.linalg.cholesky(p_pad))),
        "chol_inv_dense_b128_batch8": cuda_ms(lambda: dense_block.chol_inv_dense(ablk_batch)),
        "chol_inv_dense_b128_library": cuda_ms(
            lambda: torch.linalg.solve_triangular(torch.linalg.cholesky(ablk), eye_b128,
                                                  upper=False)),
        "kron_nd_stats_build": cuda_ms(lambda: compute_kron_stats_nd(ndmodel.bases,
                                                                     *nd["xy_train"])),
        "kron_nd_value_and_grad": cuda_ms(lambda: per_dim_value_and_grad(ndmodel)),
        "kron_nd_backward": backward_ms(ndmodel),
        "kron_nd_block_cholesky": cuda_ms(lambda: block.cholesky_block_banded(p_blocks_nd)),
        "kron_nd_posterior": cuda_ms(lambda: ndmodel.posterior(ndparams)),
        "kron_nd_predict_1e5": cuda_ms(lambda: ndpost.predict_f(nd["x_test"],
                                                                batch=PREDICT_BATCH)),
        f"chol_inv_dense_b{ND_B}_batch{ND_M}": cuda_ms(
            lambda: dense_block.chol_inv_dense(nblk_batch)),
        f"chol_inv_dense_b{ND_B}_chain{ND_M}": cuda_ms(k16_chain),
        f"chol_inv_dense_b{ND_B}_library": cuda_ms(lambda: library_b400(nblk)),
        f"chol_inv_dense_b{ND_B}_library_chain{ND_M}": cuda_ms(library_chain),
    }
    for name, (kernel_fn, _) in calls.items():
        times[name] = cuda_ms(kernel_fn)
    for name, t in times.items():
        emit("7_time", what=name, card=smi, median_ms=t["median_ms"], ms=t["ms"])
    # the redesigned kernels' device time alone: the solves and the
    # adjoints take less time on the card than their call takes on the
    # host; the gap is the event time less the device time, the wrapper's
    # and launches'
    partitioned = SERVING_KERNELS + SOLVES + ADJOINTS + FORWARDS + TWISTED + TAN
    # the stages around K1 and K2 (the float64 posterior, the value-only
    # ELBO), the mid step and the twisted route's sweeps and step around K5
    # and K6, and the single-ended route's around K3 and K4
    stages = {
        "factor_takahashi_solve": lambda: core.factor_takahashi_solve(kuu, p_band, b),
        "posterior": model.posterior,
        "elbo_value": elbo_value,
        "mid_step": lambda: twist.mid_step(*main_bands, k5[0], k5[1], k5[4]),
        "twisted_sweeps_k5_mid_k6": lambda: twist.factor_takahashi_solve_tan_twist(*main_bands),
        "value_and_grad_twisted": lambda: value_and_grad(tmodel),
        "tan_sweeps_k3_k4": lambda: tan.factor_takahashi_solve_tan(*main_bands),
        "value_and_grad_single_ended": step_single,
    }
    alone = [(n, calls[n][0]) for n in partitioned] + list(stages.items()) + [
        ("chol_inv_dense", calls["chol_inv_dense"][0]),
        ("chol_inv_dense_batch100", lambda: dense_block.chol_inv_dense(blk_batch)),
        ("chol_inv_dense_b128", calls["chol_inv_dense_b128"][0]),
        *((name, calls[name][0]) for name in add_k9_k12),
        ("chol_inv_dense_b128_batch8", lambda: dense_block.chol_inv_dense(ablk_batch)),
        ("additive_p_block_logdet_halfsolve", add_block_halfsolve),
        ("additive_p_library_cholesky_solve_triangular", add_library_halfsolve),
        (f"chol_inv_dense_b{ND_B}", calls[f"chol_inv_dense_b{ND_B}"][0]),
        (f"chol_inv_dense_b{ND_B}_batch{ND_M}", lambda: dense_block.chol_inv_dense(nblk_batch)),
        (f"chol_inv_dense_b{ND_B}_library", lambda: library_b400(nblk)),
        ("kron_nd_block_cholesky", lambda: block.cholesky_block_banded(p_blocks_nd)),
        ("block_window_quad", calls["block_window_quad"][0]),
        ("block_window_quad_shuffled", lambda: block_window_quad(*bw["shuffled"]))]
    for name, fn in alone:
        dev_ms = kernel_device_ms(fn)
        if ((name in partitioned or name in stages)
                and dev_ms["device_ms"] != "not measured"):
            event_ms = times[name]["median_ms"]
            dev_ms |= {"event_ms": event_ms, "gap_ms": event_ms - dev_ms["device_ms"]}
        emit("7_device_time", what=name, card=smi, **dev_ms)
    for name, path in (("adam_step", ad), ("svgp_step", sv)):
        emit("7_time", what=name, card=smi, median_ms=path["ms_per_step"],
             ms=path["ms_per_step_all"], clock="host, per step of a 20-step fit")
    # the plain versions on CUDA tensors: each once after a warm-up, and
    # none of them may launch a kernel
    plain_ms = {}
    core.reset_counters()
    for name, (_, plain_fn) in calls.items():
        plain_ms[name] = once_ms(plain_fn)
        emit("7_time", what=f"{name}_plain", card=smi, once_ms=plain_ms[name])
    torch.cuda.synchronize(device)
    if any(core.LAUNCHES.values()) or core.PLAIN_CALLS.get("cuda", 0) == 0:
        raise AssertionError(f"the plain versions on the card launched {dict(core.LAUNCHES)}, "
                             f"plain calls {dict(core.PLAIN_CALLS)}")
    emit("7_plain_versions_launch_nothing", launches=dict(core.LAUNCHES),
         plain_calls=dict(core.PLAIN_CALLS))
    profiled = {
        "value_and_grad_twisted": lambda: value_and_grad(tmodel),
        "value_and_grad_single_ended": step_single,
        "value_and_grad_snelson_m100": lambda: value_and_grad(tr["snelson_model"]),
        "kron_value_and_grad": lambda: per_dim_value_and_grad(kmodel),
        "additive_value_and_grad": lambda: per_dim_value_and_grad(amodel),
        "additive_posterior": lambda: amodel.posterior(aparams),
        "additive_predict_1e5": lambda: apost.predict_f(ag["x_test"], batch=PREDICT_BATCH),
        "kron_nd_value_and_grad": lambda: per_dim_value_and_grad(ndmodel),
        "kron_nd_posterior": lambda: ndmodel.posterior(ndparams),
        "kron_nd_predict_1e5": lambda: ndpost.predict_f(nd["x_test"], batch=PREDICT_BATCH),
        "f32_value_and_grad": lambda: value_and_grad(f32_model),
    }
    for name, fn in profiled.items():
        emit("7_profile", what=name, card=smi, **device_profile(fn))
    for name, run_fit in (("fit_north_star", fit), ("fit_snelson", sn_fit),
                          ("fit_exact_snelson", ex_fit), ("fit_kron", kfit),
                          ("fit_additive", afit), ("fit_kron_nd", ndfit)):
        emit("7_time", what=name, card=smi, median_ms_per_iter=run_fit["ms_per_iter"],
             ms_per_iter=run_fit["ms_per_iter_all"], evals=run_fit["info"]["ls_evals"],
             evals_per_iter=run_fit["info"].get("evals_per_iter"))

    # one PyTorch call computes the same function, on the dense matrix, for
    # K16 (the pair above), the Cholesky sweeps K9, K15 and K17
    # (torch.linalg.cholesky of A: dense O(m³) work), the Takahashi sweeps
    # K11 and K19 (torch.cholesky_inverse of the dense L, whose band is
    # S: O(m³)) and the solves K13, K14, K21 and K22
    # (torch.linalg.solve_triangular with the dense L: O(m²) work); each is
    # timed on the inputs the kernel got, and the other kernels (the
    # adjoints, the fused sweeps) have none
    library_ms = {"chol_inv_dense": times["chol_inv_dense_library"]["median_ms"]}
    library = {"chol_fwd": lambda a: torch.stack([dense_spd(a)]),
               "chol_fwd_pair": lambda a, b: torch.stack([dense_spd(a), dense_spd(b)]),
               "chol_fwd_f32": lambda a: torch.stack([dense_spd(a)])}
    for name, make in library.items():
        dense = make(*io[name][0])
        t = cuda_ms(lambda: torch.linalg.cholesky_ex(dense))
        info = torch.linalg.cholesky_ex(dense).info
        library_ms[name] = t["median_ms"]
        emit("7_library", what=name, call="torch.linalg.cholesky_ex", m=m, card=smi,
             dtype=str(dense.dtype), batch=dense.shape[0], median_ms=t["median_ms"], ms=t["ms"],
             factored=bool((info == 0).all()))
        del dense
    for name in ("tak_fwd", "tak_fwd_f32"):
        dense = lower_band_to_dense(io[name][0][0])
        t = cuda_ms(lambda: torch.cholesky_inverse(dense))
        library_ms[name] = t["median_ms"]
        emit("7_library", what=name, call="torch.cholesky_inverse", m=m, card=smi,
             dtype=str(dense.dtype), median_ms=t["median_ms"], ms=t["ms"])
        del dense
    for name in SOLVES:
        l_band, rhs = io[name][0]
        dense = lower_band_to_dense(l_band)
        lhs, upper = (dense, False) if name.startswith("solve_lower") else (dense.mT, True)
        rhs2 = rhs.reshape(m, -1)
        t = cuda_ms(lambda: torch.linalg.solve_triangular(lhs, rhs2, upper=upper))
        library_ms[name] = t["median_ms"]
        emit("7_library", what=name, call="torch.linalg.solve_triangular", m=m, card=smi,
             dtype=str(dense.dtype), rhs=rhs2.shape[1], median_ms=t["median_ms"], ms=t["ms"])
        del dense, lhs
    torch.cuda.empty_cache()
    # K16 at the additive path's B = 128: the lower triangle read and the
    # two B×B outputs written, against its operations at the FP64
    # tensor-core rate
    b128 = ablk.shape[0]
    emit("7_bound", what="chol_inv_dense", B=b128, **dense_block_bound(b128))
    # and at the D = 3 path's B = 400
    emit("7_bound", what="chol_inv_dense", B=ND_B, **dense_block_bound(ND_B))
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        if name == "chol_inv_dense":
            shape = {"B": blk.shape[0]}
            bnd = dense_block_bound(blk.shape[0])
        elif name == "block_window_quad":
            shape = {"n": bw["n"], "K": bw["K"], "T": bw["T"]}
            bnd = block_window_bound(bw["ordered"])
        else:
            shape = {"k": k, "m": m}
            ins, outs = io[name]
            r = ins[1].shape[1] if "solve" in name and ins[1].ndim == 2 else 1
            peak = PEAK_FP32_PER_S if name.endswith("_f32") else PEAK_FP64_PER_S
            bnd = bound(sweep_ops(name, k, m, r), tensor_bytes((*ins, *outs)), peak)
        emit("7_bound", what=name, **shape, **bnd)
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": path_launches[name],
            "max_abs_err": main_parity[f"{name}_abs"],
            "ms": times[name]["median_ms"],
            "plain_ms": plain_ms[name],
            "bound_ms": bnd["bound_ms"],
            "bound_by": bnd["bound_by"],
            "library_ms": library_ms.get(name),
            "launches_additive_step": add_launches[name],
            "launches_protocol": lr_launches.get(name, 0),
            "launches_enatl_leg": leg_launches[name],
            "launches_kron_nd_step": nd_launches[name],
            "launches_f32_trainers": f32t_launches[name],
            "launches_dp_step": dp_launches[name],
        })
    emit("8_done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
