// The chunk passes of the forward banded sweeps, shared by the
// single-matrix sweeps chol_fwd<K, T> and tak_fwd<K, T> (banded_adjoint.cu:
// K9, K11, K15, K17, K19) and the serving pair chol_pair_solve<K> and
// tak_pair_solve<K> (banded_core.cu: K1, K2), which run the same passes on
// Kuu and on P, the P role with a solve carried beside (kSolve): K1 the
// lower solve L_P c0 = b, K2 the upper solve L_P^T u = c0.  K3
// (banded_tan.cu) runs K1's P role.
//
// Each pass is a device function over one chunk of one matrix, given that
// matrix's pointers and the slots of its chunk in the workspace; the
// kernels of the two files map blockIdx onto them.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

#include "chunk_scan.cuh"
#include "schur_walk.cuh"

namespace {

// ---------------------------------------------------------------------------
// K9 / K15 / K17: chol_fwd<K, T>  (and K1's two roles, banded_core.cu)
//
// Columns i = 0..m-1, with the window w[p-1][r] = L[i-p+r, i-p]:
//   s_j = sum_p L[i, i-p] L[i+j, i-p],  L[i, i] = sqrt(a_0 - s_0),
//   L[i+j, i] = (a_j - s_j) / L[i, i],  rows i + j >= m zeroed
// (the right-padding mask of the TPU kernel's _col_mask).
//
// The step takes square roots and divides of what it carries, so the
// scan of the linear sweeps does not apply.  What the columns before a
// chunk (columns c0..c1-1) send into it is only the K x K Schur-complement
// update of its first K rows, W = L[c0:c0+K, :c0] L[c0:c0+K, :c0]^T: the
// chunk's columns of L are the plain recursion on its diagonal block A_c
// with W subtracted from the first K rows, started from a zero window.
// Over a chunk, W maps to the next chunk's by a matrix Riccati map fixed
// by three K x K matrices of A_c alone:
//   W' = R + Q^T (I - W P)^-1 W Q,
// P = (A_c^-1)[:K, :K] = V^T V with V = L_c^-1 E (L_c = chol(A_c), E the
// first K unit columns), Q = V_last^T X^T and R = X X^T, V_last the last K
// rows of V and X the entries L_c's last K columns put in the next
// chunk's first K rows (the plain recursion writes them; X and the
// coupling block of A are upper triangular).  With U = chol(P),
// G = [U Q]^T W [U Q] and F = chol(I - G11):
//   W' = R + G22 + Y^T Y,  Y = F^-1 G12.
// I - G11 = I - U^T W U has the eigenvalues of I - W P and is positive
// definite exactly when the chunk's true Schur complement A_c - E W E^T
// is: a pivot d <= 0 in a chunk makes F, and every later W, NaN, so the
// factor is NaN from the failing column on, as the one-chain recursion
// gives it.  No pivoting, and no factor of W (only semidefinite where the
// band's outer diagonal is zero).  Three launches when m spans more than
// one chunk (schur_chunk_cols):
//   1. triples (chol_fwd_chunk<.., true, ..>), grid (chunks but the
//      last, matrices): the chunk's plain recursion from W = 0, V's rows
//      substituted along it; writes (U, Q, R), no L.
//   2. walk (schur_walk), one thread per matrix: every chunk's W.
//   3. factor (chol_fwd_chunk<.., false, ..>), grid (chunks, matrices):
//      W subtracted from the staged first K columns of A, the plain
//      recursion from a zero window, L written.
// Passes 1 and 3 run one column step (chol_fwd_step) in the order of
// operations of the one-chain recursion, so chunk 0 (W = 0) is that
// recursion bit for bit.  Each CTA stages A's columns as the linear sweeps
// stage theirs (below); pass 2 stages every triple of a matrix in shared
// memory, K^2 + K(K+1) values a chunk, which caps the chunk count.  The
// triples' and the walk's arithmetic (schur_v_row, schur_triple,
// schur_solve_tail, schur_step, schur_walk) is in schur_walk.cuh, shared
// with K5 (banded_tan.cu).
// ---------------------------------------------------------------------------
template <int K, typename T>
__device__ __forceinline__ T chol_fwd_step(T (&w)[K][K + 1], const T (&ac)[K + 1], int i, int m,
                                           T (&col)[K + 1]) {
  T s[K + 1];
#pragma unroll
  for (int j = 0; j <= K; ++j) s[j] = T(0);
#pragma unroll
  for (int q = 1; q <= K; ++q) {
    const T g = w[q - 1][q];  // L[i, i-q]
#pragma unroll
    for (int j = 0; j + q <= K; ++j) s[j] = fma_t(g, w[q - 1][q + j], s[j]);
  }

  const T l0 = sqrt_t(ac[0] - s[0]);
  const T rv = T(1) / l0;
  col[0] = l0;
#pragma unroll
  for (int j = 1; j <= K; ++j) {
    // multiply by the mask (not select) so a NaN pivot stays NaN
    col[j] = (ac[j] - s[j]) * rv * ((i + j < m) ? T(1) : T(0));
  }

#pragma unroll
  for (int q = K - 1; q > 0; --q) {
#pragma unroll
    for (int r = 0; r <= K; ++r) w[q][r] = w[q - 1][r];
  }
#pragma unroll
  for (int r = 0; r <= K; ++r) w[0][r] = col[r];
  return rv;
}

// Passes 1 (kMaps) and 3 over chunk j0 (lc columns from s = j0 lc) of one
// (K+1, m) band a; tiles stage A's columns (and, kSolve, b's entries).
// Pass 1 writes the chunk's triple at tri: U's lower triangle by rows (D
// values), Q (K x K, row-major), R's upper triangle by rows (D) and, with
// kSolve, p0 = V^T y0 and r0 = X y0_last (K each) of the chunk's own lower
// solve y0 of b (see schur_step).  Pass 3 subtracts the incoming W (packed
// as R at win; win is null for chunk 0) from the staged first K columns of
// A and, kSolve, the solve's coupling beta (the K values after W) from b's
// first K entries, then writes L to l, the reciprocal pivots to iv (unless
// it is null) and, kSolve, the solve to y.  The solve is the lower-solve
// column of K1's one-chain recursion: sb = sum_q L[i, i-q] y[i-q], then
// y[i] = (b_i - sb) / L[i, i] by the step's reciprocal.
template <int K, typename T, bool kMaps, bool kSolve>
__device__ __forceinline__ void chol_fwd_chunk(int m, int lc, int j0, const T* __restrict__ a,
                                               const T* __restrict__ b, T* __restrict__ l,
                                               T* __restrict__ iv, T* __restrict__ y,
                                               const T* __restrict__ win, T* __restrict__ tri) {
  constexpr int D = K * (K + 1) / 2;
  constexpr int XR = kSolve ? 1 : 0;    // the row of b after A's rows
  __shared__ T at[2][K + 1 + XR][kTile];  // A (and b) columns of the positions
  const int lane = threadIdx.x;
  const size_t ms = static_cast<size_t>(m);
  const int s = j0 * lc;
  const int e = (s + lc < m) ? s + lc : m;

  T w[K][K + 1];
  T vw[K][K];  // pass 1: vw[p-1][f] = V[i-p-s, f], the last K rows of V
  T pa[K][K];  // pass 1: P = V^T V, its upper triangle
  T x[K];      // kSolve: x[p-1] = y[i-p]
  T p0[K];     // pass 1, kSolve: V^T y0
#pragma unroll
  for (int q = 0; q < K; ++q) {
    x[q] = T(0);
    p0[q] = T(0);
#pragma unroll
    for (int r = 0; r <= K; ++r) w[q][r] = T(0);
#pragma unroll
    for (int f = 0; f < K; ++f) {
      vw[q][f] = T(0);
      pa[q][f] = T(0);
    }
  }

  const int ntiles = (e - s + kTile - 1) / kTile;
  stage_cols<K + 1, T, false>(at[0], a, m, s, min(kTile, e - s), 0);
  if constexpr (kSolve) stage_cols<1, T, false>(at[0] + K + 1, b, m, s, min(kTile, e - s), 0);
  cp_async_commit();
  for (int tile = 0; tile < ntiles; ++tile) {
    const int buf = tile & 1;
    const int u0 = s + tile * kTile;
    const int n = min(kTile, e - u0);
    if (tile + 1 < ntiles) {
      const int u1 = u0 + kTile;
      stage_cols<K + 1, T, false>(at[buf ^ 1], a, m, u1, min(kTile, e - u1), 0);
      if constexpr (kSolve) {
        stage_cols<1, T, false>(at[buf ^ 1] + K + 1, b, m, u1, min(kTile, e - u1), 0);
      }
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (!kMaps && tile == 0 && win != nullptr) {
      // W off the chunk's first K rows: lane d takes slot d = (r, r + c),
      // band entry c of column s + r; beta off b's first K entries
      if (lane < D) {
        int r = 0;
        int c = lane;
        while (c >= K - r) {
          c -= K - r;
          ++r;
        }
        if (r < n) at[0][c][r] -= win[lane];
      }
      if constexpr (kSolve) {
        if (lane < K && lane < n) at[0][K + 1][lane] -= win[D + lane];
      }
      __syncthreads();
    }
    for (int t = 0; t < n; ++t) {
      const int i = u0 + t;
      T ac[K + 1];
#pragma unroll
      for (int r = 0; r <= K; ++r) ac[r] = at[buf][r][t];
      T g[K];  // L[i, i-p], before the step shifts the window
#pragma unroll
      for (int p = 1; p <= K; ++p) g[p - 1] = w[p - 1][p];
      T sb = T(0);
      if constexpr (kSolve) {
#pragma unroll
        for (int q = 1; q <= K; ++q) sb = fma_t(g[q - 1], x[q - 1], sb);
      }
      T col[K + 1];
      const T rv = chol_fwd_step<K, T>(w, ac, i, m, col);
      T xi = T(0);
      if constexpr (kSolve) {
        xi = (at[buf][K + 1][t] - sb) * rv;
#pragma unroll
        for (int q = K - 1; q > 0; --q) x[q] = x[q - 1];
        x[0] = xi;
      }
      if (kMaps) {
        T vn[K];
        schur_v_row<K, T>(g, rv, i - s, vw, pa, vn);
        if constexpr (kSolve) {
#pragma unroll
          for (int f = 0; f < K; ++f) p0[f] = fma_t(vn[f], xi, p0[f]);
        }
      } else if (lane == 0) {
#pragma unroll
        for (int r = 0; r <= K; ++r) l[r * ms + i] = col[r];
        if (iv != nullptr) iv[i] = rv;
        if constexpr (kSolve) y[i] = xi;
      }
    }
    __syncthreads();
  }

  if (kMaps && lane == 0) {
    schur_triple<K, T>(w, vw, pa, tri);
    if constexpr (kSolve) schur_solve_tail<K, T>(w, x, p0, tri + K * K + 2 * D);
  }
}

// ---------------------------------------------------------------------------
// K11 / K19: tak_fwd<K, T>  (and K2's two roles, banded_core.cu)
//
// Columns j = m-1..0, with d = 1 / L[j, j] and the window cs[p-1][r] =
// S[j+p+r, j+p] of the columns already done:
//   s_q = -d sum_p S[j+max(p,q), j+min(p,q)] L[j+p, j],   q = 1..K,
//   S[j, j] = d^2 - d sum_q L[j+q, j] s_q,  rows j + q >= m zeroed.
// K2's reverse sweep without the solve, dividing for d itself (K2 reads
// d from K1's reciprocal pivots).  The step reads the D slots cs[c][r],
// r < K - c, of the window; given L the new column is affine in them, d^2
// the particular part.  It runs in the three passes of the linear sweeps
// (banded_adjoint.cu, "The linear sweeps").
// ---------------------------------------------------------------------------
template <int K, typename T, bool kMaps>
__device__ __forceinline__ void tak_fwd_step(T (&cs)[K][K + 1], const T (&lc)[K + 1], T d,
                                             T part, int j, int m, T (&col)[K + 1]) {
  T sq[K + 1];
  sq[0] = T(0);
#pragma unroll
  for (int q = 1; q <= K; ++q) {
    T acc = T(0);
#pragma unroll
    for (int p = 1; p <= K; ++p) {
      const int lo = (p < q) ? p : q;
      const int df = (p < q) ? (q - p) : (p - q);
      acc = fma_t(cs[lo - 1][df], lc[p], acc);
    }
    sq[q] = -d * acc;
  }
  T ws = T(0);
#pragma unroll
  for (int q = 1; q <= K; ++q) ws = fma_t(lc[q], sq[q], ws);

  // pass 1's homogeneous lanes (part = 0) leave the d^2 term out
  col[0] = kMaps ? part * (d * d) - d * ws : d * d - d * ws;
#pragma unroll
  for (int q = 1; q <= K; ++q) col[q] = sq[q] * ((j + q < m) ? T(1) : T(0));

#pragma unroll
  for (int q = K - 1; q > 0; --q) {
#pragma unroll
    for (int rr = 0; rr <= K; ++rr) cs[q][rr] = cs[q - 1][rr];
  }
#pragma unroll
  for (int rr = 0; rr <= K; ++rr) cs[0][rr] = col[rr];
}

// ---------------------------------------------------------------------------
// The chunk-length rule of the linear sweeps on the scan (K2, K4, K6, K7,
// K8, K10-K12, K18-K20, K23)
//
// Over a chunk of lc columns the scan applies the chunk's map H to an
// incoming carry that holds the rounding of every chunk before it.  H is
// the Takahashi-type homogeneous response of the factor over those
// columns: it first grows with κ(A) and then decays with the chunk's
// length over the factor's correlation length.  At the north star (ℓ/δ =
// 10) its entries are below 1e-5 after 64 columns; at the
// large-regression protocol's Kuu (B3 × Matérn-5/2, m = 1000, ℓ = 0.05,
// κ = 7.8e9) they are 5.9e4 after 64 columns, 0.52 after 256 and 2.7e-5
// after 384, and 64-column chunks put a sweep 1e-6..1e-5 (relative) from
// its one-chunk run, whose own spread under a rounding of L is 1e-10
// (tools/chunk_rule_probe.py).  So each sweep takes its chunk length from
// its factors, on the device: the shortest multiple of the tile, no
// shorter than the partition's length lc0, after which the homogeneous
// response of an interior chunk (walk positions from lc0 on, unit carries,
// tak_fwd_step without the d^2 term) has no entry above tau, or the whole
// walk (one chunk) when none does.  The adjoints' maps are the same size
// as the Takahashi sweep's at every length (within 3x); the tangent
// sweeps' maps (K4, K6) carry the derivative of S as well, a factor of up
// to 1e3 more, hence their smaller tau.  chunk_rule_kernel runs the rule
// over the matrices of a call, one block each, and leaves the longest
// length in *rule (zeroed first); the passes and the scan read it there
// (rule_cols), launched on the grid of lc0, so no host reads it.
// ---------------------------------------------------------------------------
constexpr double kRuleTau = 2e-3;     // the maps' largest entry: linear sweeps, K2
constexpr double kRuleTauTan = 5e-5;  // K4, K6

// Block b of the rule over factors (K+1, ld) at l0 + b stride, or l1 for
// block 1 when l1 is given: walks positions lc0..n-1 (columns n-1-u) from
// the D unit carries.
template <int K, typename T>
__global__ void __launch_bounds__(32)
chunk_rule_kernel(int n, int ld, int lc0, T tau, const T* __restrict__ l0,
                  const T* __restrict__ l1, size_t stride, int* __restrict__ rule) {
  constexpr int D = K * (K + 1) / 2;
  __shared__ T lt[K + 1][kTile];
  const int lane = threadIdx.x;
  const T* __restrict__ l =
      (blockIdx.x == 1 && l1 != nullptr) ? l1 : l0 + blockIdx.x * stride;
  T cs[K][K + 1];
  {
    int d = 0;
#pragma unroll
    for (int c = 0; c < K; ++c) {
#pragma unroll
      for (int r = 0; r <= K; ++r) cs[c][r] = T(0);
#pragma unroll
      for (int r = 0; r < K - c; ++r, ++d) cs[c][r] = (lane == d) ? T(1) : T(0);
    }
  }
  int len = n;  // one chunk, unless the response decays
  for (int u0 = lc0; u0 < n; u0 += kTile) {
    const int cnt = min(kTile, n - u0);
    __syncthreads();
    for (int idx = lane; idx < (K + 1) * kTile; idx += 32) {
      const int r = idx / kTile;
      const int t = idx % kTile;
      if (t < cnt) lt[r][t] = l[r * static_cast<size_t>(ld) + (n - 1 - (u0 + t))];
    }
    __syncthreads();
    for (int t = 0; t < cnt; ++t) {
      T lcur[K + 1];
#pragma unroll
      for (int r = 0; r <= K; ++r) lcur[r] = lt[r][t];
      T col[K + 1];
      tak_fwd_step<K, T, true>(cs, lcur, T(1) / lcur[0], T(0), n - 1 - (u0 + t), n, col);
    }
    T hmax = T(0);
    {
      int d = 0;
#pragma unroll
      for (int c = 0; c < K; ++c) {
#pragma unroll
        for (int r = 0; r < K - c; ++r, ++d) {
          const T a = cs[c][r] < T(0) ? -cs[c][r] : cs[c][r];
          // NaN stays: no length is chosen from a factor that failed
          if (lane < D && !(a <= hmax) && hmax == hmax) hmax = a;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const T o = __shfl_xor_sync(0xffffffffu, hmax, off);
      if (!(o <= hmax) && hmax == hmax) hmax = o;
    }
    if (hmax <= tau) {
      // the tiles walked, but never shorter than the partition's chunks
      int done = (u0 + cnt - lc0 + kTile - 1) / kTile * kTile;
      done = done < lc0 ? lc0 : done;
      len = done < n ? done : n;
      break;
    }
  }
  if (lane == 0) atomicMax(rule, len);
}

// Runs the rule over nmat factors (K+1, ld) at l0 + i stride (l1 as for
// chunk_rule_kernel) whose walks have n positions and the partition's
// chunks lc0 columns: *rule is then the chunk length, lc0 or longer.
template <int K, typename T>
cudaError_t launch_chunk_rule(int n, int ld, int lc0, double tau, const T* l0, const T* l1,
                              size_t stride, int nmat, int* rule, cudaStream_t st) {
  cudaError_t e = cudaMemsetAsync(rule, 0, sizeof(int), st);
  if (e != cudaSuccess) return e;
  chunk_rule_kernel<K, T><<<nmat, 32, 0, st>>>(n, ld, lc0, static_cast<T>(tau), l0, l1, stride,
                                               rule);
  return cudaGetLastError();
}

// The chunk length a rule left at rule, copied to the host: for the entry
// points that report it (a synchronisation; no sweep calls it).
inline int read_rule(const int* rule, cudaStream_t st) {
  int lc = 0;
  if (cudaMemcpyAsync(&lc, rule, sizeof(int), cudaMemcpyDeviceToHost, st) != cudaSuccess) {
    return -1;
  }
  return cudaStreamSynchronize(st) == cudaSuccess ? lc : -1;
}

// Passes 1 (kMaps) and 3 over chunk j0 (walk positions s..e-1 from
// s = j0 lc, columns j = m-1-u) of one factor l, carrying DD values: the D
// read entries of the S window and, kSolve, the upper solve's K-window
// x[p-1] = u[j+p] after them (the rest, when DD is larger, stay 0).  d is
// iv[j] (kIv: K1's reciprocal pivots, staged) or 1 / L[j, j].  The solve is
// K2's upper-solve column, sb = sum_q L[j+q, j] u[j+q], u[j] = (c0_j - sb) d,
// its c0_j term (b) the particular part.  Pass 1: lane q < DD runs from the
// carry e_q without the particular terms, lane DD from 0 with them; the
// final carries are H's columns and y, written at hm (H[p][q] at
// hm[p DD + q]) and ym.  Pass 3: lane 0 runs from win (null for chunk 0:
// the zero carry) and writes S to s_out and, kSolve, u; with s_out null and
// cout given (the linear sweeps' refinement, banded_adjoint.cu) it writes
// only its final D carried values, at cout.
template <int K, typename T, bool kMaps, bool kIv, bool kSolve, int DD>
__device__ __forceinline__ void tak_fwd_chunk(int m, int lc, int j0, const T* __restrict__ l,
                                              const T* __restrict__ iv, const T* __restrict__ b,
                                              T* __restrict__ s_out, T* __restrict__ u,
                                              const T* __restrict__ win, T* __restrict__ hm,
                                              T* __restrict__ ym, T* __restrict__ cout = nullptr) {
  constexpr int D = K * (K + 1) / 2;
  static_assert(DD >= D + (kSolve ? K : 0) && DD < 32, "the carry fits the warp's lanes");
  constexpr int RV = K + 1;              // the row of iv after L's rows
  constexpr int RB = RV + (kIv ? 1 : 0);  // the row of b
  __shared__ T lt[2][RB + (kSolve ? 1 : 0)][kTile];  // L (iv, b) columns of the positions
  const int lane = threadIdx.x;
  const size_t ms = static_cast<size_t>(m);
  const int s = j0 * lc;
  const int e = (s + lc < m) ? s + lc : m;

  T cs[K][K + 1];
  T x[K];
  {
    int d = 0;
#pragma unroll
    for (int c = 0; c < K; ++c) {
#pragma unroll
      for (int r = 0; r <= K; ++r) cs[c][r] = T(0);
#pragma unroll
      for (int r = 0; r < K - c; ++r, ++d) {
        if (kMaps) {
          cs[c][r] = (lane == d) ? T(1) : T(0);
        } else if (win != nullptr) {
          cs[c][r] = win[d];
        }
      }
    }
#pragma unroll
    for (int q = 0; q < K; ++q) {
      x[q] = T(0);
      if constexpr (kSolve) {
        if (kMaps) {
          x[q] = (lane == D + q) ? T(1) : T(0);
        } else if (win != nullptr) {
          x[q] = win[D + q];
        }
      }
    }
  }
  const T part = (!kMaps || lane == DD) ? T(1) : T(0);

  const int ntiles = (e - s + kTile - 1) / kTile;
  for (int tile = -1; tile < ntiles; ++tile) {
    // stage tile + 1 while tile runs
    if (tile + 1 < ntiles) {
      const int nb1 = (tile + 1) & 1;
      const int u1 = s + (tile + 1) * kTile;
      const int n1 = min(kTile, e - u1);
      stage_cols<K + 1, T, true>(lt[nb1], l, m, u1, n1, 0);
      if constexpr (kIv) stage_cols<1, T, true>(lt[nb1] + RV, iv, m, u1, n1, 0);
      if constexpr (kSolve) stage_cols<1, T, true>(lt[nb1] + RB, b, m, u1, n1, 0);
      cp_async_commit();
    }
    if (tile < 0) continue;
    const int buf = tile & 1;
    const int u0 = s + tile * kTile;
    const int n = min(kTile, e - u0);
    if (tile + 1 < ntiles) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const int j = m - 1 - (u0 + t);
      T lcur[K + 1];
#pragma unroll
      for (int r = 0; r <= K; ++r) lcur[r] = lt[buf][r][t];
      T d;
      if constexpr (kIv) {
        d = lt[buf][RV][t];
      } else {
        d = T(1) / lcur[0];
      }
      T uj = T(0);
      if constexpr (kSolve) {
        T sb = T(0);
#pragma unroll
        for (int q = 1; q <= K; ++q) sb = fma_t(lcur[q], x[q - 1], sb);
        const T bc = lt[buf][RB][t];
        uj = kMaps ? (part * bc - sb) * d : (bc - sb) * d;
#pragma unroll
        for (int q = K - 1; q > 0; --q) x[q] = x[q - 1];
        x[0] = uj;
      }
      T col[K + 1];
      tak_fwd_step<K, T, kMaps>(cs, lcur, d, part, j, m, col);
      if (!kMaps && lane == 0 && s_out != nullptr) {
#pragma unroll
        for (int r = 0; r <= K; ++r) s_out[r * ms + j] = col[r];
        if constexpr (kSolve) u[j] = uj;
      }
    }
    __syncthreads();
  }

  if (!kMaps && cout != nullptr && lane == 0) {
    int d = 0;
#pragma unroll
    for (int c = 0; c < K; ++c) {
#pragma unroll
      for (int r = 0; r < K - c; ++r, ++d) cout[d] = cs[c][r];
    }
  }
  if (kMaps) {
    int d = 0;
#pragma unroll
    for (int c = 0; c < K; ++c) {
#pragma unroll
      for (int r = 0; r < K - c; ++r, ++d) {
        if (lane < DD) {
          hm[d * DD + lane] = cs[c][r];
        } else if (lane == DD) {
          ym[d] = cs[c][r];
        }
      }
    }
#pragma unroll
    for (int p = D; p < DD; ++p) {
      const T v = (kSolve && p < D + K) ? x[p - D < K ? p - D : 0] : T(0);
      if (lane < DD) {
        hm[p * DD + lane] = v;
      } else if (lane == DD) {
        ym[p] = v;
      }
    }
  }
}

}  // namespace
