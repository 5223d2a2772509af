// The single-matrix banded Cholesky and Takahashi sweeps and their
// reverse-mode adjoints, in float64 and in float32 for Hopper (sm_90a).
//
// Storage as in banded_core.cu: a (K+1, m) lower band, row-major,
//     band[j * m + i] = M[i + j, i],   0 <= j <= K,
// with the right-padding slots (i + j >= m) zero.  A batch of nb bands is
// nb such blocks back to back.
//
// Four sweeps, compile-time K = 1..6, the K-column window in registers,
// templated on the scalar type T:
//
//   chol_fwd<K, T>  L = chol(A)               double: K9 (K15 is its batch
//                                             of two); float: K17
//   chol_bwd<K, T>  A-bar from (L, L-bar)     double: K10, and K8 (batch of
//                                             one); float: K18
//   tak_fwd<K, T>   S = band of A^-1 from L   double: K11; float: K19
//   tak_bwd<K, T>   L-bar from (L, S, S-bar)  double: K12 (divides by
//                                             L[j, j]), K7 (reads 1/L[j, j]
//                                             from iv) and K23 (K7, batch
//                                             of two); float: K20
//
// They replace, in asvgp_tpu/banded/: pallas_ds.py _chol_fwd_ds_kernel,
// _chol_bwd_ds_kernel, _takahashi_fwd_ds_kernel, _takahashi_bwd_ds_kernel;
// pallas_ds_pair.py _chol_fwd_pair_kernel (K15) and _chol_bwd_pair_kernel
// (K8, whose second matrix the collapsed core leaves dead);
// pallas_ds_core.py _tak_bwd_vec_kernel (K7) and _tak_bwd_pair_kernel
// (K23); and the float32 kernels of pallas_kernels.py: _chol_fwd_kernel,
// _chol_bwd_kernel, _takahashi_fwd_kernel, _takahashi_bwd_kernel (the
// float32 models on an accelerator).
//
// What bounds them: a serial chain of m column steps, each waiting on the
// latency of the step before (fma chains of depth K, a sqrt or a
// reciprocal).  Each sweep reads and writes a few (K+1) x m bands, under
// 1 MB at m = 10^4, so neither bandwidth nor the arithmetic rate is the
// limit, the chain's length is.
//
// What the design does about it: the TPU kernels carry float32 hi/lo pairs
// (or plain float32) in 128-column tiles, read the neighbouring tile for
// the window (_prev_tiles, _next_tiles), build columns from one-hot row
// masks and rolls.  None of that carries over.  Each sweep is the
// recursion of asvgp_tpu_torch/banded/ops.py (cholesky_band_plain,
// takahashi_inverse_band_plain, cholesky_band_bwd_plain,
// takahashi_bwd_plain) in the native type, fully unrolled for K, with the
// window of neighbouring columns and the carried columns in registers, and
// every chain is cut into chunks of 64-192 columns run in parallel, three
// launches each (one pass when the columns form one chunk).  The Takahashi sweep and the adjoints carry what is
// affine (given L): maps, a scan over the maps (chunk_scan.cuh, shared with
// banded_solve.cu) and the outputs from the true incoming carries (see
// "The linear sweeps" below).  The Cholesky sweep is joined across chunks
// by a K x K Schur-complement update instead: triples, a walk, the factor
// (see chol_fwd in forward_sweeps.cuh, which holds the forward sweeps'
// chunk passes: K1 and K2 in banded_core.cu run them too).  The float
// instantiation is the same code: only the type of every value, constant
// and intrinsic changes.
//
// A pivot d <= 0 gives NaN, as the reference recursions do; nothing clamps.

#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>

#include "chunk_scan.cuh"
#include "forward_sweeps.cuh"

namespace {

// ---------------------------------------------------------------------------
// K9 / K15 / K17: chol_fwd<K, T>, the kernels of the passes of
// forward_sweeps.cuh over a batch of matrices (blockIdx.y)
// ---------------------------------------------------------------------------
template <int K, typename T, bool kMaps>
__global__ void __launch_bounds__(32)
chol_fwd_chunk_kernel(int m, int lc, int nmap, const T* __restrict__ a_all,
                      T* __restrict__ l_all, const T* __restrict__ win,
                      T* __restrict__ tri) {
  constexpr int D = K * (K + 1) / 2;
  const int j0 = blockIdx.x;
  const size_t mat = blockIdx.y;
  const size_t off = mat * (K + 1) * static_cast<size_t>(m);
  const size_t slot = mat * nmap + j0;
  chol_fwd_chunk<K, T, kMaps, false>(
      m, lc, j0, a_all + off, nullptr, kMaps ? nullptr : l_all + off, nullptr, nullptr,
      (!kMaps && j0 > 0) ? win + (slot - 1) * D : nullptr,
      kMaps ? tri + slot * (K * K + 2 * D) : nullptr);
}

template <int K, typename T>
__global__ void __launch_bounds__(32)
schur_walk_kernel(int nmap, const T* __restrict__ tri, T* __restrict__ win) {
  constexpr int D = K * (K + 1) / 2;
  constexpr int kTri = K * K + 2 * D;
  extern __shared__ __align__(16) unsigned char walk_smem[];
  const size_t mat = blockIdx.y;
  schur_walk<K, T, false>(nmap, tri + mat * nmap * kTri, kTri, win + mat * nmap * D, D,
                          reinterpret_cast<T*>(walk_smem));
}

// ---------------------------------------------------------------------------
// The linear sweeps tak_fwd<K, T>, chol_bwd<K, T> and tak_bwd<K, T>:
// affine recursions partitioned into chunks
//
// Given L, each walks the columns carrying D = K(K+1)/2 values that are
// affine in what it reads: the Takahashi sweep the entries of its window
// of S (the d^2 term its particular part), the adjoints their carried
// adjoints (the cotangent); only L (and K7's reciprocal pivots) enter the
// carry's update, S and the cotangent enter the outputs.  So their walks
// are cut into chunks of lc columns (carry_chunk_cols) and run in the
// three passes of chunk_scan.cuh, chunk 0 first:
//   1. maps (*_chunk_kernel<.., true>), grid (chunks but the last, matrices):
//      lane d < D runs the chunk from the carry e_d with no particular part
//      (the d^2 term, the cotangent), lane D from the carry 0 with it; their
//      final carries are H_j's column d and y_j.  No output is written.
//   2. scan (chunk_scan_kernel<D, T>), one thread per matrix: the incoming
//      carry of every chunk.
//   3. outputs (*_chunk_kernel<.., false>), grid (chunks, matrices): lane 0
//      runs the chunk from its true incoming carry and writes the outputs.
// All three run one column step (tak_fwd_step, chol_bwd_step,
// tak_bwd_step), in the order of operations of the one-chain recursion, so
// chunk 0, which starts from the zero carry, is that recursion bit for bit;
// the other chunks differ by the rounding of their incoming carries.  For a
// well-conditioned factor the homogeneous responses decay along a chunk (at
// the north star's ratio of lengthscale to knot spacing their entries are
// below 1e-6 after 64 columns); at a much higher condition number they
// grow (to hundreds at 10x that ratio), and so does the rounding the scan
// passes on.  Each CTA stages its chunk's columns, 64 a tile, in shared
// memory with cp.async, two tiles in flight, so no global load sits on a
// chain; the window of L (or S) that an adjoint's chunk starts from is read
// from global memory once, at its first column.  Pass 3 runs one chain per
// CTA: every CTA of it is resident at once, so packing chunks would not
// shorten the chain.
// ---------------------------------------------------------------------------

// ---------------------------------------------------------------------------
// K10 / K8 / K18: chol_bwd<K, T>
//
// The adjoint of chol_fwd, columns i = m-1..0.  P[q][r] carries the
// adjoint that the later columns sent to column i-q (row r of its band;
// only r >= q+1 is ever nonzero, the D slots of the carry);
// w[p-1][r] = L[i-p+r, i-p] is the window the forward step read, which
// the TPU kernel fetched from the previous tile (_prev_tiles).  Per
// column, with lb = (cot + P[0]) * mask and iv = 1 / L[i, i]:
//   a_0 = (lb_0 - iv sum_{r>=1} lb_r L[i+r, i]) iv / 2,  a_r = lb_r iv,
//   sb = -a;  for p = 1..K, with g = L[i, i-p]:
//     P[p-1][r] += sb[r-p] g  (r >= p),  P[p-1][p] += sum_j sb[j] w[p-1][p+j]
// (P shifted by one column first).  The cotangent of a padding slot is
// masked, so the padding slots of A-bar come out zero.
// ---------------------------------------------------------------------------
template <int K, typename T>
__device__ __forceinline__ void chol_bwd_step(T (&P)[K][K + 1], const T (&lc)[K + 1],
                                              const T (&w)[K][K + 1], const T (&cot)[K + 1],
                                              int i, int m, T (&ab)[K + 1]) {
  T lb[K + 1];
#pragma unroll
  for (int r = 0; r <= K; ++r) lb[r] = (cot[r] + P[0][r]) * ((i + r < m) ? T(1) : T(0));
  const T iv = T(1) / lc[0];
  T t1 = T(0);
#pragma unroll
  for (int r = 1; r <= K; ++r) t1 = fma_t(lb[r], lc[r], t1);
  ab[0] = (lb[0] - t1 * iv) * (T(0.5) * iv);
#pragma unroll
  for (int r = 1; r <= K; ++r) ab[r] = lb[r] * iv;

  // shift the carry to column i-1, then add this column's contributions
#pragma unroll
  for (int q = 0; q < K - 1; ++q) {
#pragma unroll
    for (int r = 0; r <= K; ++r) P[q][r] = P[q + 1][r];
  }
#pragma unroll
  for (int r = 0; r <= K; ++r) P[K - 1][r] = T(0);
#pragma unroll
  for (int p = 1; p <= K; ++p) {
    const T g = w[p - 1][p];
    T gbar = T(0);
#pragma unroll
    for (int j = 0; p + j <= K; ++j) gbar = fma_t(-ab[j], w[p - 1][p + j], gbar);
#pragma unroll
    for (int r = p; r <= K; ++r) P[p - 1][r] = fma_t(-ab[r - p], g, P[p - 1][r]);
    P[p - 1][p] += gbar;
  }
}

// Passes 1 (kMaps) and 3 over chunk blockIdx.x of matrix blockIdx.y: walk
// positions s..e-1, columns i = m-1-u.  A tile stages the cotangent of its
// positions and the L column each step brings into the window (i-1-K).
template <int K, typename T, bool kMaps>
__global__ void __launch_bounds__(32)
chol_bwd_chunk_kernel(int m, int lc, int nmap, const T* __restrict__ l_all,
                      const T* __restrict__ cot_all, T* __restrict__ abar_all,
                      const T* __restrict__ win, T* __restrict__ hmap,
                      T* __restrict__ ymap) {
  constexpr int D = K * (K + 1) / 2;
  __shared__ T ct[2][K + 1][kTile];  // cotangent columns of the positions
  __shared__ T lt[2][K + 1][kTile];  // L columns K+1 positions further on
  const int j = blockIdx.x;
  const size_t mat = blockIdx.y;
  const int lane = threadIdx.x;
  const size_t ms = static_cast<size_t>(m);
  const size_t off = mat * (K + 1) * ms;
  const T* __restrict__ l = l_all + off;
  const T* __restrict__ cot = cot_all + off;
  const int s = j * lc;
  const int e = (s + lc < m) ? s + lc : m;
  const bool takes_cot = kMaps ? lane == D : lane == 0;

  T P[K][K + 1];
  {
    int d = 0;
#pragma unroll
    for (int q = 0; q < K; ++q) {
#pragma unroll
      for (int r = 0; r <= K; ++r) P[q][r] = T(0);
#pragma unroll
      for (int r = q + 1; r <= K; ++r, ++d) {
        if (kMaps) {
          P[q][r] = (lane == d) ? T(1) : T(0);
        } else if (j > 0) {
          P[q][r] = win[(mat * nmap + j - 1) * D + d];
        }
      }
    }
  }
  // the window of the first column i0: L columns i0 .. i0-K
  const int i0 = m - 1 - s;
  T lcur[K + 1];
  T w[K][K + 1];
#pragma unroll
  for (int r = 0; r <= K; ++r) lcur[r] = l[r * ms + i0];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int col = i0 - 1 - q;
#pragma unroll
    for (int r = 0; r <= K; ++r) w[q][r] = (col >= 0) ? l[r * ms + col] : T(0);
  }

  const int ntiles = (e - s + kTile - 1) / kTile;
  stage_cols<K + 1, T, true>(ct[0], cot, m, s, min(kTile, e - s), 0);
  stage_cols<K + 1, T, true>(lt[0], l, m, s, min(kTile, e - s), K + 1);
  cp_async_commit();
  for (int tile = 0; tile < ntiles; ++tile) {
    const int buf = tile & 1;
    const int u0 = s + tile * kTile;
    const int n = min(kTile, e - u0);
    if (tile + 1 < ntiles) {
      const int u1 = u0 + kTile;
      stage_cols<K + 1, T, true>(ct[buf ^ 1], cot, m, u1, min(kTile, e - u1), 0);
      stage_cols<K + 1, T, true>(lt[buf ^ 1], l, m, u1, min(kTile, e - u1), K + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const int i = m - 1 - (u0 + t);
      T cc[K + 1];
#pragma unroll
      for (int r = 0; r <= K; ++r) cc[r] = takes_cot ? ct[buf][r][t] : T(0);
      T ab[K + 1];
      chol_bwd_step<K, T>(P, lcur, w, cc, i, m, ab);
      if (!kMaps && lane == 0) {
        T* __restrict__ abar = abar_all + off;
#pragma unroll
        for (int r = 0; r <= K; ++r) abar[r * ms + i] = ab[r];
      }
      // the window of column i-1: L columns i-1 .. i-1-K
#pragma unroll
      for (int r = 0; r <= K; ++r) lcur[r] = w[0][r];
#pragma unroll
      for (int q = 0; q < K - 1; ++q) {
#pragma unroll
        for (int r = 0; r <= K; ++r) w[q][r] = w[q + 1][r];
      }
#pragma unroll
      for (int r = 0; r <= K; ++r) w[K - 1][r] = lt[buf][r][t];
    }
    __syncthreads();
  }

  if (kMaps) {
    int d = 0;
#pragma unroll
    for (int q = 0; q < K; ++q) {
#pragma unroll
      for (int r = q + 1; r <= K; ++r, ++d) {
        if (lane < D) {
          hmap[((mat * nmap + j) * D + d) * D + lane] = P[q][r];
        } else if (lane == D) {
          ymap[(mat * nmap + j) * D + d] = P[q][r];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K11 / K19: tak_fwd<K, T>, the kernel of forward_sweeps.cuh's tak_fwd_chunk
// over a batch of matrices (blockIdx.y)
// ---------------------------------------------------------------------------
template <int K, typename T, bool kMaps>
__global__ void __launch_bounds__(32)
tak_fwd_chunk_kernel(int m, int lc, int nmap, const T* __restrict__ l_all,
                     T* __restrict__ s_all, const T* __restrict__ win,
                     T* __restrict__ hmap, T* __restrict__ ymap) {
  constexpr int D = K * (K + 1) / 2;
  const int j0 = blockIdx.x;
  const size_t mat = blockIdx.y;
  const size_t off = mat * (K + 1) * static_cast<size_t>(m);
  const size_t slot = mat * nmap + j0;
  tak_fwd_chunk<K, T, kMaps, false, false, D>(
      m, lc, j0, l_all + off, nullptr, nullptr, kMaps ? nullptr : s_all + off, nullptr,
      (!kMaps && j0 > 0) ? win + (slot - 1) * D : nullptr,
      kMaps ? hmap + slot * D * D : nullptr, kMaps ? ymap + slot * D : nullptr);
}

// ---------------------------------------------------------------------------
// K12 / K7 / K20 / K23: tak_bwd<K, T>
//
// The adjoint of tak_fwd, columns j = 0..m-1.  Q[c][r] carries the adjoint
// sent to S column j+1+c (only c + r <= K-1 is ever nonzero, the D slots
// of the carry); cs[c][r] = S[j+1+c+r, j+1+c] is the window the forward
// step read (the TPU kernel's _next_tiles), zero beyond column m-1.  Per
// column, with cb = (cot + Q[0]) * mask, d = 1 / L[j, j] (K12) or iv[j]
// (K7), w_q = L[j+q, j], s_q = S[j+q, j], t_q = -s_q L[j, j],
// M[q][p] = cs[min(p,q)-1][|q-p|] and m1 = d cb_0:
//   d-bar = 2 m1 - cb_0 sum_q w_q s_q - sum_q sb_q t_q,  sb_q = cb_q - m1 w_q,
//   tb_q = -d sb_q,  w-bar_p = -m1 s_p + sum_q tb_q M[q][p],
//   L-bar[j, j] = -d-bar d^2,  Q[min(p,q)-1][|q-p|] += tb_q w_p
// (Q shifted by one column first).  The carry's update needs L, the
// cotangent and d, not S: pass 1 (kOut false) reads no S.  "The adjoint
// shares the forward's instability" (pallas_ds.py): at a high condition
// number of A it amplifies rounding as the forward recursion does.
// ---------------------------------------------------------------------------
template <int K, typename T, bool kOut>
__device__ __forceinline__ void tak_bwd_step(T (&Q)[K][K + 1], const T (&lc)[K + 1], T d,
                                             const T (&cot)[K + 1], int j, int m,
                                             const T (&sc)[K + 1], const T (&cs)[K][K + 1],
                                             T (&lbar)[K + 1]) {
  T cb[K + 1];
#pragma unroll
  for (int r = 0; r <= K; ++r) cb[r] = (cot[r] + Q[0][r]) * ((j + r < m) ? T(1) : T(0));
  const T l0 = lc[0];
  const T m1 = d * cb[0];

  T db = T(0);
  if (kOut) {
    T ws = T(0);
#pragma unroll
    for (int q = 1; q <= K; ++q) ws = fma_t(lc[q], sc[q], ws);
    db = T(2) * m1 - ws * cb[0];
  }
  T tb[K + 1];
  T wb[K + 1];
#pragma unroll
  for (int q = 1; q <= K; ++q) {
    const T sb = cb[q] - m1 * lc[q];
    if (kOut) {
      db -= sb * (-sc[q] * l0);
      wb[q] = -m1 * sc[q];
    }
    tb[q] = -d * sb;
  }

  // shift the carry to column j+1, then add this column's contributions
#pragma unroll
  for (int c = 0; c < K - 1; ++c) {
#pragma unroll
    for (int r = 0; r <= K; ++r) Q[c][r] = Q[c + 1][r];
  }
#pragma unroll
  for (int r = 0; r <= K; ++r) Q[K - 1][r] = T(0);
#pragma unroll
  for (int q = 1; q <= K; ++q) {
#pragma unroll
    for (int p = 1; p <= K; ++p) {
      const int lo = (p < q) ? p : q;
      const int df = (p < q) ? (q - p) : (p - q);
      if (kOut) wb[p] = fma_t(tb[q], cs[lo - 1][df], wb[p]);
      Q[lo - 1][df] = fma_t(tb[q], lc[p], Q[lo - 1][df]);
    }
  }

  if (kOut) {
    lbar[0] = -db * d * d;
#pragma unroll
    for (int q = 1; q <= K; ++q) lbar[q] = wb[q];
  }
}

// Passes 1 (kMaps) and 3 over chunk blockIdx.x of matrix blockIdx.y: columns
// j = s..e-1.  A tile stages L, the cotangent and (K7) the reciprocal
// pivots of its columns and, in pass 3, the S column each step brings into
// the window (j+1+K).
template <int K, typename T, bool kMaps>
__global__ void __launch_bounds__(32)
tak_bwd_chunk_kernel(int m, int lc, int nmap, const T* __restrict__ l_all,
                     const T* __restrict__ s_all, const T* __restrict__ cot_all,
                     const T* __restrict__ iv_all, T* __restrict__ lbar_all,
                     const T* __restrict__ win, T* __restrict__ hmap,
                     T* __restrict__ ymap) {
  constexpr int D = K * (K + 1) / 2;
  __shared__ T lt[2][K + 1][kTile];             // L columns of the positions
  __shared__ T ct[2][K + 1][kTile];             // cotangent columns
  __shared__ T vt[2][1][kTile];                 // reciprocal pivots (K7)
  __shared__ T st[kMaps ? 1 : 2][K + 1][kTile];  // S columns K+1 further on
  const int j0 = blockIdx.x;
  const size_t mat = blockIdx.y;
  const int lane = threadIdx.x;
  const size_t ms = static_cast<size_t>(m);
  const size_t off = mat * (K + 1) * ms;
  const T* __restrict__ l = l_all + off;
  const T* __restrict__ sb = s_all + off;
  const T* __restrict__ cot = cot_all + off;
  const T* __restrict__ iv = (iv_all != nullptr) ? iv_all + mat * ms : nullptr;
  const int s = j0 * lc;
  const int e = (s + lc < m) ? s + lc : m;
  const bool takes_cot = kMaps ? lane == D : lane == 0;

  T Q[K][K + 1];
  {
    int d = 0;
#pragma unroll
    for (int c = 0; c < K; ++c) {
#pragma unroll
      for (int r = 0; r <= K; ++r) Q[c][r] = T(0);
#pragma unroll
      for (int r = 0; r < K - c; ++r, ++d) {
        if (kMaps) {
          Q[c][r] = (lane == d) ? T(1) : T(0);
        } else if (j0 > 0) {
          Q[c][r] = win[(mat * nmap + j0 - 1) * D + d];
        }
      }
    }
  }
  // pass 3: the window of S of the first column s: S columns s .. s+K
  T sc[K + 1];
  T cs[K][K + 1];
#pragma unroll
  for (int r = 0; r <= K; ++r) sc[r] = (!kMaps) ? sb[r * ms + s] : T(0);
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const int col = s + 1 + c;
#pragma unroll
    for (int r = 0; r <= K; ++r) cs[c][r] = (!kMaps && col < m) ? sb[r * ms + col] : T(0);
  }

  const int ntiles = (e - s + kTile - 1) / kTile;
  for (int tile = -1; tile < ntiles; ++tile) {
    // stage tile + 1 while tile runs
    const int u1 = s + (tile + 1) * kTile;
    if (tile + 1 < ntiles) {
      const int nb1 = (tile + 1) & 1;
      const int n1 = min(kTile, e - u1);
      stage_cols<K + 1, T, false>(lt[nb1], l, m, u1, n1, 0);
      stage_cols<K + 1, T, false>(ct[nb1], cot, m, u1, n1, 0);
      if (iv != nullptr) stage_cols<1, T, false>(vt[nb1], iv, m, u1, n1, 0);
      if (!kMaps) stage_cols<K + 1, T, false>(st[kMaps ? 0 : nb1], sb, m, u1, n1, K + 1);
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
      const int j = u0 + t;
      T lcur[K + 1];
      T cc[K + 1];
#pragma unroll
      for (int r = 0; r <= K; ++r) {
        lcur[r] = lt[buf][r][t];
        cc[r] = takes_cot ? ct[buf][r][t] : T(0);
      }
      const T d = (iv != nullptr) ? vt[buf][0][t] : T(1) / lcur[0];
      T lb[K + 1];
      tak_bwd_step<K, T, !kMaps>(Q, lcur, d, cc, j, m, sc, cs, lb);
      if (!kMaps) {
        if (lane == 0) {
          T* __restrict__ lbar = lbar_all + off;
#pragma unroll
          for (int r = 0; r <= K; ++r) lbar[r * ms + j] = lb[r];
        }
        // the window of column j+1: S columns j+1 .. j+1+K
#pragma unroll
        for (int r = 0; r <= K; ++r) sc[r] = cs[0][r];
#pragma unroll
        for (int c = 0; c < K - 1; ++c) {
#pragma unroll
          for (int r = 0; r <= K; ++r) cs[c][r] = cs[c + 1][r];
        }
#pragma unroll
        for (int r = 0; r <= K; ++r) cs[K - 1][r] = st[kMaps ? 0 : buf][r][t];
      }
    }
    __syncthreads();
  }

  if (kMaps) {
    int d = 0;
#pragma unroll
    for (int c = 0; c < K; ++c) {
#pragma unroll
      for (int r = 0; r < K - c; ++r, ++d) {
        if (lane < D) {
          hmap[((mat * nmap + j0) * D + d) * D + lane] = Q[c][r];
        } else if (lane == D) {
          ymap[(mat * nmap + j0) * D + d] = Q[c][r];
        }
      }
    }
  }
}

// Up to kTwoChunkCols columns a linear sweep takes at most two chunks.
// The second chunk's incoming carry is then the first's particular part,
// the one-pass recursion's own window, and no map meets a carry: the
// sweep keeps the one-pass recursion's accuracy.  From three chunks on the
// scan applies the maps, whose entries grow with κ(A), and the carries
// lose about two digits: at the additive model's Kuu (B3, m = 250,
// Matérn-3/2 at ℓ/δ = 49, κ = 2.9e6) K11's band of A⁻¹ lay 5.8e-12 from
// an extended-precision one against the one-pass recursion's 8.5e-14, and
// the model's lengthscale gradient moved 5e-7 on an H100.  Beyond
// kTwoChunkCols the loss stays (ROADMAP.md, queue 3).
constexpr int kTwoChunkCols = 512;

// Columns per chunk of the linear sweeps: at least kMinChunk, at most
// kMaxChunks chunks and at most as many as the scan can stage the maps of
// in shared memory (D^2 + D doubles each, whatever T), a multiple of the
// tile, and half the walk up to kTwoChunkCols columns.  lc >= m is one
// chunk.  At m = 10^4: 64 columns for k <= 4, 128 at k = 5, 192 at k = 6;
// at m = 250: 128.
int carry_chunk_cols(int k, int m) {
  const long d = static_cast<long>(k) * (k + 1) / 2;
  const int lc = partition_cols(d * d + d, kMinChunk, m);
  if (m > kTwoChunkCols) return lc;
  const int half = ((m + 1) / 2 + kTile - 1) / kTile * kTile;
  return lc >= half ? lc : (half < m ? half : m);
}

// Elements of T of the workspace of a linear sweep over nb matrices: H
// (nb, P-1, D, D), y (nb, P-1, D) and the incoming carries (nb, P-1, D);
// 0 when P = 1.
size_t carry_workspace(int k, int m, int nb) {
  const int lc = carry_chunk_cols(k, m);
  const size_t nmap = static_cast<size_t>((m + lc - 1) / lc - 1);
  const size_t d = static_cast<size_t>(k) * (k + 1) / 2;
  return static_cast<size_t>(nb) * nmap * (d * d + 2 * d);
}

// Columns per chunk of the Cholesky sweep: at least ASVGP_SCHUR_CHUNK, at
// most kMaxChunks chunks and at most as many as the walk can stage the
// triples of (k^2 + k(k+1) doubles each, whatever T), a multiple of the
// tile; lc >= m is one chunk.  At m = 10^4: 128 columns at every k, 79
// chunks; a pass-1 or pass-3 column costs about half a walk step, and 128
// took the least device time of 64, 128 and 192 for k = 3 in float64 on
// an H100 (tools/forward_ab.py --schur-chunk).
int schur_chunk_cols(int k, int m) {
  return partition_cols(static_cast<long>(k) * k + static_cast<long>(k) * (k + 1),
                        ASVGP_SCHUR_CHUNK, m);
}

// Elements of T of the Cholesky sweep's workspace over nb matrices: the
// triples (nb, P-1, k^2 + k(k+1)) and the walked W (nb, P-1, k(k+1)/2);
// 0 when P = 1.
size_t schur_workspace(int k, int m, int nb) {
  const int lc = schur_chunk_cols(k, m);
  const size_t nmap = static_cast<size_t>((m + lc - 1) / lc - 1);
  const size_t d = static_cast<size_t>(k) * (k + 1) / 2;
  return static_cast<size_t>(nb) * nmap * (static_cast<size_t>(k) * k + 3 * d);
}

template <int K, typename T>
cudaError_t launch_chol_fwd(int m, int nb, const T* a, T* l, T* ws, cudaStream_t st) {
  constexpr int D = K * (K + 1) / 2;
  constexpr int kTri = K * K + 2 * D;
  const int lc = schur_chunk_cols(K, m);
  const int nchunks = (m + lc - 1) / lc;
  const int nmap = nchunks - 1;
  const T* win = nullptr;
  if (nmap > 0) {
    if (ws == nullptr) return cudaErrorInvalidValue;
    T* tri = ws;
    T* w = tri + static_cast<size_t>(nb) * nmap * kTri;
    chol_fwd_chunk_kernel<K, T, true><<<dim3(nmap, nb), 32, 0, st>>>(
        m, lc, nmap, a, nullptr, nullptr, tri);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    const size_t smem = static_cast<size_t>(nmap) * kTri * sizeof(T);
    if (smem > kSmemLimit) return cudaErrorInvalidValue;
    static std::atomic<unsigned long long> done{0};
    e = allow_smem(schur_walk_kernel<K, T>, done);
    if (e != cudaSuccess) return e;
    schur_walk_kernel<K, T><<<dim3(1, nb), 32, smem, st>>>(nmap, tri, w);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    win = w;
  }
  chol_fwd_chunk_kernel<K, T, false><<<dim3(nchunks, nb), 32, 0, st>>>(
      m, lc, nmap, a, l, win, nullptr);
  return cudaGetLastError();
}

// The three passes of a linear sweep over nb matrices, on the stream: when
// the walk has more than one chunk, maps(grid, lc, nmap, hmap, ymap)
// launches pass 1 and the scan follows; then outs(grid, lc, nmap, win)
// launches pass 3.
template <int K, typename T, typename Maps, typename Outs>
cudaError_t launch_linear(int m, int nb, T* ws, Maps maps, Outs outs, cudaStream_t st) {
  constexpr int D = K * (K + 1) / 2;
  const int lc = carry_chunk_cols(K, m);
  const int nchunks = (m + lc - 1) / lc;
  const int nmap = nchunks - 1;
  const T* win = nullptr;
  if (nmap > 0) {
    if (ws == nullptr) return cudaErrorInvalidValue;
    const size_t hs = static_cast<size_t>(nmap) * D * D;
    const size_t ys = static_cast<size_t>(nmap) * D;
    T* hmap = ws;
    T* ymap = hmap + nb * hs;
    T* w = ymap + nb * ys;
    maps(dim3(nmap, nb), lc, nmap, hmap, ymap);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    e = launch_chunk_scan<D, T>(1, nb, nmap, hmap, hs, ymap, ys, w, st);
    if (e != cudaSuccess) return e;
    win = w;
  }
  outs(dim3(nchunks, nb), lc, nmap, win);
  return cudaGetLastError();
}

template <int K, typename T>
cudaError_t launch_tak_fwd(int m, int nb, const T* l, T* s, T* ws, cudaStream_t st) {
  return launch_linear<K, T>(
      m, nb, ws,
      [=](dim3 grid, int lc, int nmap, T* hmap, T* ymap) {
        tak_fwd_chunk_kernel<K, T, true><<<grid, 32, 0, st>>>(
            m, lc, nmap, l, nullptr, nullptr, hmap, ymap);
      },
      [=](dim3 grid, int lc, int nmap, const T* win) {
        tak_fwd_chunk_kernel<K, T, false><<<grid, 32, 0, st>>>(
            m, lc, nmap, l, s, win, nullptr, nullptr);
      },
      st);
}

template <int K, typename T>
cudaError_t launch_chol_bwd(int m, int nb, const T* l, const T* cot, T* abar, T* ws,
                            cudaStream_t st) {
  return launch_linear<K, T>(
      m, nb, ws,
      [=](dim3 grid, int lc, int nmap, T* hmap, T* ymap) {
        chol_bwd_chunk_kernel<K, T, true><<<grid, 32, 0, st>>>(
            m, lc, nmap, l, cot, nullptr, nullptr, hmap, ymap);
      },
      [=](dim3 grid, int lc, int nmap, const T* win) {
        chol_bwd_chunk_kernel<K, T, false><<<grid, 32, 0, st>>>(
            m, lc, nmap, l, cot, abar, win, nullptr, nullptr);
      },
      st);
}

template <int K, typename T>
cudaError_t launch_tak_bwd(int m, int nb, const T* l, const T* s, const T* cot,
                           const T* iv, T* lbar, T* ws, cudaStream_t st) {
  return launch_linear<K, T>(
      m, nb, ws,
      [=](dim3 grid, int lc, int nmap, T* hmap, T* ymap) {
        tak_bwd_chunk_kernel<K, T, true><<<grid, 32, 0, st>>>(
            m, lc, nmap, l, s, cot, iv, nullptr, nullptr, hmap, ymap);
      },
      [=](dim3 grid, int lc, int nmap, const T* win) {
        tak_bwd_chunk_kernel<K, T, false><<<grid, 32, 0, st>>>(
            m, lc, nmap, l, s, cot, iv, lbar, win, nullptr, nullptr);
      },
      st);
}

}  // namespace

extern "C" {

// Elements of workspace (of the sweep's dtype) that K9 / K15 / K17 need
// for nb (k+1, m) bands: 0 when the columns form one chunk.
int asvgp_schur_workspace(int k, int m, int nb) {
  if (k < 1 || k > 6 || m < 1 || nb < 1) return -1;
  return static_cast<int>(schur_workspace(k, m, nb));
}

// K9, K15 (double) / K17 (float).  a: nb (k+1, m) lower bands, ws:
// asvgp_schur_workspace(k, m, nb) elements, or NULL when that is 0.
// Writes l: their Cholesky bands.
#define ASVGP_CHOL_FWD(NAME, T)                                          \
  int NAME(int k, int m, int nb, const T* a, T* l, T* ws, void* stream) { \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                 \
    if (m < 1 || nb < 1) return static_cast<int>(cudaErrorInvalidValue); \
    ASVGP_DISPATCH_K(k, (launch_chol_fwd<K, T>(m, nb, a, l, ws, st)))    \
  }
ASVGP_CHOL_FWD(asvgp_chol_fwd, double)
ASVGP_CHOL_FWD(asvgp_chol_fwd_f32, float)

// Elements of workspace (of the sweep's dtype) that the linear sweeps need
// for nb (k+1, m) bands, K11 / K19 and the adjoints K10 / K8 / K18 and
// K12 / K7 / K20 / K23: 0 when the columns form one chunk.
int asvgp_carry_workspace(int k, int m, int nb) {
  if (k < 1 || k > 6 || m < 1 || nb < 1) return -1;
  return static_cast<int>(carry_workspace(k, m, nb));
}

// K10 / K8 (double) / K18 (float).  l: nb Cholesky bands, cot: their
// cotangents, ws: asvgp_carry_workspace(k, m, nb) elements, or NULL when
// that is 0.  Writes abar.
#define ASVGP_CHOL_BWD(NAME, T)                                          \
  int NAME(int k, int m, int nb, const T* l, const T* cot, T* abar,      \
           T* ws, void* stream) {                                        \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                 \
    if (m < 1 || nb < 1) return static_cast<int>(cudaErrorInvalidValue); \
    ASVGP_DISPATCH_K(k, (launch_chol_bwd<K, T>(m, nb, l, cot, abar, ws, st))) \
  }
ASVGP_CHOL_BWD(asvgp_chol_bwd, double)
ASVGP_CHOL_BWD(asvgp_chol_bwd_f32, float)

// K11 (double) / K19 (float).  l: nb Cholesky bands, ws as for the
// adjoints.  Writes s: the bands of their inverses.
#define ASVGP_TAK_FWD(NAME, T)                                           \
  int NAME(int k, int m, int nb, const T* l, T* s, T* ws, void* stream) { \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                 \
    if (m < 1 || nb < 1) return static_cast<int>(cudaErrorInvalidValue); \
    ASVGP_DISPATCH_K(k, (launch_tak_fwd<K, T>(m, nb, l, s, ws, st)))     \
  }
ASVGP_TAK_FWD(asvgp_tak_fwd, double)
ASVGP_TAK_FWD(asvgp_tak_fwd_f32, float)

// K12 (iv == NULL) / K7, K23 (iv: nb (m,) reciprocal pivots of l),
// double; K20 (iv == NULL), float.  l, s, cot: nb bands of the factor, its
// Takahashi band and that band's cotangent; ws as for the Cholesky
// adjoint.  Writes lbar.
#define ASVGP_TAK_BWD(NAME, T)                                           \
  int NAME(int k, int m, int nb, const T* l, const T* s, const T* cot,   \
           const T* iv, T* lbar, T* ws, void* stream) {                  \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                 \
    if (m < 1 || nb < 1) return static_cast<int>(cudaErrorInvalidValue); \
    ASVGP_DISPATCH_K(k, (launch_tak_bwd<K, T>(m, nb, l, s, cot, iv, lbar, ws, st))) \
  }
ASVGP_TAK_BWD(asvgp_tak_bwd, double)
ASVGP_TAK_BWD(asvgp_tak_bwd_f32, float)

}  // extern "C"
