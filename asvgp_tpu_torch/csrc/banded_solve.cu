// The two banded triangular solves, L x = b and L^T x = b, in float64 and
// in float32 for Hopper (sm_90a).
//
// Storage as in banded_adjoint.cu: L is a (K+1, m) lower band, row-major,
//     band[j * m + i] = L[i + j, i],   0 <= j <= K,
// with the right-padding slots (i + j >= m) zero.  The right-hand side b
// and the solution x are (m, r) row-major (x[i * r + c]): r >= 1 columns,
// a vector being r = 1.  Compile-time K = 1..6, templated on the scalar
// type T:
//
//   solve_lower<K, T>    L x = b, rows i = 0..m-1 (launch_solve<K, T, false>):
//       x_i = (b_i - sum_{p=1..K} L[i, i-p] x_{i-p}) / L[i, i]
//                        double: K13; float: K21
//   solve_upper_t<K, T>  L^T x = b, rows i = m-1..0 (launch_solve<K, T, true>):
//       x_i = (b_i - sum_{p=1..K} L[i+p, i] x_{i+p}) / L[i, i]
//                        double: K14; float: K22
//
// They replace, in asvgp_tpu/banded/: pallas_ds.py _solve_lower_ds_kernel
// and _solve_upper_t_ds_kernel (float64, carried there as float32 hi/lo
// pairs) and pallas_kernels.py _solve_lower_kernel and
// _solve_upper_t_kernel (float32).  The TPU kernels take one vector; these
// take r columns, so a matrix right-hand side needs no plain loop either.
// The TPU kernels walk 128-column tiles with the window as the loop carry
// and read the band through shifted copies built outside the kernel
// (G[p-1, i] = L[i, i-p]); here the band is read in place.
//
// Every operation of a row is spelled with the round-to-nearest intrinsics
// (__dmul_rn, __dadd_rn, __dsub_rn, __ddiv_rn and their float forms): the
// sum over p in increasing p, no fma contraction, the plain version's
// recursion rounded step by step.  A zero pivot gives inf or NaN, as the
// reference recursions do; nothing clamps.
//
// Both solves: a substitution partitioned into chunks.
//   What bounds them: one dependent chain of m rows per column of b (K
//   dependent products and sums, a subtract and a divide per row).  A
//   solve reads (K+1) m + m r values and writes m r: under 1 MB at
//   m = 10^4 for a vector, so neither bandwidth nor the arithmetic rate is
//   the limit, the chain's length is.
//   What the design does about it: one kernel serves both directions.  It
//   walks positions u = 0..m-1, row i = u (solve_lower) or i = m-1-u
//   (solve_upper_t), so the window X[p] is the x of walk position u-1-p
//   and g[p] the band entry it multiplies (L[i, i-p], or L[i+p, i]).  The
//   walk is cut into P chunks of lc positions (chunk_rows), chunk 0 first:
//   the top rows of the lower solve, the bottom rows of the upper one; x
//   on a chunk is affine in its incoming window w (the K x walked just
//   before it).  Three launches:
//     1. maps (solve_chunk_kernel<.., true>), one CTA per chunk but the
//        last: K + r chains of lc rows, the K homogeneous responses (b = 0,
//        window e_q) and the r particular solutions (window 0), of which
//        only the last K rows are kept: the chunk's outgoing window is
//        y + H w;
//     2. scan (chunk_scan_kernel<K, T> of chunk_scan.cuh, shared with the
//        adjoints of banded_adjoint.cu): one thread per column walks the
//        P - 1 maps, w_{j+1} = y_j + H_j w_j, from the staged maps;
//     3. solve (solve_chunk_kernel<.., false>), one CTA per chunk: the
//        plain recursion from the chunk's true incoming window, in the
//        plain version's order, writing x.
//   So the card runs three chains of ~lc + P + lc steps instead of one of
//   m.  Chunk 0 starts from the zero window, as the serial recursion does,
//   so its rows are the serial ones bit for bit; later chunks differ only
//   by the rounding of their incoming windows, which went through the
//   composed maps.  Short chunks keep the homogeneous responses bounded:
//   for a Cholesky factor their entries are entries of a block of L^-1
//   (L^-T) times L, and at the north star's L_P they have decayed below
//   1e-17 by the end of a 64-row chunk.
//   Each CTA stages its chunk's band and b in walk order, 64 positions a
//   tile, in shared memory with cp.async, two tiles in flight, so no
//   global load sits on a chain; a chunk longer than a tile streams
//   through the two buffers.  The upper solve's band entries of a tile are
//   one contiguous run per p (band[p][i], the padding slots at i + p >= m
//   already zero), read from the top of the run down.  With many columns,
//   P falls until P = 1: the serial recursion with staged loads, one CTA
//   per 32 columns.

#include <cuda_runtime.h>

#include <cstddef>

#include "chunk_scan.cuh"

namespace {

__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }

// ---------------------------------------------------------------------------
// K13 / K21 solve_lower<K, T> and K14 / K22 solve_upper_t<K, T>
// ---------------------------------------------------------------------------

constexpr int kChains = 32;       // chains of one CTA of passes 1 and 3: a warp
constexpr long kFill = 4096;      // chunks x columns that fill the card

// rows per chunk: at least kMinChunk, at most kMaxChunks chunks, and about
// kFill chains over the columns; a multiple of the tile.  lc >= m is P = 1.
int chunk_rows(int m, int r) {
  long lc = kMinChunk;
  const long by_count = (m + kMaxChunks - 1) / kMaxChunks;
  const long by_fill = (static_cast<long>(m) * r + kFill - 1) / kFill;
  if (by_count > lc) lc = by_count;
  if (by_fill > lc) lc = by_fill;
  lc = (lc + kTile - 1) / kTile * kTile;
  return static_cast<int>(lc < m ? lc : m);
}

// the row at walk position u
template <bool kUpper>
__device__ __forceinline__ int walk_row(int m, int u) {
  return kUpper ? m - 1 - u : u;
}

// Stage walk positions u0..u0+n-1, row i = walk_row(u) each: g[p][t] = the
// band entry that multiplies the window's X[p-1] (L[i, i-p], 0 for i < p,
// in the lower solve; L[i+p, i] in the upper one) and bt[t][.] = the
// columns cb0..cb1-1 of b's row i, at offset cb0 - col0.
template <int K, typename T, bool kUpper>
__device__ __forceinline__ void stage_tile(T (*g)[kTile], T (*bt)[kChains],
                                           const T* __restrict__ l,
                                           const T* __restrict__ b, int m, int r,
                                           int u0, int n, int col0, int cb0, int cb1) {
  const size_t ms = static_cast<size_t>(m);
  for (int idx = threadIdx.x; idx < (K + 1) * kTile; idx += kChains) {
    const int p = idx / kTile;
    const int t = idx % kTile;
    if (t < n) {
      const int i = walk_row<kUpper>(m, u0 + t);
      if (kUpper) {
        cp_async(&g[p][t], l + p * ms + i);
      } else if (i >= p) {
        cp_async(&g[p][t], l + p * ms + (i - p));
      } else {
        g[p][t] = T(0);
      }
    }
  }
  const int nc = cb1 - cb0;
  for (int idx = threadIdx.x; idx < n * nc; idx += kChains) {
    const int t = idx / nc;
    const int cc = idx % nc;
    const size_t i = static_cast<size_t>(walk_row<kUpper>(m, u0 + t));
    cp_async(&bt[t][cb0 - col0 + cc], b + i * r + cb0 + cc);
  }
  cp_async_commit();
}

// Passes 1 (kMaps) and 3: the recursion over chunk blockIdx.x of the walk,
// chain q = blockIdx.y * 32 + lane.  Pass 1: chains q < K are the
// homogeneous responses (window e_q, b = 0), chains K..K+r-1 the
// particular solutions of the columns q - K (window 0); their last window
// goes to hmap[j][p][q] and ymap[j][c][p].  Pass 3: chain q is column q,
// from the incoming window win[j-1][q] (0 for chunk 0), and writes x.
template <int K, typename T, bool kUpper, bool kMaps>
__global__ void __launch_bounds__(kChains)
solve_chunk_kernel(int m, int r, int lc, const T* __restrict__ l,
                   const T* __restrict__ b, T* __restrict__ x,
                   const T* __restrict__ win, T* __restrict__ hmap,
                   T* __restrict__ ymap) {
  __shared__ T g[2][K + 1][kTile];
  __shared__ T bt[2][kTile][kChains];
  const int j = blockIdx.x;
  const int lane = threadIdx.x;
  const int q = blockIdx.y * kChains + lane;
  const int s = j * lc;
  const int e = (s + lc < m) ? s + lc : m;
  const int shift = kMaps ? K : 0;
  const int c = q - shift;  // column of b; < 0 for a homogeneous chain
  const bool has_b = c >= 0 && c < r;
  const int col0 = blockIdx.y * kChains - shift;
  const int cb0 = col0 > 0 ? col0 : 0;
  const int cb1 = (col0 + kChains < r) ? col0 + kChains : r;
  const size_t rs = static_cast<size_t>(r);

  // X[p]: the x of walk position u-1-p, the window
  T X[K];
#pragma unroll
  for (int p = 0; p < K; ++p) {
    if (kMaps) {
      X[p] = (q == p) ? T(1) : T(0);
    } else {
      X[p] = (j > 0 && has_b) ? win[((static_cast<size_t>(j) - 1) * rs + c) * K + p] : T(0);
    }
  }

  const int ntiles = (e - s + kTile - 1) / kTile;
  stage_tile<K, T, kUpper>(g[0], bt[0], l, b, m, r, s, min(kTile, e - s), col0, cb0, cb1);
  for (int tile = 0; tile < ntiles; ++tile) {
    const int buf = tile & 1;
    const int u0 = s + tile * kTile;
    const int n = min(kTile, e - u0);
    if (tile + 1 < ntiles) {
      const int u1 = u0 + kTile;
      stage_tile<K, T, kUpper>(g[buf ^ 1], bt[buf ^ 1], l, b, m, r, u1, min(kTile, e - u1),
                               col0, cb0, cb1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      T acc = mul_rn(g[buf][1][t], X[0]);
#pragma unroll
      for (int p = 2; p <= K; ++p) acc = add_rn(acc, mul_rn(g[buf][p][t], X[p - 1]));
      const T bi = has_b ? bt[buf][t][lane] : T(0);
      const T xi = div_rn(sub_rn(bi, acc), g[buf][0][t]);
      if (!kMaps && has_b) {
        x[static_cast<size_t>(walk_row<kUpper>(m, u0 + t)) * rs + c] = xi;
      }
#pragma unroll
      for (int p = K - 1; p > 0; --p) X[p] = X[p - 1];
      X[0] = xi;
    }
    __syncthreads();
  }

  if (kMaps) {
    if (q < K) {
#pragma unroll
      for (int p = 0; p < K; ++p) hmap[(static_cast<size_t>(j) * K + p) * K + q] = X[p];
    } else if (has_b) {
#pragma unroll
      for (int p = 0; p < K; ++p) ymap[(static_cast<size_t>(j) * rs + c) * K + p] = X[p];
    }
  }
}

// Elements of T of the workspace: H (P-1, K, K), y (P-1, r, K) and the
// incoming windows (P-1, r, K); 0 when P = 1.
size_t solve_workspace(int k, int m, int r) {
  const int lc = chunk_rows(m, r);
  const size_t nmap = static_cast<size_t>((m + lc - 1) / lc - 1);
  return nmap * k * (k + 2 * static_cast<size_t>(r));
}

template <int K, typename T, bool kUpper>
cudaError_t launch_solve(int m, int r, const T* l, const T* b, T* x, T* ws,
                         cudaStream_t st) {
  const int lc = chunk_rows(m, r);
  const int nchunks = (m + lc - 1) / lc;
  const unsigned col_blocks = static_cast<unsigned>((r + kChains - 1) / kChains);
  const T* win = nullptr;
  if (nchunks > 1) {
    if (ws == nullptr) return cudaErrorInvalidValue;
    const int nmap = nchunks - 1;
    T* hmap = ws;
    T* ymap = hmap + static_cast<size_t>(nmap) * K * K;
    T* w = ymap + static_cast<size_t>(nmap) * r * K;
    const dim3 maps_grid(nmap, (K + r + kChains - 1) / kChains);
    solve_chunk_kernel<K, T, kUpper, true><<<maps_grid, kChains, 0, st>>>(
        m, r, lc, l, b, nullptr, nullptr, hmap, ymap);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    e = launch_chunk_scan<K, T>(r, 1, nmap, hmap, 0, ymap, 0, w, st);
    if (e != cudaSuccess) return e;
    win = w;
  }
  solve_chunk_kernel<K, T, kUpper, false><<<dim3(nchunks, col_blocks), kChains, 0, st>>>(
      m, r, lc, l, b, x, win, nullptr, nullptr);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Elements of workspace (of the solve's dtype) that K13 / K14 / K21 / K22
// need for a (k+1, m) band and r columns: 0 when the rows form one chunk.
int asvgp_solve_workspace(int k, int m, int r) {
  if (k < 1 || m < 1 || r < 1) return -1;
  return static_cast<int>(solve_workspace(k, m, r));
}

// K13 (double) / K21 (float): x = L^-1 b; K14 (double) / K22 (float):
// x = L^-T b.  l: a (k+1, m) lower band, b and x: (m, r), ws:
// asvgp_solve_workspace(k, m, r) elements, or NULL when that is 0.
#define ASVGP_SOLVE(NAME, T, UPPER)                                      \
  int NAME(int k, int m, int r, const T* l, const T* b, T* x, T* ws,     \
           void* stream) {                                               \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                 \
    if (m < 1 || r < 1) return static_cast<int>(cudaErrorInvalidValue);  \
    ASVGP_DISPATCH_K(k, (launch_solve<K, T, UPPER>(m, r, l, b, x, ws, st)))  \
  }
ASVGP_SOLVE(asvgp_solve_lower, double, false)
ASVGP_SOLVE(asvgp_solve_lower_f32, float, false)
ASVGP_SOLVE(asvgp_solve_upper_t, double, true)
ASVGP_SOLVE(asvgp_solve_upper_t_f32, float, true)

}  // extern "C"
