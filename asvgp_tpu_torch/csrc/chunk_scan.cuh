// What the chunk-partitioned recursions of the port share: the entry
// points' dispatch on K, the staging helpers (cp.async), the partition's
// constants, the shared-memory attribute of a pass 2 that stages its
// chunks' data, and the pass 2 of the linear ones, the scan over the
// chunks' affine maps.
//
// A recursion whose carry w (D values) is affine in what it reads, given a
// fixed operand (a Cholesky factor), is cut into chunks of its walk: over
// chunk j the outgoing carry is y_j + H_j w_j, w_j the incoming one.  Pass 1
// builds every chunk's map (H_j: the D homogeneous responses, y_j: the
// particular one), pass 2 (here) walks the maps for the true incoming
// carries, pass 3 reruns the recursion from them.  Used by
// banded_solve.cu (the solves, D = K, one map per column of the right-hand
// side) and banded_adjoint.cu (the Takahashi sweep and the Cholesky and
// Takahashi adjoints, D = K(K+1)/2, one map sequence per matrix of a
// batch) and banded_tan.cu (the twisted Takahashi sweep K6, D = K(K+1):
// the window of S with that of its tangent or of the upper solve, one
// sequence per matrix and stream) and banded_core.cu (the serving
// Takahashi sweep K2, D = K(K+1)/2 + K: the window of S and on P that of
// the upper solve, block-diagonal maps) and banded_tan.cu again (the
// single-ended Takahashi sweep K4, D = K(K+1) as K6's, from a zero carry:
// block lower-triangular maps).  The Cholesky sweeps' chunks are joined
// by a map that is not affine; their pass 2 (schur_walk.cuh) stages its
// chunks' data the same way.

#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>

// In an entry point: return call's error code as an int, with the
// compile-time bandwidth K = k (1..6), or cudaErrorInvalidValue.
#define ASVGP_DISPATCH_K(k, call)                                   \
  switch (k) {                                                      \
    case 1: { constexpr int K = 1; return static_cast<int>(call); } \
    case 2: { constexpr int K = 2; return static_cast<int>(call); } \
    case 3: { constexpr int K = 3; return static_cast<int>(call); } \
    case 4: { constexpr int K = 4; return static_cast<int>(call); } \
    case 5: { constexpr int K = 5; return static_cast<int>(call); } \
    case 6: { constexpr int K = 6; return static_cast<int>(call); } \
    default: return static_cast<int>(cudaErrorInvalidValue);        \
  }

namespace {

constexpr int kTile = 64;         // walk positions of a staged tile
constexpr int kMinChunk = 64;     // positions of a chunk, at least
constexpr long kMaxChunks = 256;  // bounds pass 2's walk
constexpr int kScanCols = 8;      // columns of one CTA of pass 2
// the shared memory one CTA may use on an H100: 227 KB
constexpr size_t kSmemLimit = 232448;

template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
               :: "r"(d), "l"(src), "n"(sizeof(T)) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// the column of walk position u: m-1-u walking down, u walking up
template <bool kDown>
__device__ __forceinline__ int walk_col(int m, int u) {
  return kDown ? m - 1 - u : u;
}

// Stage dst[r][t] = band[r][col] for t < n, col = the column of walk
// position u0 + shift + t (shift positions further along the walk than
// u0 + t), or 0 where col lies outside 0..m-1; ROWS = K+1 for a band, 1
// for a vector.  The caller commits the group.
template <int ROWS, typename T, bool kDown>
__device__ __forceinline__ void stage_cols(T (*dst)[kTile], const T* __restrict__ band, int m,
                                           int u0, int n, int shift) {
  const size_t ms = static_cast<size_t>(m);
  for (int idx = threadIdx.x; idx < ROWS * kTile; idx += 32) {
    const int r = idx / kTile;
    const int t = idx % kTile;
    if (t < n) {
      const int col = walk_col<kDown>(m, u0 + shift + t);
      if (col >= 0 && col < m) {
        cp_async(&dst[r][t], band + r * ms + col);
      } else {
        dst[r][t] = T(0);
      }
    }
  }
}

// Positions per chunk of a walk of n positions whose pass 2 stages ``per``
// doubles a chunk in shared memory (whatever T): at least ``least``, at
// most kMaxChunks chunks and as many as fit, a multiple of the tile; n
// when that is n or more (one chunk).
inline int partition_cols(long per, long least, int n) {
  long cap = static_cast<long>(kSmemLimit / (per * sizeof(double))) + 1;
  if (cap > kMaxChunks) cap = kMaxChunks;
  long lc = (n + cap - 1) / cap;
  if (lc < least) lc = least;
  lc = (lc + kTile - 1) / kTile * kTile;
  return static_cast<int>(lc < n ? lc : n);
}

__device__ __forceinline__ double scan_fma(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float scan_fma(float a, float b, float c) { return __fmaf_rn(a, b, c); }

// Pass 2.  Batch entry blockIdx.y has nmap maps, H at hmap + y·h_stride
// ((nmap, D, D): H[j][p][q] at (j D + p) D + q) and the particular parts of
// its r columns at ymap + y·y_stride ((nmap, r, D)).  One thread per column
// c walks w_{j+1} = y_j + H_j w_j from w_0 = 0 and writes w_{j+1}, the
// incoming carry of chunk j + 1, to win (laid out as ymap).  The maps of
// its columns are staged in shared memory first; any order of rounding
// serves here.  DB < D declares every H block-diagonal with blocks
// 0..DB-1 and DB..D-1: the walk then skips the products of the two
// off-diagonal blocks, which are 0; with kLower, block lower-triangular:
// it skips the upper-right block alone.
template <int D, typename T, int DB = D, bool kLower = false>
__global__ void __launch_bounds__(32)
chunk_scan_kernel(int r, int nmap, const T* __restrict__ hmap, size_t h_stride,
                  const T* __restrict__ ymap, size_t y_stride, T* __restrict__ win) {
  extern __shared__ __align__(16) unsigned char scan_smem[];
  const int ncs = r < kScanCols ? r : kScanCols;     // y columns per staged map
  T* hs = reinterpret_cast<T*>(scan_smem);            // nmap D D
  T* ys = hs + static_cast<size_t>(nmap) * D * D;     // nmap ncs D
  const size_t bat = blockIdx.y;
  hmap += bat * h_stride;
  ymap += bat * y_stride;
  win += bat * y_stride;
  const int lane = threadIdx.x;
  const int c0 = blockIdx.x * kScanCols;
  const int nc = (r - c0 < kScanCols) ? r - c0 : kScanCols;
  const size_t rs = static_cast<size_t>(r);
  for (int idx = lane; idx < nmap * D * D; idx += 32) cp_async(&hs[idx], hmap + idx);
  for (int idx = lane; idx < nmap * nc * D; idx += 32) {
    const int jj = idx / (nc * D);
    const int rem = idx % (nc * D);
    cp_async(&ys[jj * ncs * D + rem], ymap + (jj * rs + c0) * D + rem);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (lane >= nc) return;

  T w[D];
#pragma unroll
  for (int p = 0; p < D; ++p) w[p] = T(0);
  for (int jj = 0; jj < nmap; ++jj) {
    const T* h = hs + jj * D * D;
    const T* y = ys + (jj * ncs + lane) * D;
    T nw[D];
#pragma unroll
    for (int p = 0; p < D; ++p) {
      T a = y[p];
#pragma unroll
      for (int qq = 0; qq < D; ++qq) {
        if (kLower ? (p >= DB || qq < DB) : ((p < DB) == (qq < DB))) {
          a = scan_fma(h[p * D + qq], w[qq], a);
        }
      }
      nw[p] = a;
    }
#pragma unroll
    for (int p = 0; p < D; ++p) {
      w[p] = nw[p];
      win[(jj * rs + c0 + lane) * D + p] = nw[p];
    }
  }
}

template <int D, typename T>
size_t scan_smem_bytes(int nmap, int r) {
  const int ncs = r < kScanCols ? r : kScanCols;
  return static_cast<size_t>(nmap) * (D * D + ncs * D) * sizeof(T);
}

// Lets ``kernel`` take up to kSmemLimit of dynamic shared memory, once per
// device (the attribute holds for the device current when it is set);
// ``done`` holds the devices it is set on, one per kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kSmemLimit));
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return e;
}

// Launches pass 2 over nbatch map sequences of r columns each (DB and
// kLower as for chunk_scan_kernel).
template <int D, typename T, int DB = D, bool kLower = false>
cudaError_t launch_chunk_scan(int r, int nbatch, int nmap, const T* hmap, size_t h_stride,
                              const T* ymap, size_t y_stride, T* win, cudaStream_t st) {
  const size_t smem = scan_smem_bytes<D, T>(nmap, r);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  static std::atomic<unsigned long long> done{0};
  cudaError_t e = allow_smem(chunk_scan_kernel<D, T, DB, kLower>, done);
  if (e != cudaSuccess) return e;
  const dim3 grid((r + kScanCols - 1) / kScanCols, nbatch);
  chunk_scan_kernel<D, T, DB, kLower><<<grid, 32, smem, st>>>(r, nmap, hmap, h_stride, ymap,
                                                              y_stride, win);
  return cudaGetLastError();
}

}  // namespace
