// The two banded triangular solves, L x = b and L^T x = b, in float64 and
// in float32 for Hopper (sm_90a).
//
// Storage as in banded_adjoint.cu: L is a (K+1, m) lower band, row-major,
//     band[j * m + i] = L[i + j, i],   0 <= j <= K,
// with the right-padding slots (i + j >= m) zero.  The right-hand side b
// and the solution x are (m, r) row-major (x[i * r + c]): r >= 1 columns,
// a vector being r = 1.
//
// Two kernels, one thread per column of b (a serial chain over the m
// rows), compile-time K = 1..6, the K previous (or next) entries of x in
// registers, templated on the scalar type T:
//
//   solve_lower<K, T>    L x = b, rows i = 0..m-1:
//       x_i = (b_i - sum_{p=1..K} L[i, i-p] x_{i-p}) / L[i, i]
//                        double: K13; float: K21
//   solve_upper_t<K, T>  L^T x = b, rows i = m-1..0:
//       x_i = (b_i - sum_{p=1..K} L[i+p, i] x_{i+p}) / L[i, i]
//                        double: K14; float: K22
//
// They replace, in asvgp_tpu/banded/: pallas_ds.py _solve_lower_ds_kernel
// and _solve_upper_t_ds_kernel (float64, carried there as float32 hi/lo
// pairs) and pallas_kernels.py _solve_lower_kernel and
// _solve_upper_t_kernel (float32).  The TPU kernels take one vector; these
// take r columns, so a matrix right-hand side needs no plain loop either.
//
// What bounds them: a serial chain of m steps, each waiting on the latency
// of the one before (K dependent multiply-adds, a subtract and a divide);
// a solve reads (K+1) x m + m x r values and writes m x r, under 1 MB at
// m = 10^4 for a vector, so neither bandwidth nor the arithmetic rate is
// the limit.
//
// What the design does about it: the TPU kernels walk 128-column tiles
// with the window as the loop carry and read the band through shifted
// copies built outside the kernel (G[p-1, i] = L[i, i-p]).  Here the band
// is read in place: the thread loads the next row's K + 1 band entries and
// its b while the current row's chain runs, and keeps the last K entries
// of x in registers.  Every thread of a block reads the same band entries
// (a broadcast) and neighbouring entries of b and x (coalesced).
//
// The order of every operation is spelled out with the round-to-nearest
// intrinsics (__dmul_rn, __dadd_rn, __dsub_rn, __ddiv_rn and their float
// forms): the sum over p in increasing p, no fma contraction, so the
// result is the plain version's recursion rounded step by step.
//
// A zero pivot gives inf or NaN, as the reference recursions do; nothing
// clamps.

#include <cuda_runtime.h>

#include <cstddef>

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
// K13 / K21: solve_lower<K, T>
//
// Rows i = 0..m-1, with the window X[p-1] = x_{i-p} (zero before row 0) and
// g_p = L[i, i-p] = band[p, i-p] (zero for i < p).
// ---------------------------------------------------------------------------
template <int K, typename T>
__global__ void __launch_bounds__(128)
solve_lower_kernel(int m, int r, const T* __restrict__ l,
                   const T* __restrict__ b, T* __restrict__ x) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= r) return;
  const size_t ms = static_cast<size_t>(m);
  const size_t rs = static_cast<size_t>(r);

  T X[K];
#pragma unroll
  for (int p = 0; p < K; ++p) X[p] = T(0);
  // row 0's operands; row 0 has no g
  T gn[K];
#pragma unroll
  for (int p = 0; p < K; ++p) gn[p] = T(0);
  T dn = l[0];
  T bn = b[c];

  for (int i = 0; i < m; ++i) {
    T g[K];
#pragma unroll
    for (int p = 0; p < K; ++p) g[p] = gn[p];
    const T d = dn;
    const T bi = bn;
    const int nx = i + 1;
    if (nx < m) {
#pragma unroll
      for (int p = 1; p <= K; ++p) {
        gn[p - 1] = (nx >= p) ? l[p * ms + (nx - p)] : T(0);
      }
      dn = l[nx];
      bn = b[static_cast<size_t>(nx) * rs + c];
    }

    T acc = mul_rn(g[0], X[0]);
#pragma unroll
    for (int p = 1; p < K; ++p) acc = add_rn(acc, mul_rn(g[p], X[p]));
    const T xi = div_rn(sub_rn(bi, acc), d);
    x[static_cast<size_t>(i) * rs + c] = xi;

#pragma unroll
    for (int p = K - 1; p > 0; --p) X[p] = X[p - 1];
    X[0] = xi;
  }
}

// ---------------------------------------------------------------------------
// K14 / K22: solve_upper_t<K, T>
//
// Rows i = m-1..0, with the window X[p-1] = x_{i+p} (zero beyond row m-1)
// and L[i+p, i] = band[p, i] (a padding slot, zero, for i + p >= m).
// ---------------------------------------------------------------------------
template <int K, typename T>
__global__ void __launch_bounds__(128)
solve_upper_t_kernel(int m, int r, const T* __restrict__ l,
                     const T* __restrict__ b, T* __restrict__ x) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= r) return;
  const size_t ms = static_cast<size_t>(m);
  const size_t rs = static_cast<size_t>(r);

  T X[K];
#pragma unroll
  for (int p = 0; p < K; ++p) X[p] = T(0);
  T ln[K + 1];
#pragma unroll
  for (int p = 0; p <= K; ++p) ln[p] = l[p * ms + (m - 1)];
  T bn = b[static_cast<size_t>(m - 1) * rs + c];

  for (int i = m - 1; i >= 0; --i) {
    T lc[K + 1];
#pragma unroll
    for (int p = 0; p <= K; ++p) lc[p] = ln[p];
    const T bi = bn;
    if (i > 0) {
#pragma unroll
      for (int p = 0; p <= K; ++p) ln[p] = l[p * ms + (i - 1)];
      bn = b[static_cast<size_t>(i - 1) * rs + c];
    }

    T acc = mul_rn(lc[1], X[0]);
#pragma unroll
    for (int p = 2; p <= K; ++p) acc = add_rn(acc, mul_rn(lc[p], X[p - 1]));
    const T xi = div_rn(sub_rn(bi, acc), lc[0]);
    x[static_cast<size_t>(i) * rs + c] = xi;

#pragma unroll
    for (int p = K - 1; p > 0; --p) X[p] = X[p - 1];
    X[0] = xi;
  }
}

// one thread per column of b, in blocks of up to 128
inline unsigned blocks(int r) { return static_cast<unsigned>((r + 127) / 128); }
inline unsigned threads(int r) { return static_cast<unsigned>(r < 128 ? r : 128); }

template <int K, typename T>
cudaError_t launch_solve_lower(int m, int r, const T* l, const T* b, T* x,
                               cudaStream_t st) {
  solve_lower_kernel<K, T><<<blocks(r), threads(r), 0, st>>>(m, r, l, b, x);
  return cudaGetLastError();
}

template <int K, typename T>
cudaError_t launch_solve_upper_t(int m, int r, const T* l, const T* b, T* x,
                                 cudaStream_t st) {
  solve_upper_t_kernel<K, T><<<blocks(r), threads(r), 0, st>>>(m, r, l, b, x);
  return cudaGetLastError();
}

}  // namespace

#define ASVGP_DISPATCH_K(k, call)                               \
  switch (k) {                                                  \
    case 1: { constexpr int K = 1; return static_cast<int>(call); } \
    case 2: { constexpr int K = 2; return static_cast<int>(call); } \
    case 3: { constexpr int K = 3; return static_cast<int>(call); } \
    case 4: { constexpr int K = 4; return static_cast<int>(call); } \
    case 5: { constexpr int K = 5; return static_cast<int>(call); } \
    case 6: { constexpr int K = 6; return static_cast<int>(call); } \
    default: return static_cast<int>(cudaErrorInvalidValue);    \
  }

extern "C" {

// K13 (double) / K21 (float).  l: a (k+1, m) lower band, b: (m, r).
// Writes x = L^-1 b, (m, r).
#define ASVGP_SOLVE(NAME, LAUNCH, T)                                     \
  int NAME(int k, int m, int r, const T* l, const T* b, T* x,            \
           void* stream) {                                               \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                 \
    if (m < 1 || r < 1) return static_cast<int>(cudaErrorInvalidValue);  \
    ASVGP_DISPATCH_K(k, (LAUNCH<K, T>(m, r, l, b, x, st)))               \
  }
ASVGP_SOLVE(asvgp_solve_lower, launch_solve_lower, double)
ASVGP_SOLVE(asvgp_solve_lower_f32, launch_solve_lower, float)

// K14 (double) / K22 (float).  Writes x = L^-T b, (m, r).
ASVGP_SOLVE(asvgp_solve_upper_t, launch_solve_upper_t, double)
ASVGP_SOLVE(asvgp_solve_upper_t_f32, launch_solve_upper_t, float)

}  // extern "C"
