// K24: the window quadratic form of GPRKron's predictive variance in the
// block band of P^-1, in float64 for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package evaluates the same sum with XLA
// gathers and einsums (asvgp_tpu/models/kron.py:448-465), and the port did
// the same in PyTorch (the plain version, banded/block_window.py): one
// gather and one einsum for each of the K (K + 1) / 2 block pairs, each
// writing an (n, T, T) window to device memory and reading it back.  At
// eNATL60's shape (K = 5, T = 5, n = 10^6) that moved about 6 GB a map for
// 3.6 MB of reachable band, and took 85-92 % of the map's device time.
// This kernel exists to take that loop off the device's memory.
//
// For each point i, with K = k1 + 1 block offsets and T trailing weights:
//   out[i] = sum_{d=0..K-1} mult_d sum_{s=0..K-1-d} v1[i][s+d] v1[i][s]
//            * sum_{t,u} vt[i][t] vt[i][u] sp[d][c1[i]+s][rt[i][t]][rt[i][u]]
// mult_0 = 1, mult_{d>0} = 2: the block above the diagonal is the transpose
// of the one below, and a quadratic form does not tell them apart.
// sp is the (K, m1, M2, M2) block-lower storage of P^-1's band
// (banded/block.py), rt the flattened trailing window's indices into M2.
//
// What bounds it: per point K (K + 1) / 2 T^2 loads of distinct band
// entries and as many FMAs (375 of each at K = T = 5).  The entries that
// 10^6 points reach are 3.6 MB and the whole band 40 MB, both within the
// 50 MB L2, so the band costs little device-memory traffic; the least
// time is set by the kernel's own inputs, the windows (3K + 1 words a
// point at T = K: 128 MB at 10^6 points, 0.042 ms at 3.35 TB/s), above
// the FP64 work (795 useful operations a point: 0.012 ms at 67 TFLOP/s).
// What sets the pace beyond that is the rate at which L1 serves the loads.
//
// What the design does about it: one thread a point, nothing written but
// the output.
//   * The K (K + 1) / 2 weights mult v1[s+d] v1[s], the T trailing weights
//     and the T index offsets live in registers (K and T are template
//     parameters; above T = kMaxStaticT, which covers every D = 2 shape, T
//     is a run-time bound and the trailing window is read where it lies,
//     through L1).
//   * Band entries are read straight from L2 through the read-only path.
//     A map's neighbouring points share c1 and nearly all of rt (runs of
//     about 10 points on one cell at eNATL60's shape), so the threads of a
//     warp read the same few cache lines and most loads are L1 hits.  The
//     request is not sorted: the map's own order is the locality, and the
//     kernel's speed assumes spatially ordered requests.  Points in another
//     order (held-out points in data order, a shuffled map) hit L2 rather
//     than L1; chip_smoke.py times K24 both ways on one map's points.
//   * A fixed order of summation and no atomics: two launches give the same
//     bits.  Every product is FP64 (fma), nothing in lower precision.
//   * A window outside the band (c1 + K > m1, or an rt outside 0..M2-1)
//     writes NaN instead of reading outside sp.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kThreads = 128;
// the largest block offset count K = k1 + 1 (the port's MAX_K + 1)
constexpr int kMaxK = 7;
// the largest T held in registers; above it T is a run-time loop bound
constexpr int kMaxStaticT = 7;

// kT > 0: T = kT, the trailing window in registers; kT == 0: T = t_rt.
template <int kK, int kT>
__global__ void __launch_bounds__(kThreads)
block_window_quad_kernel(int n, int m1, int M2, int t_rt, const double* __restrict__ sp,
                         const double* __restrict__ v1, const long long* __restrict__ c1,
                         const double* __restrict__ vt, const long long* __restrict__ rt,
                         double* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int T = (kT > 0) ? kT : t_rt;
  const size_t block = static_cast<size_t>(M2) * M2;
  const double* __restrict__ vti = vt + static_cast<size_t>(i) * T;
  const long long* __restrict__ rti = rt + static_cast<size_t>(i) * T;

  double a[kK];
#pragma unroll
  for (int s = 0; s < kK; ++s) a[s] = __ldg(v1 + static_cast<size_t>(i) * kK + s);
  const long long c = __ldg(c1 + i);
  bool inside = c >= 0 && c + kK <= m1;

  // the trailing window in registers: weights, row offsets and columns
  double w[kT > 0 ? kT : 1];
  long long col[kT > 0 ? kT : 1];
  if constexpr (kT > 0) {
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      w[t] = __ldg(vti + t);
      col[t] = __ldg(rti + t);
      inside = inside && col[t] >= 0 && col[t] < M2;
    }
  } else {
    for (int t = 0; t < T; ++t) {
      const long long r = __ldg(rti + t);
      inside = inside && r >= 0 && r < M2;
    }
  }
  if (!inside) {
    out[i] = NAN;
    return;
  }

  double total = 0.0;
#pragma unroll
  for (int d = 0; d < kK; ++d) {
#pragma unroll
    for (int s = 0; s + d < kK; ++s) {
      const double* __restrict__ b = sp + (static_cast<size_t>(d) * m1 + c + s) * block;
      double q = 0.0;
      if constexpr (kT > 0) {
#pragma unroll
        for (int t = 0; t < kT; ++t) {
          const double* __restrict__ row = b + col[t] * M2;
          double r = 0.0;
#pragma unroll
          for (int u = 0; u < kT; ++u) r = fma(w[u], __ldg(row + col[u]), r);
          q = fma(w[t], r, q);
        }
      } else {
        for (int t = 0; t < T; ++t) {
          const double* __restrict__ row = b + __ldg(rti + t) * M2;
          double r = 0.0;
          for (int u = 0; u < T; ++u) r = fma(__ldg(vti + u), __ldg(row + __ldg(rti + u)), r);
          q = fma(__ldg(vti + t), r, q);
        }
      }
      const double weight = (d == 0 ? 1.0 : 2.0) * a[s + d] * a[s];
      total = fma(weight, q, total);
    }
  }
  out[i] = total;
}

template <int kK, int kT>
cudaError_t launch(int n, int m1, int M2, int T, const double* sp, const double* v1,
                   const long long* c1, const double* vt, const long long* rt, double* out,
                   cudaStream_t st) {
  const int blocks = (n + kThreads - 1) / kThreads;
  block_window_quad_kernel<kK, kT><<<blocks, kThreads, 0, st>>>(n, m1, M2, T, sp, v1, c1, vt,
                                                                rt, out);
  return cudaGetLastError();
}

template <int kK>
cudaError_t dispatch_t(int n, int m1, int M2, int T, const double* sp, const double* v1,
                       const long long* c1, const double* vt, const long long* rt, double* out,
                       cudaStream_t st) {
  switch (T) {
    case 1: return launch<kK, 1>(n, m1, M2, T, sp, v1, c1, vt, rt, out, st);
    case 2: return launch<kK, 2>(n, m1, M2, T, sp, v1, c1, vt, rt, out, st);
    case 3: return launch<kK, 3>(n, m1, M2, T, sp, v1, c1, vt, rt, out, st);
    case 4: return launch<kK, 4>(n, m1, M2, T, sp, v1, c1, vt, rt, out, st);
    case 5: return launch<kK, 5>(n, m1, M2, T, sp, v1, c1, vt, rt, out, st);
    case 6: return launch<kK, 6>(n, m1, M2, T, sp, v1, c1, vt, rt, out, st);
    case 7: return launch<kK, 7>(n, m1, M2, T, sp, v1, c1, vt, rt, out, st);
    default: return launch<kK, 0>(n, m1, M2, T, sp, v1, c1, vt, rt, out, st);
  }
}

static_assert(kMaxStaticT == 7, "dispatch_t names T = 1..kMaxStaticT");

}  // namespace

extern "C" {

// K24.  sp: (K, m1, M2, M2) float64; v1: (n, K) float64; c1: (n,) int64;
// vt: (n, T) float64; rt: (n, T) int64; out: (n,) float64.  Launches one
// kernel on `stream` (none when n = 0).
int asvgp_block_window_quad(int K, int T, int n, int m1, int M2, const double* sp,
                            const double* v1, const long long* c1, const double* vt,
                            const long long* rt, double* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K < 1 || K > kMaxK || T < 1 || n < 0 || m1 < K || M2 < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  switch (K) {
    case 1: return static_cast<int>(dispatch_t<1>(n, m1, M2, T, sp, v1, c1, vt, rt, out, st));
    case 2: return static_cast<int>(dispatch_t<2>(n, m1, M2, T, sp, v1, c1, vt, rt, out, st));
    case 3: return static_cast<int>(dispatch_t<3>(n, m1, M2, T, sp, v1, c1, vt, rt, out, st));
    case 4: return static_cast<int>(dispatch_t<4>(n, m1, M2, T, sp, v1, c1, vt, rt, out, st));
    case 5: return static_cast<int>(dispatch_t<5>(n, m1, M2, T, sp, v1, c1, vt, rt, out, st));
    case 6: return static_cast<int>(dispatch_t<6>(n, m1, M2, T, sp, v1, c1, vt, rt, out, st));
    default: return static_cast<int>(dispatch_t<7>(n, m1, M2, T, sp, v1, c1, vt, rt, out, st));
  }
}

}  // extern "C"
