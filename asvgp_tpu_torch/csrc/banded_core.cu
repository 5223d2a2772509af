// The two banded sweeps of the collapsed-ELBO core and the GPR1D posterior,
// in float64 for Hopper (sm_90a).
//
// Storage: a symmetric or lower-triangular banded matrix M of size m with
// lower bandwidth K is its lower band, row-major (K+1, m):
//     band[j * m + i] = M[i + j, i],   0 <= j <= K,
// and slots with i + j >= m ("right padding") are zero.
//
// Both kernels are plain C entry points (no PyTorch headers), compiled with
//     nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//          -Xcompiler -fPIC
// and loaded with ctypes by asvgp_tpu_torch/banded/_build.py.  Each entry
// point launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so that a refused launch reaches the caller.
//
// A pivot d <= 0 gives NaN, as the reference recursions do; nothing clamps.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

// ---------------------------------------------------------------------------
// K1: chol_pair_solve<K>
//
// Replaces asvgp_tpu/banded/pallas_ds_core.py, _chol_pair_solve_kernel
// (sweep A of factor_takahashi_solve_ds).
//
// One forward sweep over the columns i = 0..m-1 computes
//   * the banded Cholesky factors of Kuu and of P,
//       s_j = sum_p L[i, i-p] L[i+j, i-p],  L[i, i] = sqrt(a_0 - s_0),
//       r = 1 / L[i, i],  L[i+j, i] = (a_j - s_j) r,
//     with the rows i + j >= m zeroed;
//   * the lower solve L_P c0 = b on the P stream,
//       c0[i] = (b_i - sum_p L_P[i, i-p] c0[i-p]) r_P;
//   * the reciprocal pivots r of both factors (iv, (2, m)), which K2 uses so
//     that it has no divide at all.
//
// What bounds it: a serial chain of m column steps, each waiting on the
// float64 latency of the previous column (an fma chain of depth K, a sqrt
// and a reciprocal).  The sweep touches (2 (K+1) + 4) m doubles, under 1 MB
// at m = 10^4, so bandwidth is not the limit; the latency of each step is.
//
// What the design does about it: the TPU kernel ran in float32 hi/lo pairs
// with the two matrices interleaved on lanes, in 128-column tiles.  Here
// Hopper's native FP64 computes the float64 function directly.  One thread
// per matrix (threads 0 and 1 of one warp, so both chains issue together
// with no divergence): each keeps its K-column window of L and of c0 in
// registers, fully unrolled for the compile-time K, so a column step is
// pure register arithmetic.  The next column's inputs are loaded one step
// ahead so their memory latency overlaps the current step's chain.  Both
// threads run the solve (the Kuu one on its own factor, discarded), which
// keeps the warp converged; only the P thread stores c0.
// ---------------------------------------------------------------------------
template <int K>
__global__ void __launch_bounds__(32)
chol_pair_solve_kernel(int m, const double* __restrict__ kuu,
                       const double* __restrict__ p,
                       const double* __restrict__ b,
                       double* __restrict__ l_kuu, double* __restrict__ l_p,
                       double* __restrict__ iv, double* __restrict__ c0) {
  const int t = threadIdx.x;
  if (t >= 2) return;
  const double* __restrict__ a = (t == 0) ? kuu : p;
  double* __restrict__ l = (t == 0) ? l_kuu : l_p;
  double* __restrict__ ivt = iv + static_cast<size_t>(t) * m;
  const size_t ms = static_cast<size_t>(m);

  double w[K][K + 1];  // w[p-1][r] = L[i-p+r, i-p]
  double x[K];         // x[p-1] = c0[i-p]
#pragma unroll
  for (int q = 0; q < K; ++q) {
    x[q] = 0.0;
#pragma unroll
    for (int r = 0; r <= K; ++r) w[q][r] = 0.0;
  }

  double an[K + 1];
#pragma unroll
  for (int r = 0; r <= K; ++r) an[r] = a[r * ms];
  double bn = b[0];

  for (int i = 0; i < m; ++i) {
    double ac[K + 1];
#pragma unroll
    for (int r = 0; r <= K; ++r) ac[r] = an[r];
    const double bc = bn;
    if (i + 1 < m) {
#pragma unroll
      for (int r = 0; r <= K; ++r) an[r] = a[r * ms + i + 1];
      bn = b[i + 1];
    }

    double s[K + 1];
#pragma unroll
    for (int j = 0; j <= K; ++j) s[j] = 0.0;
    double sb = 0.0;
#pragma unroll
    for (int q = 1; q <= K; ++q) {
      const double g = w[q - 1][q];  // L[i, i-q]
      sb = fma(g, x[q - 1], sb);
#pragma unroll
      for (int j = 0; j + q <= K; ++j) s[j] = fma(g, w[q - 1][q + j], s[j]);
    }

    const double l0 = sqrt(ac[0] - s[0]);
    const double r = 1.0 / l0;
    double col[K + 1];
    col[0] = l0;
#pragma unroll
    for (int j = 1; j <= K; ++j) {
      // multiply by the mask (not select) so a NaN pivot stays NaN, as in
      // the reference
      col[j] = (ac[j] - s[j]) * r * ((i + j < m) ? 1.0 : 0.0);
    }
    const double xi = (bc - sb) * r;

#pragma unroll
    for (int j = 0; j <= K; ++j) l[j * ms + i] = col[j];
    ivt[i] = r;
    if (t == 1) c0[i] = xi;

#pragma unroll
    for (int q = K - 1; q > 0; --q) {
      x[q] = x[q - 1];
#pragma unroll
      for (int rr = 0; rr <= K; ++rr) w[q][rr] = w[q - 1][rr];
    }
    x[0] = xi;
#pragma unroll
    for (int rr = 0; rr <= K; ++rr) w[0][rr] = col[rr];
  }
}

// ---------------------------------------------------------------------------
// K2: tak_pair_solve<K>
//
// Replaces asvgp_tpu/banded/pallas_ds_core.py, _tak_pair_solve_kernel
// (sweep B of factor_takahashi_solve_ds).
//
// One reverse sweep over the columns j = m-1..0 computes, from K1's factors
// L and reciprocal pivots d = iv,
//   * the Takahashi bands S of Kuu^-1 and P^-1,
//       s_q = -d sum_p S[j+max(p,q), j+min(p,q)] L[j+p, j],   q = 1..K,
//       S[j, j] = d^2 - d sum_q L[j+q, j] s_q,
//     with the rows j + q >= m zeroed;
//   * the upper solve u = P^-1 b on the P stream,
//       u_j = (c0_j - sum_p L_P[j+p, j] u_{j+p}) d_P.
// It has no divide: every 1 / L[j, j] comes from K1.
//
// What bounds it: as K1, a serial chain of m float64 column steps (two fma
// chains of depth K and a few multiplies per column), reading
// (2 (K+1) + 3) m doubles; latency, not bandwidth.
//
// What the design does about it: one thread per matrix in one warp, the
// K-column window of S and of u in registers, fully unrolled for K, the
// next column's L, d and c0 loaded one step ahead.  The TPU kernel's
// double-single pairs, lane interleave, one-hot row masks and tile flips
// are TPU layout work with no counterpart here.
// ---------------------------------------------------------------------------
template <int K>
__global__ void __launch_bounds__(32)
tak_pair_solve_kernel(int m, const double* __restrict__ l_kuu,
                      const double* __restrict__ l_p,
                      const double* __restrict__ iv,
                      const double* __restrict__ c0,
                      double* __restrict__ s_kuu, double* __restrict__ s_p,
                      double* __restrict__ u) {
  const int t = threadIdx.x;
  if (t >= 2) return;
  const double* __restrict__ l = (t == 0) ? l_kuu : l_p;
  double* __restrict__ s_out = (t == 0) ? s_kuu : s_p;
  const double* __restrict__ ivt = iv + static_cast<size_t>(t) * m;
  const size_t ms = static_cast<size_t>(m);

  double cs[K][K + 1];  // cs[p-1][r] = S[j+p+r, j+p]
  double x[K];          // x[p-1] = u[j+p]
#pragma unroll
  for (int q = 0; q < K; ++q) {
    x[q] = 0.0;
#pragma unroll
    for (int r = 0; r <= K; ++r) cs[q][r] = 0.0;
  }

  double ln[K + 1];
#pragma unroll
  for (int r = 0; r <= K; ++r) ln[r] = l[r * ms + (m - 1)];
  double dn = ivt[m - 1];
  double bn = c0[m - 1];

  for (int j = m - 1; j >= 0; --j) {
    double lc[K + 1];
#pragma unroll
    for (int r = 0; r <= K; ++r) lc[r] = ln[r];
    const double d = dn;
    const double bc = bn;
    if (j > 0) {
#pragma unroll
      for (int r = 0; r <= K; ++r) ln[r] = l[r * ms + (j - 1)];
      dn = ivt[j - 1];
      bn = c0[j - 1];
    }

    double sb = 0.0;
#pragma unroll
    for (int q = 1; q <= K; ++q) sb = fma(lc[q], x[q - 1], sb);
    const double uj = (bc - sb) * d;

    double sq[K + 1];
    sq[0] = 0.0;
#pragma unroll
    for (int q = 1; q <= K; ++q) {
      double acc = 0.0;
#pragma unroll
      for (int p = 1; p <= K; ++p) {
        const int lo = (p < q) ? p : q;
        const int df = (p < q) ? (q - p) : (p - q);
        acc = fma(cs[lo - 1][df], lc[p], acc);
      }
      sq[q] = -d * acc;
    }
    double ws = 0.0;
#pragma unroll
    for (int q = 1; q <= K; ++q) ws = fma(lc[q], sq[q], ws);

    double col[K + 1];
    col[0] = d * d - d * ws;
#pragma unroll
    for (int q = 1; q <= K; ++q) col[q] = sq[q] * ((j + q < m) ? 1.0 : 0.0);

#pragma unroll
    for (int r = 0; r <= K; ++r) s_out[r * ms + j] = col[r];
    if (t == 1) u[j] = uj;

#pragma unroll
    for (int q = K - 1; q > 0; --q) {
      x[q] = x[q - 1];
#pragma unroll
      for (int rr = 0; rr <= K; ++rr) cs[q][rr] = cs[q - 1][rr];
    }
    x[0] = uj;
#pragma unroll
    for (int rr = 0; rr <= K; ++rr) cs[0][rr] = col[rr];
  }
}

template <int K>
cudaError_t launch_chol(int m, const double* kuu, const double* p,
                        const double* b, double* l_kuu, double* l_p,
                        double* iv, double* c0, cudaStream_t stream) {
  chol_pair_solve_kernel<K><<<1, 2, 0, stream>>>(m, kuu, p, b, l_kuu, l_p,
                                                 iv, c0);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_tak(int m, const double* l_kuu, const double* l_p,
                       const double* iv, const double* c0, double* s_kuu,
                       double* s_p, double* u, cudaStream_t stream) {
  tak_pair_solve_kernel<K><<<1, 2, 0, stream>>>(m, l_kuu, l_p, iv, c0, s_kuu,
                                                s_p, u);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K1.  kuu, p: (k+1, m) lower bands; b: (m,).  Writes l_kuu, l_p (k+1, m),
// iv (2, m) = reciprocal pivots of [Kuu; P], c0 (m,) = L_P^-1 b.
int asvgp_chol_pair_solve(int k, int m, const double* kuu, const double* p,
                          const double* b, double* l_kuu, double* l_p,
                          double* iv, double* c0, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (k) {
    case 1: return launch_chol<1>(m, kuu, p, b, l_kuu, l_p, iv, c0, s);
    case 2: return launch_chol<2>(m, kuu, p, b, l_kuu, l_p, iv, c0, s);
    case 3: return launch_chol<3>(m, kuu, p, b, l_kuu, l_p, iv, c0, s);
    case 4: return launch_chol<4>(m, kuu, p, b, l_kuu, l_p, iv, c0, s);
    case 5: return launch_chol<5>(m, kuu, p, b, l_kuu, l_p, iv, c0, s);
    case 6: return launch_chol<6>(m, kuu, p, b, l_kuu, l_p, iv, c0, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K2.  l_kuu, l_p: (k+1, m) from K1; iv (2, m) and c0 (m,) from K1.
// Writes s_kuu, s_p (k+1, m) = bands of Kuu^-1 and P^-1, u (m,) = P^-1 b.
int asvgp_tak_pair_solve(int k, int m, const double* l_kuu, const double* l_p,
                         const double* iv, const double* c0, double* s_kuu,
                         double* s_p, double* u, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (k) {
    case 1: return launch_tak<1>(m, l_kuu, l_p, iv, c0, s_kuu, s_p, u, s);
    case 2: return launch_tak<2>(m, l_kuu, l_p, iv, c0, s_kuu, s_p, u, s);
    case 3: return launch_tak<3>(m, l_kuu, l_p, iv, c0, s_kuu, s_p, u, s);
    case 4: return launch_tak<4>(m, l_kuu, l_p, iv, c0, s_kuu, s_p, u, s);
    case 5: return launch_tak<5>(m, l_kuu, l_p, iv, c0, s_kuu, s_p, u, s);
    case 6: return launch_tak<6>(m, l_kuu, l_p, iv, c0, s_kuu, s_p, u, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* asvgp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
