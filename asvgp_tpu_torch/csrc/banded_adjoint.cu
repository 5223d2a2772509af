// The single-matrix banded Cholesky and Takahashi sweeps and their
// reverse-mode adjoints, in float64 and in float32 for Hopper (sm_90a).
//
// Storage as in banded_core.cu: a (K+1, m) lower band, row-major,
//     band[j * m + i] = M[i + j, i],   0 <= j <= K,
// with the right-padding slots (i + j >= m) zero.  A batch of nb bands is
// nb such blocks back to back.
//
// Four kernels, each one thread per matrix of the batch (a serial chain
// over the m columns), compile-time K = 1..6, the K-column window in
// registers, templated on the scalar type T:
//
//   chol_fwd<K, T>  L = chol(A)               double: K9 (K15 is its batch
//                                             of two); float: K17
//   chol_bwd<K, T>  A-bar from (L, L-bar)     double: K10, and K8 (batch of
//                                             one); float: K18
//   tak_fwd<K, T>   S = band of A^-1 from L   double: K11; float: K19
//   tak_bwd<K, T>   L-bar from (L, S, S-bar)  double: K12 (divides by
//                                             L[j, j]), and K7 (reads
//                                             1/L[j, j] from iv); float: K20
//
// They replace, in asvgp_tpu/banded/: pallas_ds.py _chol_fwd_ds_kernel,
// _chol_bwd_ds_kernel, _takahashi_fwd_ds_kernel, _takahashi_bwd_ds_kernel;
// pallas_ds_pair.py _chol_bwd_pair_kernel (K8, whose second matrix the
// collapsed core leaves dead); pallas_ds_core.py _tak_bwd_vec_kernel (K7);
// and the float32 kernels of pallas_kernels.py: _chol_fwd_kernel,
// _chol_bwd_kernel, _takahashi_fwd_kernel, _takahashi_bwd_kernel (the
// float32 models on an accelerator).
//
// What bounds them: a serial chain of m column steps, each waiting on the
// latency of the step before (fma chains of depth K, a sqrt or a
// reciprocal).  Each sweep reads and writes a few (K+1) x m bands, under
// 1 MB at m = 10^4, so neither bandwidth nor the arithmetic rate is the
// limit.
//
// What the design does about it: the TPU kernels carry float32 hi/lo pairs
// (or plain float32) in 128-column tiles, read the neighbouring tile for
// the window (_prev_tiles, _next_tiles), build columns from one-hot row
// masks and rolls.  None of that carries over.  Each kernel is the
// recursion of asvgp_tpu_torch/banded/ops.py (cholesky_band_plain,
// takahashi_inverse_band_plain, cholesky_band_bwd_plain,
// takahashi_bwd_plain) in the native type, fully unrolled for K, with the
// window of neighbouring columns and the carried adjoint columns in
// registers.  A column step is register arithmetic plus the loads of one
// new column.  The float instantiation is the same code: only the type of
// every value, constant and intrinsic changes.
//
// A pivot d <= 0 gives NaN, as the reference recursions do; nothing clamps.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

// the scalar type's fused multiply-add and square root (IEEE-rounded: the
// library is built without fast math), so a float instantiation never
// promotes to double
__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float sqrt_t(float a) { return sqrtf(a); }
__device__ __forceinline__ double sqrt_t(double a) { return sqrt(a); }

// ---------------------------------------------------------------------------
// K9 / K17: chol_fwd<K, T>
//
// Columns i = 0..m-1, with the window w[p-1][r] = L[i-p+r, i-p]:
//   s_j = sum_p L[i, i-p] L[i+j, i-p],  L[i, i] = sqrt(a_0 - s_0),
//   L[i+j, i] = (a_j - s_j) / L[i, i],  rows i + j >= m zeroed
// (the right-padding mask of the TPU kernel's _col_mask).
// ---------------------------------------------------------------------------
template <int K, typename T>
__global__ void __launch_bounds__(32)
chol_fwd_kernel(int nb, int m, const T* __restrict__ a_all,
                T* __restrict__ l_all) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nb) return;
  const size_t ms = static_cast<size_t>(m);
  const T* __restrict__ a = a_all + static_cast<size_t>(t) * (K + 1) * ms;
  T* __restrict__ l = l_all + static_cast<size_t>(t) * (K + 1) * ms;

  T w[K][K + 1];
#pragma unroll
  for (int q = 0; q < K; ++q) {
#pragma unroll
    for (int r = 0; r <= K; ++r) w[q][r] = T(0);
  }
  T an[K + 1];
#pragma unroll
  for (int r = 0; r <= K; ++r) an[r] = a[r * ms];

  for (int i = 0; i < m; ++i) {
    T ac[K + 1];
#pragma unroll
    for (int r = 0; r <= K; ++r) ac[r] = an[r];
    if (i + 1 < m) {
#pragma unroll
      for (int r = 0; r <= K; ++r) an[r] = a[r * ms + i + 1];
    }

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
    T col[K + 1];
    col[0] = l0;
#pragma unroll
    for (int j = 1; j <= K; ++j) {
      // multiply by the mask (not select) so a NaN pivot stays NaN
      col[j] = (ac[j] - s[j]) * rv * ((i + j < m) ? T(1) : T(0));
    }
#pragma unroll
    for (int j = 0; j <= K; ++j) l[j * ms + i] = col[j];

#pragma unroll
    for (int q = K - 1; q > 0; --q) {
#pragma unroll
      for (int r = 0; r <= K; ++r) w[q][r] = w[q - 1][r];
    }
#pragma unroll
    for (int r = 0; r <= K; ++r) w[0][r] = col[r];
  }
}

// ---------------------------------------------------------------------------
// K10 / K8 / K18: chol_bwd<K, T>
//
// The adjoint of chol_fwd, columns i = m-1..0.  P[q][r] carries the
// adjoint that the later columns sent to column i-q (row r of its band);
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
__global__ void __launch_bounds__(32)
chol_bwd_kernel(int nb, int m, const T* __restrict__ l_all,
                const T* __restrict__ cot_all,
                T* __restrict__ abar_all) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nb) return;
  const size_t ms = static_cast<size_t>(m);
  const size_t off = static_cast<size_t>(t) * (K + 1) * ms;
  const T* __restrict__ l = l_all + off;
  const T* __restrict__ cot = cot_all + off;
  T* __restrict__ abar = abar_all + off;

  T P[K][K + 1];
  T w[K][K + 1];
  T lc[K + 1];
#pragma unroll
  for (int r = 0; r <= K; ++r) lc[r] = l[r * ms + (m - 1)];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int col = m - 2 - q;
#pragma unroll
    for (int r = 0; r <= K; ++r) {
      P[q][r] = T(0);
      w[q][r] = (col >= 0) ? l[r * ms + col] : T(0);
    }
  }

  for (int i = m - 1; i >= 0; --i) {
    T lb[K + 1];
#pragma unroll
    for (int r = 0; r <= K; ++r) {
      lb[r] = (cot[r * ms + i] + P[0][r]) * ((i + r < m) ? T(1) : T(0));
    }
    const T iv = T(1) / lc[0];
    T t1 = T(0);
#pragma unroll
    for (int r = 1; r <= K; ++r) t1 = fma_t(lb[r], lc[r], t1);
    T ab[K + 1];
    ab[0] = (lb[0] - t1 * iv) * (T(0.5) * iv);
#pragma unroll
    for (int r = 1; r <= K; ++r) ab[r] = lb[r] * iv;
#pragma unroll
    for (int r = 0; r <= K; ++r) abar[r * ms + i] = ab[r];

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

    // the window of column i-1: L columns i-2 .. i-1-K
#pragma unroll
    for (int r = 0; r <= K; ++r) lc[r] = w[0][r];
#pragma unroll
    for (int q = 0; q < K - 1; ++q) {
#pragma unroll
      for (int r = 0; r <= K; ++r) w[q][r] = w[q + 1][r];
    }
    const int nxt = i - 1 - K;
#pragma unroll
    for (int r = 0; r <= K; ++r) w[K - 1][r] = (nxt >= 0) ? l[r * ms + nxt] : T(0);
  }
}

// ---------------------------------------------------------------------------
// K11 / K19: tak_fwd<K, T>
//
// Columns j = m-1..0, with d = 1 / L[j, j] and the window cs[p-1][r] =
// S[j+p+r, j+p] of the columns already done:
//   s_q = -d sum_p S[j+max(p,q), j+min(p,q)] L[j+p, j],   q = 1..K,
//   S[j, j] = d^2 - d sum_q L[j+q, j] s_q,  rows j + q >= m zeroed.
// K2's reverse sweep without the solve, dividing for d itself.
// ---------------------------------------------------------------------------
template <int K, typename T>
__global__ void __launch_bounds__(32)
tak_fwd_kernel(int nb, int m, const T* __restrict__ l_all,
               T* __restrict__ s_all) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nb) return;
  const size_t ms = static_cast<size_t>(m);
  const size_t off = static_cast<size_t>(t) * (K + 1) * ms;
  const T* __restrict__ l = l_all + off;
  T* __restrict__ s_out = s_all + off;

  T cs[K][K + 1];
#pragma unroll
  for (int q = 0; q < K; ++q) {
#pragma unroll
    for (int r = 0; r <= K; ++r) cs[q][r] = T(0);
  }
  T ln[K + 1];
#pragma unroll
  for (int r = 0; r <= K; ++r) ln[r] = l[r * ms + (m - 1)];

  for (int j = m - 1; j >= 0; --j) {
    T lc[K + 1];
#pragma unroll
    for (int r = 0; r <= K; ++r) lc[r] = ln[r];
    if (j > 0) {
#pragma unroll
      for (int r = 0; r <= K; ++r) ln[r] = l[r * ms + (j - 1)];
    }
    const T d = T(1) / lc[0];

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

    T col[K + 1];
    col[0] = d * d - d * ws;
#pragma unroll
    for (int q = 1; q <= K; ++q) col[q] = sq[q] * ((j + q < m) ? T(1) : T(0));
#pragma unroll
    for (int r = 0; r <= K; ++r) s_out[r * ms + j] = col[r];

#pragma unroll
    for (int q = K - 1; q > 0; --q) {
#pragma unroll
      for (int rr = 0; rr <= K; ++rr) cs[q][rr] = cs[q - 1][rr];
    }
#pragma unroll
    for (int rr = 0; rr <= K; ++rr) cs[0][rr] = col[rr];
  }
}

// ---------------------------------------------------------------------------
// K12 / K7 / K20: tak_bwd<K, T>
//
// The adjoint of tak_fwd, columns j = 0..m-1.  Q[c][r] carries the adjoint
// sent to S column j+1+c; cs[c][r] = S[j+1+c+r, j+1+c] is the window the
// forward step read (the TPU kernel's _next_tiles), zero beyond column
// m-1.  Per column, with cb = (cot + Q[0]) * mask, d = 1 / L[j, j] (K12)
// or iv[j] (K7), w_q = L[j+q, j], s_q = S[j+q, j], t_q = -s_q L[j, j],
// M[q][p] = cs[min(p,q)-1][|q-p|] and m1 = d cb_0:
//   d-bar = 2 m1 - cb_0 sum_q w_q s_q - sum_q sb_q t_q,  sb_q = cb_q - m1 w_q,
//   tb_q = -d sb_q,  w-bar_p = -m1 s_p + sum_q tb_q M[q][p],
//   L-bar[j, j] = -d-bar d^2,  Q[min(p,q)-1][|q-p|] += tb_q w_p
// (Q shifted by one column first).  "The adjoint shares the forward's
// instability" (pallas_ds.py): at a high condition number of A it
// amplifies rounding as the forward recursion does.
// ---------------------------------------------------------------------------
template <int K, typename T>
__global__ void __launch_bounds__(32)
tak_bwd_kernel(int nb, int m, const T* __restrict__ l_all,
               const T* __restrict__ s_all,
               const T* __restrict__ cot_all,
               const T* __restrict__ iv_all,
               T* __restrict__ lbar_all) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nb) return;
  const size_t ms = static_cast<size_t>(m);
  const size_t off = static_cast<size_t>(t) * (K + 1) * ms;
  const T* __restrict__ l = l_all + off;
  const T* __restrict__ s = s_all + off;
  const T* __restrict__ cot = cot_all + off;
  const T* __restrict__ iv =
      (iv_all != nullptr) ? iv_all + static_cast<size_t>(t) * ms : nullptr;
  T* __restrict__ lbar = lbar_all + off;

  T Q[K][K + 1];
  T cs[K][K + 1];
  T sc[K + 1];
#pragma unroll
  for (int r = 0; r <= K; ++r) sc[r] = s[r * ms];
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const int col = 1 + c;
#pragma unroll
    for (int r = 0; r <= K; ++r) {
      Q[c][r] = T(0);
      cs[c][r] = (col < m) ? s[r * ms + col] : T(0);
    }
  }

  for (int j = 0; j < m; ++j) {
    T lc[K + 1];
    T cb[K + 1];
#pragma unroll
    for (int r = 0; r <= K; ++r) {
      lc[r] = l[r * ms + j];
      cb[r] = (cot[r * ms + j] + Q[0][r]) * ((j + r < m) ? T(1) : T(0));
    }
    const T l0 = lc[0];
    const T d = (iv != nullptr) ? iv[j] : T(1) / l0;
    const T m1 = d * cb[0];

    T ws = T(0);
#pragma unroll
    for (int q = 1; q <= K; ++q) ws = fma_t(lc[q], sc[q], ws);
    T db = T(2) * m1 - ws * cb[0];
    T tb[K + 1];
    T wb[K + 1];
#pragma unroll
    for (int q = 1; q <= K; ++q) {
      const T sb = cb[q] - m1 * lc[q];
      db -= sb * (-sc[q] * l0);
      tb[q] = -d * sb;
      wb[q] = -m1 * sc[q];
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
        wb[p] = fma_t(tb[q], cs[lo - 1][df], wb[p]);
        Q[lo - 1][df] = fma_t(tb[q], lc[p], Q[lo - 1][df]);
      }
    }

    lbar[j] = -db * d * d;
#pragma unroll
    for (int q = 1; q <= K; ++q) lbar[q * ms + j] = wb[q];

    // the window of column j+1: S columns j+2 .. j+1+K
#pragma unroll
    for (int r = 0; r <= K; ++r) sc[r] = cs[0][r];
#pragma unroll
    for (int c = 0; c < K - 1; ++c) {
#pragma unroll
      for (int r = 0; r <= K; ++r) cs[c][r] = cs[c + 1][r];
    }
    const int nxt = j + 1 + K;
#pragma unroll
    for (int r = 0; r <= K; ++r) cs[K - 1][r] = (nxt < m) ? s[r * ms + nxt] : T(0);
  }
}

// one thread per matrix, in blocks of 32
inline unsigned blocks(int nb) { return static_cast<unsigned>((nb + 31) / 32); }
inline unsigned threads(int nb) { return static_cast<unsigned>(nb < 32 ? nb : 32); }

template <int K, typename T>
cudaError_t launch_chol_fwd(int m, int nb, const T* a, T* l,
                            cudaStream_t st) {
  chol_fwd_kernel<K, T><<<blocks(nb), threads(nb), 0, st>>>(nb, m, a, l);
  return cudaGetLastError();
}

template <int K, typename T>
cudaError_t launch_chol_bwd(int m, int nb, const T* l, const T* cot,
                            T* abar, cudaStream_t st) {
  chol_bwd_kernel<K, T><<<blocks(nb), threads(nb), 0, st>>>(nb, m, l, cot, abar);
  return cudaGetLastError();
}

template <int K, typename T>
cudaError_t launch_tak_fwd(int m, int nb, const T* l, T* s,
                           cudaStream_t st) {
  tak_fwd_kernel<K, T><<<blocks(nb), threads(nb), 0, st>>>(nb, m, l, s);
  return cudaGetLastError();
}

template <int K, typename T>
cudaError_t launch_tak_bwd(int m, int nb, const T* l, const T* s,
                           const T* cot, const T* iv, T* lbar,
                           cudaStream_t st) {
  tak_bwd_kernel<K, T><<<blocks(nb), threads(nb), 0, st>>>(nb, m, l, s, cot, iv,
                                                        lbar);
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

// K9 (double) / K17 (float).  a: nb (k+1, m) lower bands.  Writes l: their
// Cholesky bands.
#define ASVGP_CHOL_FWD(NAME, T)                                          \
  int NAME(int k, int m, int nb, const T* a, T* l, void* stream) {       \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                 \
    if (m < 1 || nb < 1) return static_cast<int>(cudaErrorInvalidValue); \
    ASVGP_DISPATCH_K(k, (launch_chol_fwd<K, T>(m, nb, a, l, st)))        \
  }
ASVGP_CHOL_FWD(asvgp_chol_fwd, double)
ASVGP_CHOL_FWD(asvgp_chol_fwd_f32, float)

// K10 / K8 (double) / K18 (float).  l: nb Cholesky bands, cot: their
// cotangents.  Writes abar.
#define ASVGP_CHOL_BWD(NAME, T)                                          \
  int NAME(int k, int m, int nb, const T* l, const T* cot, T* abar,      \
           void* stream) {                                               \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                 \
    if (m < 1 || nb < 1) return static_cast<int>(cudaErrorInvalidValue); \
    ASVGP_DISPATCH_K(k, (launch_chol_bwd<K, T>(m, nb, l, cot, abar, st))) \
  }
ASVGP_CHOL_BWD(asvgp_chol_bwd, double)
ASVGP_CHOL_BWD(asvgp_chol_bwd_f32, float)

// K11 (double) / K19 (float).  l: nb Cholesky bands.  Writes s: the bands
// of their inverses.
#define ASVGP_TAK_FWD(NAME, T)                                           \
  int NAME(int k, int m, int nb, const T* l, T* s, void* stream) {       \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                 \
    if (m < 1 || nb < 1) return static_cast<int>(cudaErrorInvalidValue); \
    ASVGP_DISPATCH_K(k, (launch_tak_fwd<K, T>(m, nb, l, s, st)))         \
  }
ASVGP_TAK_FWD(asvgp_tak_fwd, double)
ASVGP_TAK_FWD(asvgp_tak_fwd_f32, float)

// K12 (iv == NULL) / K7 (iv: nb (m,) reciprocal pivots of l), double; K20
// (iv == NULL), float.  l, s, cot: nb bands of the factor, its Takahashi
// band and that band's cotangent.  Writes lbar.
#define ASVGP_TAK_BWD(NAME, T)                                           \
  int NAME(int k, int m, int nb, const T* l, const T* s, const T* cot,   \
           const T* iv, T* lbar, void* stream) {                         \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                 \
    if (m < 1 || nb < 1) return static_cast<int>(cudaErrorInvalidValue); \
    ASVGP_DISPATCH_K(k, (launch_tak_bwd<K, T>(m, nb, l, s, cot, iv, lbar, st))) \
  }
ASVGP_TAK_BWD(asvgp_tak_bwd, double)
ASVGP_TAK_BWD(asvgp_tak_bwd_f32, float)

}  // extern "C"
