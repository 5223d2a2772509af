// The two banded sweeps of the collapsed-ELBO core and the GPR1D posterior,
// in float64 for Hopper (sm_90a), each chunk-partitioned on two matrices.
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
// point launches on the caller's stream, allocates nothing (its scratch is
// the caller's, asvgp_core_workspace(k, m) doubles), and returns
// cudaGetLastError() so that a refused launch reaches the caller.
//
// What bounds both: each matrix is a serial chain of m column steps, each
// waiting on the float64 latency of the one before (fma chains of depth K,
// and in the Cholesky a sqrt and a reciprocal).  A sweep touches
// (2 (K+1) + 4) m doubles, under 1 MB at m = 10^4, so bandwidth is not the
// limit; the chain's length is.  One thread a matrix (one block of two
// threads, 131 SMs idle) took about 0.18 us a column.
//
// What the design does about it: each chain is cut into chunks run in
// parallel, on grid (chunks, 2), one role a block (blockIdx.y: 0 Kuu, 1 P),
// three launches each (one pass when m fits in one chunk), with the passes
// of forward_sweeps.cuh that K9 and K11 run:
//   K1 is K9's Schur partition (chol_fwd), and on P it carries the lower
//      solve's coupling beta beside W, as K5's P role does;
//   K2 is K11's affine partition (tak_fwd) with d taken from K1's
//      reciprocal pivots, and on P it carries the upper solve's K-window
//      beside the window of S.
// Each matrix's first chunk on the walk starts from nothing, so it is the
// one-chain recursion bit for bit.  The TPU kernels' float32 hi/lo pairs,
// lane interleave, 128-column tiles and one-hot row masks are TPU layout
// work with no counterpart here.
//
// A pivot d <= 0 gives NaN, as the reference recursions do; nothing clamps.

#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>

#include "chunk_scan.cuh"
#include "forward_sweeps.cuh"

namespace {

// K1's triple of a chunk: (U, Q, R) and P's p0, r0 (Kuu leaves the last 2K
// unused).  The carry of either sweep, D + K values: K1's W packed as R,
// then P's beta; K2's window of S, then P's window of u (Kuu's last K stay
// 0).
template <int K>
constexpr int kPairTri = K * K + K * (K + 1) + 2 * K;
template <int K>
constexpr int kPairCarry = K * (K + 1) / 2 + K;

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
//   * the reciprocal pivots r of both factors (iv, (2, m)), which K2 and
//     the Takahashi adjoints K7 and K23 read, so that they divide by
//     nothing.
//
// Three launches when m spans more than one chunk (core_chol_cols):
//   1. triples (chol_pair_chunk_kernel<K, true>), grid (chunks but the
//      last, 2): each chunk's recursion from W = 0 with V = L_c^-1 E along
//      it; P also runs the chunk's own solve y0 for p0 = V^T y0 and
//      r0 = X y0_last.
//   2. walk (chol_pair_walk_kernel), one thread per matrix: every chunk's
//      incoming W (Kuu: schur_step<K, double>) or W and beta (P:
//      schur_step<K, double, true>).
//   3. factor (chol_pair_chunk_kernel<K, false>), grid (chunks, 2): W off
//      the staged first K rows of A_c, beta off the first K entries of b_c
//      (P), the column step from a zero window; L, iv and c0 written.
// The column step is the one-chain kernel's: sqrt, then r = 1.0 / l0, then
// the products, so chunk 0 is that kernel bit for bit and iv is the exact
// reciprocal of each pivot.  A failing pivot gives NaN from its column on:
// in its chunk by the recursion, in every later chunk through
// F = chol(I - U^T W U) in the walk.
// ---------------------------------------------------------------------------
template <int K, bool kMaps>
__global__ void __launch_bounds__(32)
chol_pair_chunk_kernel(int m, int lc, int nmap, const double* __restrict__ kuu,
                       const double* __restrict__ p, const double* __restrict__ b,
                       double* __restrict__ l_kuu, double* __restrict__ l_p,
                       double* __restrict__ iv, double* __restrict__ c0,
                       const double* __restrict__ win, double* __restrict__ tri) {
  const int j0 = blockIdx.x;
  const size_t slot = static_cast<size_t>(blockIdx.y) * nmap + j0;
  const double* wc = (!kMaps && j0 > 0) ? win + (slot - 1) * kPairCarry<K> : nullptr;
  double* tc = kMaps ? tri + slot * kPairTri<K> : nullptr;
  if (blockIdx.y == 0) {
    chol_fwd_chunk<K, double, kMaps, false>(m, lc, j0, kuu, nullptr, l_kuu, iv, nullptr, wc, tc);
  } else {
    chol_fwd_chunk<K, double, kMaps, true>(m, lc, j0, p, b, l_p, iv + m, c0, wc, tc);
  }
}

template <int K>
__global__ void __launch_bounds__(32)
chol_pair_walk_kernel(int nmap, const double* __restrict__ tri, double* __restrict__ win) {
  extern __shared__ __align__(16) unsigned char pair_walk_smem[];
  double* ts = reinterpret_cast<double*>(pair_walk_smem);
  const size_t role = blockIdx.y;
  tri += role * nmap * kPairTri<K>;
  win += role * nmap * kPairCarry<K>;
  if (role == 0) {
    schur_walk<K, double, false>(nmap, tri, kPairTri<K>, win, kPairCarry<K>, ts);
  } else {
    schur_walk<K, double, true>(nmap, tri, kPairTri<K>, win, kPairCarry<K>, ts);
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
// Given L and d, what either matrix carries is affine: the D = K(K+1)/2
// read entries of the window of S, and on P also the solve's K-window,
// which does not couple to S.  So both roles carry DD = D + K values (Kuu's
// last K stay 0) and their maps are block-diagonal, diag(H_S, H_u); the
// scan skips the zero blocks.  Three launches when m spans more than one
// chunk (core_tak_cols, 64 columns at K = 3):
//   1. maps (tak_pair_chunk_kernel<K, true>), grid (chunks but the last,
//      2): lanes q < DD from the carry e_q, lane DD from 0 with the d^2 and
//      c0 terms; tak_fwd_chunk with d staged from iv.
//   2. scan (chunk_scan_kernel<DD, double, D>), one thread per matrix.
//   3. outputs (tak_pair_chunk_kernel<K, false>), grid (chunks, 2): lane 0
//      from the true incoming carry; S and u written.
// Chunk 0 (the last columns) starts from the zero carry: the one-chain
// kernel bit for bit.
// ---------------------------------------------------------------------------
template <int K, bool kMaps>
__global__ void __launch_bounds__(32)
tak_pair_chunk_kernel(int m, int lc, int nmap, const double* __restrict__ l_kuu,
                      const double* __restrict__ l_p, const double* __restrict__ iv,
                      const double* __restrict__ c0, double* __restrict__ s_kuu,
                      double* __restrict__ s_p, double* __restrict__ u,
                      const double* __restrict__ win, double* __restrict__ hmap,
                      double* __restrict__ ymap, const int* __restrict__ rule) {
  constexpr int DD = kPairCarry<K>;
  const int j0 = blockIdx.x;
  lc = rule_cols(rule, lc);
  if (j0 >= (m + lc - 1) / lc - (kMaps ? 1 : 0)) return;
  const size_t slot = static_cast<size_t>(blockIdx.y) * nmap + j0;
  const double* wc = (!kMaps && j0 > 0) ? win + (slot - 1) * DD : nullptr;
  double* hm = kMaps ? hmap + slot * DD * DD : nullptr;
  double* ym = kMaps ? ymap + slot * DD : nullptr;
  if (blockIdx.y == 0) {
    tak_fwd_chunk<K, double, kMaps, true, false, DD>(m, lc, j0, l_kuu, iv, nullptr, s_kuu,
                                                     nullptr, wc, hm, ym);
  } else {
    tak_fwd_chunk<K, double, kMaps, true, true, DD>(m, lc, j0, l_p, iv + m, c0, s_p, u, wc,
                                                    hm, ym);
  }
}

// Columns per chunk of K1: as schur_chunk_cols (at least ASVGP_SCHUR_CHUNK,
// 128: 79 chunks at m = 10^4), for a walk that stages kPairTri doubles a
// chunk.
int core_chol_cols(int k, int m) {
  return partition_cols(static_cast<long>(k) * k + static_cast<long>(k) * (k + 1) + 2 * k,
                        ASVGP_SCHUR_CHUNK, m);
}

// Columns per chunk of K2's partition: at least kMinChunk (64), as many as
// the scan can stage maps of DD^2 + DD doubles: at m = 10^4, 64 columns for
// k <= 3, 128 at k = 4, 192 at k = 5, 320 at k = 6.  The shortest length
// K2's rule (core_tak_rule) may choose.
int core_tak_cols(int k, int m) {
  const long dd = static_cast<long>(k) * (k + 1) / 2 + k;
  return partition_cols(dd * dd + dd, kMinChunk, m);
}

// Doubles of workspace K1 or K2 needs (the larger): K1's triples (2, P-1,
// kPairTri) and walked carries (2, P-1, kPairCarry); K2's maps H (2, P-1,
// DD^2), y and incoming carries (2, P-1, DD) each; then one for K2's chunk
// length; 0 when m is one chunk.
size_t core_workspace(int k, int m) {
  const size_t dd = static_cast<size_t>(k) * (k + 1) / 2 + k;
  const size_t tri = static_cast<size_t>(k) * k + static_cast<size_t>(k) * (k + 1) + 2 * k;
  const int lc1 = core_chol_cols(k, m);
  const int lc2 = core_tak_cols(k, m);
  const size_t n1 = static_cast<size_t>((m + lc1 - 1) / lc1 - 1);
  const size_t n2 = static_cast<size_t>((m + lc2 - 1) / lc2 - 1);
  const size_t w1 = 2 * n1 * (tri + dd);
  const size_t w2 = 2 * n2 * (dd * dd + 2 * dd);
  const size_t w = w1 > w2 ? w1 : w2;
  return w > 0 ? w + 1 : 0;
}

// K2's chunk length, in its workspace: the rule of the linear sweeps
// (forward_sweeps.cuh) over both factors, when m spans more than one of
// core_tak_cols's chunks; null otherwise.
template <int K>
const int* core_tak_rule(int m, const double* l_kuu, const double* l_p, double* ws,
                         cudaStream_t st, cudaError_t* e) {
  *e = cudaSuccess;
  const int lc = core_tak_cols(K, m);
  if (lc >= m) return nullptr;
  int* rule = reinterpret_cast<int*>(ws + core_workspace(K, m) - 1);
  *e = launch_chunk_rule<K, double>(m, m, lc, kRuleTau, l_kuu, l_p, 0, 2, rule, st);
  return rule;
}

template <int K>
cudaError_t launch_chol_pair(int m, const double* kuu, const double* p, const double* b,
                             double* l_kuu, double* l_p, double* iv, double* c0, double* ws,
                             cudaStream_t st) {
  const int lc = core_chol_cols(K, m);
  const int nchunks = (m + lc - 1) / lc;
  const int nmap = nchunks - 1;
  const double* win = nullptr;
  if (nmap > 0) {
    if (ws == nullptr) return cudaErrorInvalidValue;
    double* tri = ws;
    double* w = tri + static_cast<size_t>(2) * nmap * kPairTri<K>;
    chol_pair_chunk_kernel<K, true><<<dim3(nmap, 2), 32, 0, st>>>(
        m, lc, nmap, kuu, p, b, l_kuu, l_p, iv, c0, nullptr, tri);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    const size_t smem = static_cast<size_t>(nmap) * kPairTri<K> * sizeof(double);
    if (smem > kSmemLimit) return cudaErrorInvalidValue;
    static std::atomic<unsigned long long> done{0};
    e = allow_smem(chol_pair_walk_kernel<K>, done);
    if (e != cudaSuccess) return e;
    chol_pair_walk_kernel<K><<<dim3(1, 2), 32, smem, st>>>(nmap, tri, w);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    win = w;
  }
  chol_pair_chunk_kernel<K, false><<<dim3(nchunks, 2), 32, 0, st>>>(
      m, lc, nmap, kuu, p, b, l_kuu, l_p, iv, c0, win, nullptr);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_tak_pair(int m, const double* l_kuu, const double* l_p, const double* iv,
                            const double* c0, double* s_kuu, double* s_p, double* u,
                            double* ws, cudaStream_t st) {
  constexpr int D = K * (K + 1) / 2;
  constexpr int DD = kPairCarry<K>;
  const int lc = core_tak_cols(K, m);
  const int nchunks = (m + lc - 1) / lc;
  const int nmap = nchunks - 1;
  const double* win = nullptr;
  const int* rule = nullptr;
  if (nmap > 0) {
    if (ws == nullptr) return cudaErrorInvalidValue;
    cudaError_t e;
    rule = core_tak_rule<K>(m, l_kuu, l_p, ws, st, &e);
    if (e != cudaSuccess) return e;
    const size_t hsz = static_cast<size_t>(nmap) * DD * DD;
    const size_t ysz = static_cast<size_t>(nmap) * DD;
    double* hmap = ws;
    double* ymap = hmap + 2 * hsz;
    double* w = ymap + 2 * ysz;
    tak_pair_chunk_kernel<K, true><<<dim3(nmap, 2), 32, 0, st>>>(
        m, lc, nmap, l_kuu, l_p, iv, c0, s_kuu, s_p, u, nullptr, hmap, ymap, rule);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    e = launch_chunk_scan<DD, double, D>(1, 2, nmap, hmap, hsz, ymap, ysz, w, st, rule, m);
    if (e != cudaSuccess) return e;
    win = w;
  }
  tak_pair_chunk_kernel<K, false><<<dim3(nchunks, 2), 32, 0, st>>>(
      m, lc, nmap, l_kuu, l_p, iv, c0, s_kuu, s_p, u, win, nullptr, nullptr, rule);
  return cudaGetLastError();
}

// K2's chunk length for the factors l_kuu, l_p, read back to the host.
template <int K>
int core_tak_chunk_cols(int m, const double* l_kuu, const double* l_p, double* ws,
                        cudaStream_t st) {
  const int lc = core_tak_cols(K, m);
  if (lc >= m) return lc;
  if (ws == nullptr) return -1;
  cudaError_t e;
  const int* rule = core_tak_rule<K>(m, l_kuu, l_p, ws, st, &e);
  return e != cudaSuccess ? -1 : read_rule(rule, st);
}

}  // namespace

extern "C" {

// Doubles of workspace K1 and K2 need at (k, m): 0 when the columns form
// one chunk of each.
int asvgp_core_workspace(int k, int m) {
  if (k < 1 || k > 6 || m < 1) return -1;
  return static_cast<int>(core_workspace(k, m));
}

// K1.  kuu, p: (k+1, m) lower bands; b: (m,); ws: asvgp_core_workspace(k,
// m) doubles, or NULL when that is 0.  Writes l_kuu, l_p (k+1, m), iv
// (2, m) = reciprocal pivots of [Kuu; P], c0 (m,) = L_P^-1 b.
int asvgp_chol_pair_solve(int k, int m, const double* kuu, const double* p,
                          const double* b, double* l_kuu, double* l_p,
                          double* iv, double* c0, double* ws, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1) return static_cast<int>(cudaErrorInvalidValue);
  ASVGP_DISPATCH_K(k, (launch_chol_pair<K>(m, kuu, p, b, l_kuu, l_p, iv, c0, ws, s)))
}

// K2.  l_kuu, l_p: (k+1, m) from K1; iv (2, m) and c0 (m,) from K1; ws as
// for K1.  Writes s_kuu, s_p (k+1, m) = bands of Kuu^-1 and P^-1, u (m,) =
// P^-1 b.
int asvgp_tak_pair_solve(int k, int m, const double* l_kuu, const double* l_p,
                         const double* iv, const double* c0, double* s_kuu,
                         double* s_p, double* u, double* ws, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1) return static_cast<int>(cudaErrorInvalidValue);
  ASVGP_DISPATCH_K(k, (launch_tak_pair<K>(m, l_kuu, l_p, iv, c0, s_kuu, s_p, u, ws, s)))
}

// The chunk length K2 takes for the factors l_kuu, l_p (k+1, m); ws as for
// K2.  For reporting: it synchronises.
int asvgp_core_tak_chunk_cols(int k, int m, const double* l_kuu, const double* l_p,
                              double* ws, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1) return -1;
  ASVGP_DISPATCH_K(k, (core_tak_chunk_cols<K>(m, l_kuu, l_p, ws, s)))
}

const char* asvgp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
