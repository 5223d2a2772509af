// K16: the Cholesky factor of dense SPD blocks and the inverse of that
// factor, in one chain, in float64 for Hopper (sm_90a).
//
// Replaces asvgp_tpu/banded/pallas_ds_block.py _make_kernel(B) (wrapper
// chol_inv_dense_ds): the diagonal-block step of the block-banded Cholesky
// (block_ds.panel_chol_ds), which factors the coupling matrix P of the
// Kronecker model one block column at a time.
//
// Input: nb blocks M (B x B, row-major, back to back); only their lower
// triangles are read.  Output: L with M = L L^T and T = L^-1, both B x B
// and exactly lower-triangular (the strict upper triangle is written 0.0).
//
// The recursion is block_ds._fused_sweep_ds in native FP64, a right-looking
// sweep over the B columns:
//   d = M[c][c],  rs = 1 / sqrt(d)        (a correctly rounded square root,
//                                          then a correctly rounded divide)
//   L[r][c] = M[r][c] rs  (r >= c; L[c][c] = d rs, as the TPU kernel has it)
//   T[c][j] = T[c][j] rs  (j <= c: row c of T is final once scaled)
//   M[r][j] -= L[r][c] L[j][c],  T[r][j] -= L[r][c] T[c][j]   (r > c)
// with T starting as the identity, each product and difference rounded on
// its own as in the plain version (banded/dense_block.py), which the
// kernel therefore matches bit for bit at any condition number: an fma
// would differ from it by rounding that L^-1 amplifies by cond(L).
//
// What bounds it: B dependent column steps, each a reciprocal square root
// and a rank-1 update of up to B^2/2 entries of M and of T.  At the Kron
// model's B = 100 that is ~0.7 MFLOP per block against 160 KB moved: far
// from both the FP64 rate and the bandwidth; the chain of column steps and
// the two barriers between them set the time.
//
// What the design does about it: one CTA per block (a grid over the batch,
// so a batch of nb diagonal blocks runs on nb SMs at once), one thread per
// row, and M and T in shared memory, each as a packed lower triangle stored
// column by column, so that the threads of a warp (consecutive rows) touch
// consecutive words of one column and the pivot row is a broadcast.  Two
// packed triangles take B (B + 1) 8 bytes: 132 KB at B = 128, and up to
// B = 169 they fit the 227 KB a CTA may use; beyond that the same layout
// lives in a global-memory workspace that the caller allocates
// (asvgp_chol_inv_dense_workspace says how much).  None of the TPU kernel's
// layout carries over: it kept the block in one 128-lane tile, swept every
// lane with where-masks and tolerated junk above the diagonal; here each
// thread touches only the entries of the triangle it owns.
//
// A pivot d <= 0 gives NaN, as the reference recursion does; nothing clamps.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

// the shared memory one CTA may use on an H100: 227 KB
constexpr size_t kSmemLimit = 232448;
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ size_t tri(int r, int j, int B) {
  // packed lower triangle, column by column: column j holds rows j..B-1
  // and starts at sum_{i<j} (B - i) = j B - j (j - 1) / 2
  const size_t jj = static_cast<size_t>(j);
  return jj * B - jj * (jj - 1) / 2 + static_cast<size_t>(r - j);
}

// 1 / sqrt(d): a correctly rounded square root, then a correctly rounded
// divide, spelled with the round-to-nearest intrinsics so that no compiler
// flag can swap in an approximation.
__device__ __forceinline__ double recip_sqrt(double d) {
  return __ddiv_rn(1.0, __dsqrt_rn(d));
}

__global__ void chol_inv_dense_kernel(int B, const double* __restrict__ m_all,
                                      double* __restrict__ l_all,
                                      double* __restrict__ t_all,
                                      double* __restrict__ ws_all) {
  extern __shared__ double smem[];
  const size_t P = static_cast<size_t>(B) * (B + 1) / 2;
  const size_t BB = static_cast<size_t>(B) * B;
  const size_t blk = blockIdx.x;
  double* M = (ws_all != nullptr) ? ws_all + 2 * P * blk : smem;
  double* T = M + P;
  const double* __restrict__ in = m_all + BB * blk;
  double* __restrict__ lout = l_all + BB * blk;
  double* __restrict__ tout = t_all + BB * blk;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  for (size_t e = tid; e < BB; e += nt) {
    const int r = static_cast<int>(e / B);
    const int j = static_cast<int>(e % B);
    if (j <= r) {
      const size_t q = tri(r, j, B);
      M[q] = in[e];
      T[q] = (r == j) ? 1.0 : 0.0;
    }
  }
  __syncthreads();

  for (int c = 0; c < B; ++c) {
    // M[c][c] is final: no thread writes it in this step
    const double rs = recip_sqrt(M[tri(c, c, B)]);
    for (int r = c + 1 + tid; r < B; r += nt) M[tri(r, c, B)] = __dmul_rn(M[tri(r, c, B)], rs);
    for (int j = tid; j <= c; j += nt) T[tri(c, j, B)] = __dmul_rn(T[tri(c, j, B)], rs);
    __syncthreads();
    for (int r = c + 1 + tid; r < B; r += nt) {
      const double lrc = M[tri(r, c, B)];
      // a rounded product, then a rounded difference (no fma): the
      // plain version's two roundings, so that the two agree bit for bit
      for (int j = c + 1; j <= r; ++j) {
        M[tri(r, j, B)] = __dsub_rn(M[tri(r, j, B)], __dmul_rn(lrc, M[tri(j, c, B)]));
      }
      for (int j = 0; j <= c; ++j) {
        T[tri(r, j, B)] = __dsub_rn(T[tri(r, j, B)], __dmul_rn(lrc, T[tri(c, j, B)]));
      }
    }
    __syncthreads();
  }

  for (size_t e = tid; e < BB; e += nt) {
    const int r = static_cast<int>(e / B);
    const int j = static_cast<int>(e % B);
    double lv = 0.0;
    double tv = 0.0;
    if (j < r) {
      lv = M[tri(r, j, B)];
      tv = T[tri(r, j, B)];
    } else if (j == r) {
      const double d = M[tri(r, r, B)];
      lv = __dmul_rn(d, recip_sqrt(d));
      tv = T[tri(r, r, B)];
    }
    lout[e] = lv;
    tout[e] = tv;
  }
}

size_t packed_doubles(int B) {
  return 2 * (static_cast<size_t>(B) * (B + 1) / 2);
}

}  // namespace

extern "C" {

// Doubles of global workspace each block needs: 0 when its two packed
// triangles fit in shared memory.
int asvgp_chol_inv_dense_workspace(int B) {
  if (B < 1) return -1;
  const size_t n = packed_doubles(B);
  return (n * sizeof(double) <= kSmemLimit) ? 0 : static_cast<int>(n);
}

// K16.  m: nb (B, B) SPD blocks (lower triangles read).  Writes l = chol(m)
// and t = l^-1.  ws: NULL, or nb * asvgp_chol_inv_dense_workspace(B)
// doubles when that is not 0.
int asvgp_chol_inv_dense(int B, int nb, const double* m, double* l, double* t,
                         double* ws, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || nb < 1) return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  if (ws == nullptr) {
    smem = packed_doubles(B) * sizeof(double);
    if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t e = cudaFuncSetAttribute(
        chol_inv_dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int rows = (B < kMaxThreads) ? B : kMaxThreads;
  const int threads = ((rows + 31) / 32) * 32;
  chol_inv_dense_kernel<<<nb, threads, smem, st>>>(B, m, l, t, ws);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
