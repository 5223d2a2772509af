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
// What bounds it: B dependent column steps.  Step c updates the r + 1
// entries of every row r > c (T[r][0..c] and M[r][c+1..r]): ~B^3/3
// independent read-modify-writes in all, ~0.7 MFLOP per B = 100 block
// against 160 KB moved, far from both the FP64 rate and the bandwidth.
// What sets the time is the chain from one pivot to the next (a product,
// a difference, a correctly rounded square root and divide, a barrier;
// tools/k16_floor_probe.py times it alone) and the shared-memory
// instructions one SM issues for the updates.
//
// What the design does about it: one CTA per block (a grid over the
// batch), its threads sharing out the entries of each column step, one
// barrier per step:
//   * A row's entries at step c, j = 0..r, are contiguous: lanes take the
//     columns j = lane (mod 32), so nearly every lane of an instruction has
//     an entry, and warps take the rows r > c in turn.  Each lane forms
//     its columns' scaled operands (L[j][c] for j > c, T[c][j] for j <= c)
//     once per step; L[r][c] is one broadcast per row.
//   * A pivot warp runs beside the updates: it keeps every d_i running in
//     the shared array RS (the two roundings of the update of M[i][i], so
//     the same bits) and takes the next pivot's reciprocal root as soon as
//     column c is final.  RS then scales the outputs.
//   * Nothing is written back scaled: column c of M and row c of T are
//     read only in step c, and the writes of step c (M[r][j], j > c;
//     T[r][j], r > c) never touch them, so a step needs no second barrier.
//     The outputs are scaled once at the end.
//   * M and T are packed lower triangles stored row by row, so a row's
//     entries are consecutive words for consecutive lanes.  Both triangles
//     and RS take (B (B + 1) + B) 8 bytes: up to B = 169 they fit the
//     227 KB a CTA may use; beyond that the triangles live in a
//     global-memory workspace that the caller allocates
//     (asvgp_chol_inv_dense_workspace says how much).
// Each entry still receives its updates in increasing c, each a __dmul_rn
// then a __dsub_rn: the order of work across entries changes and the
// arithmetic does not.  None of the TPU kernel's layout carries over: it
// kept the block in one 128-lane tile, swept every lane with where-masks
// and tolerated junk above the diagonal.
//
// A pivot d <= 0 gives NaN, as the reference recursion does; nothing clamps.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

// the shared memory one CTA may use on an H100: 227 KB
constexpr size_t kSmemLimit = 232448;
// update warps at most (the CTA adds the pivot warp)
constexpr int kWarps = 16;
// columns a lane takes at a time in a row: 32 kSlots columns, B <= 128 in
// one pass
constexpr int kSlots = 4;
// the widest block: its packed offsets, up to B (B + 1), fit an int
constexpr int kMaxB = 32768;

// Packed lower triangle, row by row: row r holds columns 0..r and starts
// at r (r + 1) / 2.  Offsets within one block fit an int (B <= kMaxB).
__device__ __forceinline__ int rowbase(int r) { return r * (r + 1) / 2; }

// 1 / sqrt(d): a correctly rounded square root, then a correctly rounded
// divide, spelled with the round-to-nearest intrinsics so that no compiler
// flag can swap in an approximation.
__device__ __forceinline__ double recip_sqrt(double d) {
  return __ddiv_rn(1.0, __dsqrt_rn(d));
}

// kShared: M and T in shared memory (so that every access is a shared-memory
// instruction); else in the global workspace ws_all.
template <bool kShared>
__global__ void __launch_bounds__(32 * (kWarps + 1))
chol_inv_dense_kernel(int B, const double* __restrict__ m_all,
                      double* __restrict__ l_all, double* __restrict__ t_all,
                      double* __restrict__ ws_all) {
  extern __shared__ double smem[];
  const int P = B * (B + 1) / 2;
  const size_t BB = static_cast<size_t>(B) * B;
  const size_t blk = blockIdx.x;
  // RS[i]: the running pivot d_i until step i - 1, then 1 / sqrt(d_i)
  double* RS = smem;
  // M, then T = M + P: one array, so that an entry's offset picks either
  double* M = kShared ? smem + B : ws_all + 2 * static_cast<size_t>(P) * blk;
  const double* __restrict__ in = m_all + BB * blk;
  double* __restrict__ lout = l_all + BB * blk;
  double* __restrict__ tout = t_all + BB * blk;
  const int lane = threadIdx.x;  // columns j = lane (mod 32)
  const int warp = threadIdx.y;  // rows r = c + 1 + warp (mod NW)
  const int NW = blockDim.y - 1;  // the update warps; warp NW carries the pivots
  const int tid = warp * 32 + lane;
  const int nt = 32 * blockDim.y;

  for (size_t e = tid; e < BB; e += nt) {
    const int r = static_cast<int>(e / B);
    const int j = static_cast<int>(e % B);
    if (j <= r) {
      const int q = rowbase(r) + j;
      M[q] = in[e];
      M[P + q] = (r == j) ? 1.0 : 0.0;
      if (j == r) RS[r] = in[e];
    }
  }
  __syncthreads();
  if (tid == 0) RS[0] = recip_sqrt(RS[0]);
  __syncthreads();

  for (int c = 0; c < B; ++c) {
    const double rs = RS[c];
    if (warp == NW) {
      // the pivot warp: d_i -= L[i][c]^2 for i > c, the two roundings of
      // the update of M[i][i]; then the next pivot's reciprocal root,
      // while the update warps work through the step
      for (int i = c + 1 + lane; i < B; i += 32) {
        const double l = __dmul_rn(M[rowbase(i) + c], rs);
        RS[i] = __dsub_rn(RS[i], __dmul_rn(l, l));
      }
      if (lane == 0 && c + 1 < B) RS[c + 1] = recip_sqrt(RS[c + 1]);
    } else if (c + 1 + warp < B) {
      const int rbc = rowbase(c);
      for (int t0 = 0; 32 * t0 < B; t0 += kSlots) {
        // this lane's next kSlots columns j: the scaled operand of each
        // (L[j][c] for j > c, T[c][j] for j <= c, the same for every row)
        // and where its entry of row r sits (off + rowbase(r), in M or T)
        int off[kSlots];
        double opd[kSlots];
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
          const int j = lane + 32 * (t0 + s);
          off[s] = 0;
          opd[s] = 0.0;
          if (j < B) {
            off[s] = (j <= c) ? P + j : j;
            opd[s] = __dmul_rn((j <= c) ? M[P + rbc + j] : M[rowbase(j) + c], rs);
          }
        }
        for (int r = c + 1 + warp; r < B; r += NW) {
          const int rb = rowbase(r);
          const double lrc = __dmul_rn(M[rb + c], rs);
          // all entries of the row read before any is written
          double old[kSlots];
#pragma unroll
          for (int s = 0; s < kSlots; ++s) {
            if (lane + 32 * (t0 + s) <= r) old[s] = M[off[s] + rb];
          }
          // a rounded product, then a rounded difference (no fma): the
          // plain version's two roundings, so that the two agree bit for bit
#pragma unroll
          for (int s = 0; s < kSlots; ++s) {
            if (lane + 32 * (t0 + s) <= r) {
              M[off[s] + rb] = __dsub_rn(old[s], __dmul_rn(lrc, opd[s]));
            }
          }
        }
      }
    }
    __syncthreads();
  }

  for (size_t e = tid; e < BB; e += nt) {
    const int r = static_cast<int>(e / B);
    const int j = static_cast<int>(e % B);
    double lv = 0.0;
    double tv = 0.0;
    if (j <= r) {
      // L[r][j] = M[r][j] rs_j (L[r][r] = d rs_r); T[r][j] = T[r][j] rs_r
      const int q = rowbase(r) + j;
      lv = __dmul_rn(M[q], RS[j]);
      tv = __dmul_rn(M[P + q], RS[r]);
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
// triangles fit in shared memory beside the B pivots.
int asvgp_chol_inv_dense_workspace(int B) {
  if (B < 1 || B > kMaxB) return -1;
  const size_t n = packed_doubles(B);
  return ((n + B) * sizeof(double) <= kSmemLimit) ? 0 : static_cast<int>(n);
}

// K16.  m: nb (B, B) SPD blocks (lower triangles read).  Writes l = chol(m)
// and t = l^-1.  ws: NULL, or nb * asvgp_chol_inv_dense_workspace(B)
// doubles when that is not 0.
int asvgp_chol_inv_dense(int B, int nb, const double* m, double* l, double* t,
                         double* ws, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > kMaxB || nb < 1) return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = static_cast<size_t>(B) * sizeof(double);
  if (ws == nullptr) smem += packed_doubles(B) * sizeof(double);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  // an update warp per 6 rows, up to kWarps, and the pivot warp
  const int want = (B + 5) / 6;
  const dim3 threads(32, ((want < kWarps) ? want : kWarps) + 1);
  if (ws == nullptr) {
    const cudaError_t e = cudaFuncSetAttribute(
        chol_inv_dense_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    chol_inv_dense_kernel<true><<<nb, threads, smem, st>>>(B, m, l, t, ws);
  } else {
    chol_inv_dense_kernel<false><<<nb, threads, smem, st>>>(B, m, l, t, ws);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
