// The tangent-fused sweeps of the collapsed-ELBO gradient, single-ended (K3,
// K4) and twisted (K5, K6), in float64 for Hopper (sm_90a).
//
// Storage as in banded_core.cu: a banded matrix of size m with lower
// bandwidth K is its lower band, row-major (K+1, m), band[j * m + i] =
// M[i + j, i], right padding zero.  A tangent band T holds dM/dell in the
// same layout.
//
// Plain C entry points (no PyTorch headers), compiled with the flags of
// banded_core.cu and loaded with ctypes by asvgp_tpu_torch/banded/_build.py.
// Each launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().
//
// The column steps are shared: chol_tan_step is K1's Cholesky column and
// lower solve plus the forward tangent of the Cholesky column in the
// direction T; tak_tan_step is K2's Takahashi column and upper solve plus
// the tangent of the Takahashi column.  With r = a - s, rv = 1/sqrt(r_0)
// and c = r * rv:
//     rdot = T_col - sum_p [gdot_p W_p + g_p Wdot_p]
//     e = -rv^2 rdot_0 / 2,   cdot = rv * rdot + c * e,   ivdot = rv * e
// and, with aq = sum_p CS w_p, s_q = -aq d, sj = d^2 - (sum_q w_q s_q) d:
//     aqdot = sum_p [CSdot w_p + CS wdot_p],   sdot_q = -(aqdot d + aq ddot)
//     sjdot = 2 d ddot - (wsdot d + ws ddot)
//
// What bounds all four: the serial chain of column steps, each waiting on
// the float64 latency of the previous one (fma chains of depth K, and in
// the Cholesky a sqrt and a reciprocal).  They read and write O(K m)
// doubles, about 2 MB at m = 10^4, K = 3: bandwidth is not the limit.
//
// What the design does about it: each chain is cut into chunks run in
// parallel, one matrix a block, three launches a kernel (one pass when a
// walk fits in one chunk).  The Cholesky sweeps K3 and K5 are joined
// across chunks by the K x K Schur-complement update of chol_fwd
// (schur_walk.cuh), widened by the tangent (Kuu, as a dual number) or the
// solve (P); the Takahashi sweeps K4 and K6 by the affine partition of
// tak_fwd on the scan of chunk_scan.cuh.  K5 and K6 run four matrices
// (F/R stream x Kuu/P); K3 and K4 run the same chunk passes on two (Kuu,
// P) over one stream of all m columns, tapered (rows past the end masked),
// K4 from a zero carry where K6 starts from the middle block's seed (see
// each below).  Each block takes one matrix, so no lane computes what its
// matrix drops.  The TPU kernels' float32 hi/lo pairs, lane interleave,
// 128-column tiles, one-hot row masks and seed columns are TPU layout work
// with no counterpart here: the seeds of K6 are loaded into the register
// windows before the first column.

#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <type_traits>

#include "chunk_scan.cuh"
#include "forward_sweeps.cuh"
#include "schur_walk.cuh"

// K4's and K6's chunks are at least this many columns (a multiple of the
// 64-column tile); a build may set it to measure another length
// (tools/twist_ab.py and tools/tan_ab.py --tak-chunk).  K3's and K5's are
// ASVGP_SCHUR_CHUNK's (schur_walk.cuh).
#ifndef ASVGP_TAK_QUAD_CHUNK
#define ASVGP_TAK_QUAD_CHUNK 64
#endif

namespace {

// ---------------------------------------------------------------------------
// shared column steps
// ---------------------------------------------------------------------------

template <int K>
struct CholWindow {
  double w[K][K + 1];   // w[q-1][r] = L[i-q+r, i-q]
  double tw[K][K + 1];  // its tangent
  double x[K];          // x[q-1] = c[i-q], the lower solve
};

template <int K>
__device__ __forceinline__ void chol_window_zero(CholWindow<K>& st) {
#pragma unroll
  for (int q = 0; q < K; ++q) {
    st.x[q] = 0.0;
#pragma unroll
    for (int r = 0; r <= K; ++r) {
      st.w[q][r] = 0.0;
      st.tw[q][r] = 0.0;
    }
  }
}

// Column i of the Cholesky of A with its tangent in the direction T and the
// lower-solve entry for b_i.  keep[j] multiplies row j (1, or 0 for rows
// past the end of a tapered matrix).  Writes col, tcol, the reciprocal
// pivot r and its tangent tiv, the solve entry xi; pushes the window.
// kTan = false leaves out the tangent (tc, tcol, tiv unused), kSolve =
// false the solve (bc, xi unused); what remains is computed as with both.
template <int K, bool kTan, bool kSolve>
__device__ __forceinline__ void chol_tan_step(
    CholWindow<K>& st, const double (&ac)[K + 1], const double (&tc)[K + 1],
    double bc, const double (&keep)[K + 1], double (&col)[K + 1],
    double (&tcol)[K + 1], double& r, double& tiv, double& xi) {
  double s[K + 1], ts[K + 1];
#pragma unroll
  for (int j = 0; j <= K; ++j) {
    s[j] = 0.0;
    ts[j] = 0.0;
  }
  double sb = 0.0;
#pragma unroll
  for (int q = 1; q <= K; ++q) {
    const double g = st.w[q - 1][q];    // L[i, i-q]
    const double tg = st.tw[q - 1][q];  // its tangent
    if constexpr (kSolve) sb = fma(g, st.x[q - 1], sb);
#pragma unroll
    for (int j = 0; j + q <= K; ++j) {
      s[j] = fma(g, st.w[q - 1][q + j], s[j]);
      if constexpr (kTan) ts[j] = fma(tg, st.w[q - 1][q + j], fma(g, st.tw[q - 1][q + j], ts[j]));
    }
  }
  const double l0 = sqrt(ac[0] - s[0]);
  r = 1.0 / l0;
  col[0] = l0;
#pragma unroll
  for (int j = 1; j <= K; ++j) {
    // multiply by the mask (not select) so a NaN pivot stays NaN
    col[j] = (ac[j] - s[j]) * r * keep[j];
  }
  if constexpr (kSolve) xi = (bc - sb) * r;
  if constexpr (kTan) {
    const double e = -0.5 * r * r * (tc[0] - ts[0]);
#pragma unroll
    for (int j = 0; j <= K; ++j) {
      tcol[j] = fma(tc[j] - ts[j], r, col[j] * e) * keep[j];
    }
    tiv = r * e;
  }

#pragma unroll
  for (int q = K - 1; q > 0; --q) {
    if constexpr (kSolve) st.x[q] = st.x[q - 1];
#pragma unroll
    for (int rr = 0; rr <= K; ++rr) {
      st.w[q][rr] = st.w[q - 1][rr];
      if constexpr (kTan) st.tw[q][rr] = st.tw[q - 1][rr];
    }
  }
  if constexpr (kSolve) st.x[0] = xi;
#pragma unroll
  for (int rr = 0; rr <= K; ++rr) {
    st.w[0][rr] = col[rr];
    if constexpr (kTan) st.tw[0][rr] = tcol[rr];
  }
}

template <int K>
struct TakWindow {
  double cs[K][K + 1];   // cs[p-1][r] = S[j+p+r, j+p]
  double tcs[K][K + 1];  // its tangent
  double x[K];           // x[p-1] = u[j+p], the upper solve
};

// Column j of the Takahashi band with its tangent and the upper-solve entry
// for c_j, from the factor column lc, its tangent tlc, the reciprocal pivot
// d and its tangent td.  keep[q] multiplies row q.  Writes col, tcol and the
// solve entry uj; pushes the window.  kTan = false leaves out the tangent
// (tlc, td, tcol unused), kSolve = false the solve (bc, uj unused).  kMaps
// scales the terms that are not linear in the window (d^2, 2 d td, bc d)
// by part: 0 runs the window's homogeneous response, 1 the particular.
template <int K, bool kTan, bool kSolve, bool kMaps>
__device__ __forceinline__ void tak_tan_step(
    TakWindow<K>& st, const double (&lc)[K + 1], const double (&tlc)[K + 1],
    double d, double td, double bc, const double (&keep)[K + 1],
    double (&col)[K + 1], double (&tcol)[K + 1], double& uj, double part) {
  if constexpr (kSolve) {
    double sb = 0.0;
#pragma unroll
    for (int q = 1; q <= K; ++q) sb = fma(lc[q], st.x[q - 1], sb);
    uj = kMaps ? (part * bc - sb) * d : (bc - sb) * d;
  }

  double sq[K + 1], tsq[K + 1];
  sq[0] = tsq[0] = 0.0;
#pragma unroll
  for (int q = 1; q <= K; ++q) {
    double acc = 0.0, tacc = 0.0;
#pragma unroll
    for (int p = 1; p <= K; ++p) {
      const int lo = (p < q) ? p : q;
      const int df = (p < q) ? (q - p) : (p - q);
      acc = fma(st.cs[lo - 1][df], lc[p], acc);
      if constexpr (kTan) {
        tacc = fma(st.tcs[lo - 1][df], lc[p], fma(st.cs[lo - 1][df], tlc[p], tacc));
      }
    }
    sq[q] = -d * acc;
    if constexpr (kTan) tsq[q] = -fma(tacc, d, acc * td);
  }
  double ws = 0.0, tws = 0.0;
#pragma unroll
  for (int q = 1; q <= K; ++q) {
    ws = fma(lc[q], sq[q], ws);
    if constexpr (kTan) tws = fma(tlc[q], sq[q], fma(lc[q], tsq[q], tws));
  }
  col[0] = kMaps ? part * (d * d) - d * ws : d * d - d * ws;
  if constexpr (kTan) {
    tcol[0] = kMaps ? part * (2.0 * d * td) - fma(tws, d, ws * td)
                    : 2.0 * d * td - fma(tws, d, ws * td);
  }
#pragma unroll
  for (int q = 1; q <= K; ++q) {
    col[q] = sq[q] * keep[q];
    if constexpr (kTan) tcol[q] = tsq[q] * keep[q];
  }

#pragma unroll
  for (int q = K - 1; q > 0; --q) {
    if constexpr (kSolve) st.x[q] = st.x[q - 1];
#pragma unroll
    for (int rr = 0; rr <= K; ++rr) {
      st.cs[q][rr] = st.cs[q - 1][rr];
      if constexpr (kTan) st.tcs[q][rr] = st.tcs[q - 1][rr];
    }
  }
  if constexpr (kSolve) st.x[0] = uj;
#pragma unroll
  for (int rr = 0; rr <= K; ++rr) {
    st.cs[0][rr] = col[rr];
    if constexpr (kTan) st.tcs[0][rr] = tcol[rr];
  }
}

// ---------------------------------------------------------------------------
// The twisted sweeps K5 and K6, chunk-partitioned
//
// Both run four matrices in one grid, t = blockIdx.y: stream t >> 1 (F, R),
// Kuu when t is even, P when it is odd; each block takes one role, so no
// lane computes what its matrix drops.  Stream F walks columns 0..h-1 of
// the bands, stream R columns 0..g-1 of the index-reversed bands (element
// (r, j) is band[r, m-1-r-j], read in place by the stagers), g = m - h - K,
// which is h or h - 1.  Each stream's walk is cut into chunks of lc
// columns, the same lc for both (from h); R may have one chunk fewer, and a
// stream that fits in one chunk runs one pass.  Every CTA stages its
// chunk's columns in shared memory, 64 a tile, two tiles in flight
// (cp.async), so no global load sits on a chain.
// ---------------------------------------------------------------------------

// The forward-mode dual number (value, tangent) that K5's partition carries
// for the Kuu tangent: the triples' and the walk's helpers of
// schur_walk.cuh run on it unchanged, so the tangent of every quantity they
// compute is the same code run on pairs.
struct Dual {
  double v, d;
  Dual() = default;
  __device__ __forceinline__ Dual(double x) : v(x), d(0.0) {}
  __device__ __forceinline__ Dual(double x, double dx) : v(x), d(dx) {}
};
__device__ __forceinline__ Dual operator-(Dual a) { return Dual(-a.v, -a.d); }
__device__ __forceinline__ Dual operator*(Dual a, Dual b) {
  return Dual(a.v * b.v, fma(a.v, b.d, a.d * b.v));
}
__device__ __forceinline__ Dual fma_t(Dual a, Dual b, Dual c) {
  return Dual(fma(a.v, b.v, c.v), fma(a.v, b.d, fma(a.d, b.v, c.d)));
}
__device__ __forceinline__ Dual rsqrt_t(Dual a) {
  const double r = rsqrt(a.v);
  return Dual(r, -0.5 * r * r * r * a.d);
}

// Stage dst[r][t] = element (r, u0 + t) of a stream's band (ROWS = K+1) or
// vector (ROWS = 1, r = 0), t < n: F reads src[r, col], R src[r, m-1-r-col].
// The caller commits the group.
template <int ROWS>
__device__ __forceinline__ void stage_stream(double (*dst)[kTile], const double* __restrict__ src,
                                             int m, bool rev, int u0, int n) {
  const size_t ms = static_cast<size_t>(m);
  for (int idx = threadIdx.x; idx < ROWS * kTile; idx += 32) {
    const int r = idx / kTile;
    const int t = idx % kTile;
    if (t < n) {
      const int col = u0 + t;
      cp_async(&dst[r][t], src + r * ms + (rev ? m - 1 - r - col : col));
    }
  }
}

// Stage dst[r][t] = src[r, n-1-(u0+t)], t < cnt, from a stream-local
// (ROWS, h) array walked down from column n-1.  The caller commits.
template <int ROWS>
__device__ __forceinline__ void stage_down(double (*dst)[kTile], const double* __restrict__ src,
                                           int h, int n, int u0, int cnt) {
  const size_t hs = static_cast<size_t>(h);
  for (int idx = threadIdx.x; idx < ROWS * kTile; idx += 32) {
    const int r = idx / kTile;
    const int t = idx % kTile;
    if (t < cnt) cp_async(&dst[r][t], src + r * hs + (n - 1 - u0 - t));
  }
}

// K5's triple of a chunk, in doubles: Kuu's (U, Q, R) as dual numbers,
// 2 (K^2 + K(K+1)) doubles; P's (U, Q, R, p0, r0), K^2 + K(K+1) + 2K,
// fewer.  Its walked carry: Kuu's W as dual numbers (W and its tangent,
// interleaved), P's W and beta, at most K(K+1) doubles.
template <int K>
constexpr int kQuadTriStride = 2 * (K * K + K * (K + 1));

// ---------------------------------------------------------------------------
// K5: chol_quad_solve_tan<K>
//
// Replaces asvgp_tpu/banded/pallas_ds_twist.py, _chol_quad_solve_tan_kernel
// (kernel A of factor_takahashi_solve_tan_twist): on each stream, the
// Cholesky of Kuu with its forward tangent in the direction T (the Kuu
// matrices) and the Cholesky of P with the lower solve of b, or of b
// reversed (the P matrices), untapered: the last K columns of a stream
// keep their rows h.. (the spill L21 into the middle block, which the mid
// step reads).
//
// Outputs, stream-local over h columns (R's column h-1 is zero when g < h):
// l (4, K+1, h) = [F Kuu, F P, R Kuu, R P], iv (4, h), ldot (2, K+1, h) and
// ivdot (2, h) of [F Kuu, R Kuu], y (2, h) = the lower solves of [F P, R P].
//
// What bounds it: each stream is a serial chain of Cholesky columns (fma
// chains of depth K, a sqrt and a reciprocal each) with the tangent or the
// solve hanging off it; it moves about 2 MB at m = 10^4, K = 3.  One
// thread walking a stream (one block of four threads, 131 SMs idle) took
// about 0.32 us a column.
//
// What the design does about it: chol_fwd's Schur partition
// (forward_sweeps.cuh, the helpers in schur_walk.cuh), with what crosses a
// chunk boundary widened.  A Kuu matrix carries W as a dual number: its
// tangent is exact because the tangent of chol(A_c - E W E^T) is the
// Cholesky tangent in the direction T_c - E Wdot E^T, and Wdot walks beside
// W by the forward derivative of the same Riccati step.  A P matrix carries
// beside W the solve's coupling beta = L[c0:c0+K, :c0] y[:c0] (a K-vector;
// schur_step<.., true>), so its chunks' solves need no second partition:
// K13's maps-scan-solve on the P factors after pass 3 would add three
// launches and a scan for what the walk carries in K values.  Three
// launches when a stream spans more than one chunk:
//   1. triples (chol_quad_chunk_kernel<K, true>), grid (chunks but the
//      last, 4): each chunk's recursion from W = 0, V = L_c^-1 E along it;
//      Kuu in dual numbers (the column's tangent from chol_tan_step), P with
//      p0 = V^T y0 and r0 = X y0_last from the chunk's own solve y0.
//   2. walk (chol_quad_walk_kernel), one thread per matrix: every chunk's
//      incoming W and Wdot (Kuu) or W and beta (P).
//   3. factor (chol_quad_chunk_kernel<K, false>), grid (chunks, 4): W
//      subtracted from the staged first K rows of A_c, Wdot from those of
//      T_c (Kuu) or beta from the first K entries of b_c (P), then
//      chol_tan_step from a zero window, the outputs written.
// Passes 1 and 3 run chol_tan_step (sqrt, then the reciprocal), so each
// stream's first chunk (W = Wdot = 0, beta = 0) is the one-chain
// recursion bit for bit.  A failing pivot gives NaN from its column on
// within its stream: in its chunk by the recursion, in every later chunk
// through F = chol(I - U^T W U) in the walk.  The stagers read R's
// reversed band in place.
// ---------------------------------------------------------------------------

// Passes 1 (kMaps) and 3 over chunk j0 of matrix t, in the role kKuu.
// kTaper zeroes rows i + j >= m, as K3 does on its one stream (t = 0,
// h = m); K5's streams keep them.
template <int K, bool kKuu, bool kMaps, bool kTaper = false>
__device__ __forceinline__ void chol_quad_chunk(
    int m, int h, int lc, int nmap, int j0, int t, const double* __restrict__ kuu,
    const double* __restrict__ tan, const double* __restrict__ p,
    const double* __restrict__ b, double* __restrict__ l, double* __restrict__ ldot,
    double* __restrict__ iv, double* __restrict__ ivdot, double* __restrict__ y,
    const double* __restrict__ win, double* __restrict__ tri) {
  constexpr int D = K * (K + 1) / 2;
  constexpr int XR = kKuu ? K + 1 : 1;  // rows of the second operand: T or b
  using V = typename std::conditional<kKuu, Dual, double>::type;
  __shared__ double at[2][K + 1][kTile];  // A columns of the positions
  __shared__ double xt[2][XR][kTile];     // T columns (Kuu) or b (P)
  const int lane = threadIdx.x;
  const int stream = t >> 1;
  const bool rev = stream == 1;
  const int n = rev ? m - h - K : h;
  const int s = j0 * lc;
  const int e = (s + lc < n) ? s + lc : n;
  // R may have one chunk fewer; a stream's last chunk has no triple
  if (s >= n || (kMaps && e == n)) return;
  const double* __restrict__ a = kKuu ? kuu : p;
  const double* __restrict__ x = kKuu ? tan : b;
  const size_t hs = static_cast<size_t>(h);

  CholWindow<K> st;
  chol_window_zero(st);
  double keep[K + 1];
#pragma unroll
  for (int r = 0; r <= K; ++r) keep[r] = 1.0;
  V vw[K][K];    // pass 1: vw[p-1][f] = V[i-p-s, f], the last K rows of V
  V pa[K][K];    // pass 1: P = V^T V, its upper triangle
  double p0[K];  // pass 1 on P: V^T y0
#pragma unroll
  for (int q = 0; q < K; ++q) {
    p0[q] = 0.0;
#pragma unroll
    for (int f = 0; f < K; ++f) {
      vw[q][f] = V(0.0);
      pa[q][f] = V(0.0);
    }
  }

  const int ntiles = (e - s + kTile - 1) / kTile;
  stage_stream<K + 1>(at[0], a, m, rev, s, min(kTile, e - s));
  stage_stream<XR>(xt[0], x, m, rev, s, min(kTile, e - s));
  cp_async_commit();
  for (int tile = 0; tile < ntiles; ++tile) {
    const int buf = tile & 1;
    const int u0 = s + tile * kTile;
    const int cnt = min(kTile, e - u0);
    if (tile + 1 < ntiles) {
      const int u1 = u0 + kTile;
      stage_stream<K + 1>(at[buf ^ 1], a, m, rev, u1, min(kTile, e - u1));
      stage_stream<XR>(xt[buf ^ 1], x, m, rev, u1, min(kTile, e - u1));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (!kMaps && tile == 0 && j0 > 0) {
      // W (and Wdot) off the chunk's first K rows: lane d takes slot
      // d = (r, r + c), band entry c of column s + r; beta off b's first K
      const double* wc = win + (static_cast<size_t>(t) * nmap + j0 - 1) * 2 * D;
      if (lane < D) {
        int r = 0;
        int c = lane;
        while (c >= K - r) {
          c -= K - r;
          ++r;
        }
        if (r < cnt) {
          if constexpr (kKuu) {
            at[0][c][r] -= wc[2 * lane];
            xt[0][c][r] -= wc[2 * lane + 1];
          } else {
            at[0][c][r] -= wc[lane];
          }
        }
      }
      if constexpr (!kKuu) {
        if (lane < K && lane < cnt) xt[0][0][lane] -= wc[D + lane];
      }
      __syncthreads();
    }
    for (int tt = 0; tt < cnt; ++tt) {
      const int i = u0 + tt;
      double ac[K + 1], tc[K + 1], bc = 0.0;
#pragma unroll
      for (int r = 0; r <= K; ++r) {
        if constexpr (kTaper) keep[r] = (i + r < m) ? 1.0 : 0.0;
        ac[r] = at[buf][r][tt];
        if constexpr (kKuu) {
          tc[r] = xt[buf][r][tt];
        } else {
          tc[r] = 0.0;
        }
      }
      if constexpr (!kKuu) bc = xt[buf][0][tt];
      V g[K];  // L[i, i-p], before the step shifts the window
#pragma unroll
      for (int q = 1; q <= K; ++q) {
        if constexpr (kKuu) {
          g[q - 1] = Dual(st.w[q - 1][q], st.tw[q - 1][q]);
        } else {
          g[q - 1] = st.w[q - 1][q];
        }
      }
      double col[K + 1], tcol[K + 1], rp, tiv = 0.0, xi = 0.0;
      chol_tan_step<K, kKuu, !kKuu>(st, ac, tc, bc, keep, col, tcol, rp, tiv, xi);
      if constexpr (kMaps) {
        V rv;
        if constexpr (kKuu) {
          rv = Dual(rp, tiv);
        } else {
          rv = rp;
        }
        V vn[K];
        schur_v_row<K, V>(g, rv, i - s, vw, pa, vn);
        if constexpr (!kKuu) {
#pragma unroll
          for (int f = 0; f < K; ++f) p0[f] = fma(vn[f], xi, p0[f]);
        }
      } else if (lane == 0) {
#pragma unroll
        for (int r = 0; r <= K; ++r) l[(t * (K + 1) + r) * hs + i] = col[r];
        iv[t * hs + i] = rp;
        if constexpr (kKuu) {
#pragma unroll
          for (int r = 0; r <= K; ++r) ldot[(stream * (K + 1) + r) * hs + i] = tcol[r];
          ivdot[stream * hs + i] = tiv;
        } else {
          y[stream * hs + i] = xi;
        }
      }
    }
    __syncthreads();
  }

  if (kMaps && lane == 0) {
    V wv[K][K + 1];
#pragma unroll
    for (int q = 0; q < K; ++q) {
#pragma unroll
      for (int r = 0; r <= K; ++r) {
        if constexpr (kKuu) {
          wv[q][r] = Dual(st.w[q][r], st.tw[q][r]);
        } else {
          wv[q][r] = st.w[q][r];
        }
      }
    }
    double* o = tri + (static_cast<size_t>(t) * nmap + j0) * kQuadTriStride<K>;
    schur_triple<K, V>(wv, vw, pa, reinterpret_cast<V*>(o));
    if constexpr (!kKuu) schur_solve_tail<K, double>(st.w, st.x, p0, o + K * K + 2 * D);
  }
  if (!kMaps && e == n) {
    // the R stream is one column shorter when m - K is odd: zero the rest
    for (int i = n + lane; i < h; i += 32) {
#pragma unroll
      for (int r = 0; r <= K; ++r) l[(t * (K + 1) + r) * hs + i] = 0.0;
      iv[t * hs + i] = 0.0;
      if constexpr (kKuu) {
#pragma unroll
        for (int r = 0; r <= K; ++r) ldot[(stream * (K + 1) + r) * hs + i] = 0.0;
        ivdot[stream * hs + i] = 0.0;
      } else {
        y[stream * hs + i] = 0.0;
      }
    }
  }
}

template <int K, bool kMaps>
__global__ void __launch_bounds__(32)
chol_quad_chunk_kernel(int m, int h, int lc, int nmap, const double* __restrict__ kuu,
                       const double* __restrict__ tan, const double* __restrict__ p,
                       const double* __restrict__ b, double* __restrict__ l,
                       double* __restrict__ ldot, double* __restrict__ iv,
                       double* __restrict__ ivdot, double* __restrict__ y,
                       const double* __restrict__ win, double* __restrict__ tri) {
  const int t = blockIdx.y;
  if ((t & 1) == 0) {
    chol_quad_chunk<K, true, kMaps>(m, h, lc, nmap, blockIdx.x, t, kuu, tan, p, b, l, ldot, iv,
                                    ivdot, y, win, tri);
  } else {
    chol_quad_chunk<K, false, kMaps>(m, h, lc, nmap, blockIdx.x, t, kuu, tan, p, b, l, ldot,
                                     iv, ivdot, y, win, tri);
  }
}

// Pass 2 for matrix blockIdx.y: schur_walk over its stream's triples from
// 0, writing the carry of chunk c + 1 at win + c K(K+1): Kuu walks W in
// dual numbers (schur_step<K, Dual>), P walks W and beta
// (schur_step<K, double, true>).
template <int K>
__global__ void __launch_bounds__(32)
chol_quad_walk_kernel(int m, int h, int lc, int nmap, const double* __restrict__ tri,
                      double* __restrict__ win) {
  constexpr int D = K * (K + 1) / 2;
  constexpr int kStride = kQuadTriStride<K>;
  extern __shared__ __align__(16) unsigned char quad_walk_smem[];
  const int t = blockIdx.y;
  const int n = (t >> 1) ? m - h - K : h;
  const int nm = (n + lc - 1) / lc - 1;  // this stream's triples
  tri += static_cast<size_t>(t) * nmap * kStride;
  win += static_cast<size_t>(t) * nmap * 2 * D;
  if ((t & 1) == 0) {
    schur_walk<K, Dual, false>(nm, reinterpret_cast<const Dual*>(tri), kStride / 2,
                               reinterpret_cast<Dual*>(win), D,
                               reinterpret_cast<Dual*>(quad_walk_smem));
  } else {
    schur_walk<K, double, true>(nm, tri, kStride, win, 2 * D,
                                reinterpret_cast<double*>(quad_walk_smem));
  }
}

// ---------------------------------------------------------------------------
// K6: tak_quad_solve_tan<K>
//
// Replaces asvgp_tpu/banded/pallas_ds_twist.py, _tak_quad_solve_tan_kernel
// (kernel B): K4's recursion running outward from the middle block on both
// streams, from K5's outputs, unmasked.  The windows start from the dense
// middle inverse z = [Z_Kuu, Z_P, Zdot_Kuu] (3, K, K) and x2 (K,):
//     F: cs[p-1][r] = Z[p-1+r][p-1],   x[p-1] = x2[p-1]
//     R: cs[p-1][r] = Z[K-p-r][K-p],   x[p-1] = x2[K-p]   (Z, x2 reversed)
// for p-1+r <= K-1, else 0.  Writes the bands of Kuu^-1, P^-1 and the
// tangent of Kuu^-1 in (K+1, m) layout, and u = P^-1 b (m,):
//     F column j -> band[r, j], u[j];
//     R column j -> band[r, m-1-j-r], u[m-1-j];
//     middle (columns h+t, rows t+r <= K-1) -> Z[t+r][t], u[h+t] = x2[t]
//       (by F's first chunk); right padding zeroed (by R's first chunk).
//
// What bounds it: as K5, a serial chain of column steps a stream (fma
// chains of depth K, no divide: the reciprocal pivots come from K5); one
// thread a stream took about 0.34 us a column.
//
// What the design does about it: given L, Ldot, iv and ivdot, what a
// stream carries is affine, so it is cut as tak_fwd (banded_adjoint.cu)
// is, on the scan of chunk_scan.cuh with a carry of 2D values, D =
// K(K+1)/2.  A Kuu matrix carries the D read entries of the window of S
// and of Sdot; Sdot's step reads S's window, so the joint map is
// [[H, 0], [H', H]] (Sdot's response to its own window is S's to its own):
// D + 1 chains build it.  A P matrix carries S's window and the upper
// solve's K-window, two independent blocks padded to 2D.  Three launches
// when a stream spans more than one chunk:
//   1. maps (tak_quad_chunk_kernel<K, true>), grid (chunks but the last,
//      4): lane d < D runs the chunk from the window e_d without the terms
//      that are not linear in it (d^2, 2 d td, bc d), lane D from the
//      window 0 with them; chunk 0's lane D starts from the seed, so its
//      map is H = 0 and y = its outgoing window, and the scan, which
//      starts from 0, starts at the seed.
//   2. scan (chunk_scan_kernel<2D, double>), one thread per matrix.
//   3. outputs (tak_quad_chunk_kernel<K, false>), grid (chunks, 4): lane 0
//      runs tak_tan_step from the true incoming window (the seed for
//      chunk 0, which is then the one-chain recursion bit for bit) and
//      writes the outputs.
// The scan stages every map of a matrix, (2D)^2 + 2D doubles each, which
// sets the chunk length (tak_quad_chunk_cols): 64 columns at K = 3, 320 at
// K = 6.
// ---------------------------------------------------------------------------

// Passes 1 (kMaps) and 3 over chunk j0 of matrix t, in the role kKuu:
// walk positions s..e-1, stream-local columns j = n-1-u; l is the
// matrix's own (K+1, h) factor.  kTaper is K4's form on its one stream
// (t = 0 Kuu, 1 P; h = m): rows j + q >= m zeroed, chunk 0 from the zero
// carry, no middle block.
template <int K, bool kKuu, bool kMaps, bool kTaper = false>
__device__ __forceinline__ void tak_quad_chunk(
    int m, int h, int lc, int nmap, int j0, int t, const double* __restrict__ l,
    const double* __restrict__ ldot, const double* __restrict__ iv,
    const double* __restrict__ ivdot, const double* __restrict__ y,
    const double* __restrict__ z, const double* __restrict__ x2, double* __restrict__ s_kuu,
    double* __restrict__ s_p, double* __restrict__ u, double* __restrict__ sdot,
    const double* __restrict__ win, double* __restrict__ hmap, double* __restrict__ ymap) {
  constexpr int D = K * (K + 1) / 2;
  constexpr int DD = 2 * D;
  constexpr int TR = kKuu ? K + 1 : 1;
  __shared__ double lt[2][K + 1][kTile];  // L columns of the positions
  __shared__ double tlt[2][TR][kTile];    // Ldot columns (Kuu)
  __shared__ double vt[2][2][kTile];      // iv and ivdot (Kuu), iv and y (P)
  const int lane = threadIdx.x;
  const int stream = t >> 1;
  const bool rev = stream == 1;
  const int n = rev ? m - h - K : h;
  const int s = j0 * lc;
  const int e = (s + lc < n) ? s + lc : n;
  const size_t ms = static_cast<size_t>(m);
  const size_t hs = static_cast<size_t>(h);
  if (kMaps && e == n) {
    // R's last chunk or past its end: no map; a zero one for the scan
    const size_t base = static_cast<size_t>(t) * nmap + j0;
    for (int idx = lane; idx < DD * DD; idx += 32) hmap[base * DD * DD + idx] = 0.0;
    for (int idx = lane; idx < DD; idx += 32) ymap[base * DD + idx] = 0.0;
    return;
  }
  if (s >= n) return;
  const double* __restrict__ tsrc = ldot + static_cast<size_t>(stream) * (K + 1) * hs;
  const double* __restrict__ ivs = iv + static_cast<size_t>(t) * hs;
  const double* __restrict__ vsrc = kKuu ? ivdot + stream * hs : y + stream * hs;
  double* __restrict__ s_out = kKuu ? s_kuu : s_p;

  TakWindow<K> st;
#pragma unroll
  for (int q = 0; q < K; ++q) {
    st.x[q] = 0.0;
#pragma unroll
    for (int r = 0; r <= K; ++r) st.cs[q][r] = st.tcs[q][r] = 0.0;
  }
  if (j0 == 0 && (!kMaps || lane == D)) {
    // the seed windows, from the middle inverse (K4: the zero carry)
    if constexpr (!kTaper) {
      const double* __restrict__ zs = z + (kKuu ? 0 : K * K);
      const double* __restrict__ zd = z + 2 * K * K;
#pragma unroll
      for (int q = 1; q <= K; ++q) {
        if constexpr (!kKuu) st.x[q - 1] = rev ? x2[K - q] : x2[q - 1];
#pragma unroll
        for (int r = 0; r <= K; ++r) {
          const bool inside = q - 1 + r <= K - 1;
          const int zi = rev ? (K - q - r) * K + (K - q) : (q - 1 + r) * K + (q - 1);
          st.cs[q - 1][r] = inside ? zs[zi] : 0.0;
          if constexpr (kKuu) st.tcs[q - 1][r] = inside ? zd[zi] : 0.0;
        }
      }
    }
  } else if (kMaps) {
    // lane d < D: window e_d (the solve's too, d < K)
    int d = 0;
#pragma unroll
    for (int c = 0; c < K; ++c) {
#pragma unroll
      for (int r = 0; r < K - c; ++r, ++d) st.cs[c][r] = (lane == d) ? 1.0 : 0.0;
    }
    if constexpr (!kKuu) {
#pragma unroll
      for (int q = 0; q < K; ++q) st.x[q] = (lane == q) ? 1.0 : 0.0;
    }
  } else {
    const double* wc = win + (static_cast<size_t>(t) * nmap + j0 - 1) * DD;
    int d = 0;
#pragma unroll
    for (int c = 0; c < K; ++c) {
#pragma unroll
      for (int r = 0; r < K - c; ++r, ++d) {
        st.cs[c][r] = wc[d];
        if constexpr (kKuu) st.tcs[c][r] = wc[D + d];
      }
    }
    if constexpr (!kKuu) {
#pragma unroll
      for (int q = 0; q < K; ++q) st.x[q] = wc[D + q];
    }
  }
  if (!kTaper && !kMaps && j0 == 0 && lane == 0) {
    if (!rev) {
      // the dense middle block, from the seed windows
#pragma unroll
      for (int c = 0; c < K; ++c) {
#pragma unroll
        for (int r = 0; r + c <= K - 1; ++r) {
          s_out[r * ms + h + c] = st.cs[c][r];
          if constexpr (kKuu) sdot[r * ms + h + c] = st.tcs[c][r];
        }
        if constexpr (!kKuu) u[h + c] = x2[c];
      }
    } else {
      // right padding: rows past the end of the last K columns
#pragma unroll
      for (int r = 1; r <= K; ++r) {
        for (int c = m - r; c < m; ++c) {
          s_out[r * ms + c] = 0.0;
          if constexpr (kKuu) sdot[r * ms + c] = 0.0;
        }
      }
    }
  }
  const double part = (!kMaps || lane == D) ? 1.0 : 0.0;
  double keep[K + 1];
#pragma unroll
  for (int r = 0; r <= K; ++r) keep[r] = 1.0;

  const int ntiles = (e - s + kTile - 1) / kTile;
  for (int tile = -1; tile < ntiles; ++tile) {
    // stage tile + 1 while tile runs
    if (tile + 1 < ntiles) {
      const int nb1 = (tile + 1) & 1;
      const int u1 = s + (tile + 1) * kTile;
      const int n1 = min(kTile, e - u1);
      stage_down<K + 1>(lt[nb1], l, h, n, u1, n1);
      if constexpr (kKuu) stage_down<K + 1>(tlt[nb1], tsrc, h, n, u1, n1);
      stage_down<1>(vt[nb1], ivs, h, n, u1, n1);
      stage_down<1>(vt[nb1] + 1, vsrc, h, n, u1, n1);
      cp_async_commit();
    }
    if (tile < 0) continue;
    const int buf = tile & 1;
    const int u0 = s + tile * kTile;
    const int cnt = min(kTile, e - u0);
    if (tile + 1 < ntiles) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    for (int tt = 0; tt < cnt; ++tt) {
      const int j = n - 1 - (u0 + tt);
      double lc[K + 1], tlc[K + 1];
#pragma unroll
      for (int r = 0; r <= K; ++r) {
        if constexpr (kTaper) keep[r] = (j + r < m) ? 1.0 : 0.0;
        lc[r] = lt[buf][r][tt];
        if constexpr (kKuu) {
          tlc[r] = tlt[buf][r][tt];
        } else {
          tlc[r] = 0.0;
        }
      }
      const double d = vt[buf][0][tt];
      const double td = kKuu ? vt[buf][1][tt] : 0.0;
      const double bc = kKuu ? 0.0 : vt[buf][1][tt];
      double col[K + 1], tcol[K + 1], uj = 0.0;
      tak_tan_step<K, kKuu, !kKuu, kMaps>(st, lc, tlc, d, td, bc, keep, col, tcol, uj, part);
      if (!kMaps && lane == 0) {
#pragma unroll
        for (int r = 0; r <= K; ++r) {
          const size_t o = r * ms + (rev ? m - 1 - j - r : j);
          s_out[o] = col[r];
          if constexpr (kKuu) sdot[o] = tcol[r];
        }
        if constexpr (!kKuu) u[rev ? m - 1 - j : j] = uj;
      }
    }
    __syncthreads();
  }

  if (kMaps) {
    // column lane of the (2D, 2D) map, row-major at hm, and y at ym: Kuu
    // [[H, 0], [H', H]], P [[H_S, 0], [0, H_u]] (H_u in rows and columns
    // D..D+K-1); chunk 0's H is 0
    const size_t base = static_cast<size_t>(t) * nmap + j0;
    double* __restrict__ hm = hmap + base * DD * DD;
    double* __restrict__ ym = ymap + base * DD;
    const bool live = j0 > 0;
    if (lane < D) {
      int d = 0;
#pragma unroll
      for (int c = 0; c < K; ++c) {
#pragma unroll
        for (int r = 0; r < K - c; ++r, ++d) {
          hm[d * DD + lane] = live ? st.cs[c][r] : 0.0;
          hm[(D + d) * DD + lane] = (kKuu && live) ? st.tcs[c][r] : 0.0;
          hm[d * DD + D + lane] = 0.0;
          hm[(D + d) * DD + D + lane] = (kKuu && live) ? st.cs[c][r] : 0.0;
        }
      }
      if constexpr (!kKuu) {
#pragma unroll
        for (int q = 0; q < K; ++q) {
          hm[(D + q) * DD + D + lane] = (live && lane < K) ? st.x[q] : 0.0;
        }
      }
    } else if (lane == D) {
      int d = 0;
#pragma unroll
      for (int c = 0; c < K; ++c) {
#pragma unroll
        for (int r = 0; r < K - c; ++r, ++d) {
          ym[d] = st.cs[c][r];
          ym[D + d] = kKuu ? st.tcs[c][r] : 0.0;
        }
      }
      if constexpr (!kKuu) {
#pragma unroll
        for (int q = 0; q < K; ++q) ym[D + q] = st.x[q];
      }
    }
  }
}

template <int K, bool kMaps>
__global__ void __launch_bounds__(32)
tak_quad_chunk_kernel(int m, int h, int lc, int nmap, const double* __restrict__ l,
                      const double* __restrict__ ldot, const double* __restrict__ iv,
                      const double* __restrict__ ivdot, const double* __restrict__ y,
                      const double* __restrict__ z, const double* __restrict__ x2,
                      double* __restrict__ s_kuu, double* __restrict__ s_p,
                      double* __restrict__ u, double* __restrict__ sdot,
                      const double* __restrict__ win, double* __restrict__ hmap,
                      double* __restrict__ ymap) {
  const int t = blockIdx.y;
  const double* lt = l + static_cast<size_t>(t) * (K + 1) * h;
  if ((t & 1) == 0) {
    tak_quad_chunk<K, true, kMaps>(m, h, lc, nmap, blockIdx.x, t, lt, ldot, iv, ivdot, y, z,
                                   x2, s_kuu, s_p, u, sdot, win, hmap, ymap);
  } else {
    tak_quad_chunk<K, false, kMaps>(m, h, lc, nmap, blockIdx.x, t, lt, ldot, iv, ivdot, y, z,
                                    x2, s_kuu, s_p, u, sdot, win, hmap, ymap);
  }
}

// ---------------------------------------------------------------------------
// K3: chol_pair_solve_tan<K>
//
// Replaces asvgp_tpu/banded/pallas_ds_tan.py, _chol_pair_solve_tan_kernel
// (kernel A' of factor_takahashi_solve_tan_ds): K1 (banded Cholesky of Kuu
// and P, lower solve L_P c0 = b, reciprocal pivots) plus the tangent of the
// Kuu factor and of its reciprocal pivots in the direction T, over all m
// columns, rows i + j >= m zeroed.
//
// What bounds it: as K5, the serial chain of Cholesky columns, here m long
// on each matrix; one thread a matrix (131 SMs idle) took about 2.5 ms at
// m = 10^4, K = 3 on an H100, 0.25 us a column.
//
// What the design does about it: grid (chunks, 2), one role a block
// (blockIdx.y: 0 Kuu, 1 P), chunks of chol_quad_chunk_cols(K, m) columns:
//   Kuu is K5's Kuu role (chol_quad_chunk<K, true, .., true>) on one
//      stream of all m columns, tapered: W walks as a dual number
//      (W, Wdot);
//   P is K1's P role unchanged (chol_fwd_chunk<K, double, .., true>,
//      forward_sweeps.cuh): W walks with the lower solve's coupling beta.
// Both write their triples at K5's stride and their carries at K5's (2D
// doubles), so K5's walk kernel walks both (one stream, h = m).  Three
// launches when m spans more than one chunk: triples (grid (chunks but
// the last, 2)), walk (one thread per matrix), factor (grid (chunks, 2)).
// The Kuu role runs chol_tan_step and the P role chol_fwd_step, which is
// chol_tan_step without the tangent: each matrix's first chunk (W = Wdot =
// 0, beta = 0) is the one-chain recursion bit for bit.
// ---------------------------------------------------------------------------
template <int K, bool kMaps>
__global__ void __launch_bounds__(32)
chol_pair_tan_chunk_kernel(int m, int lc, int nmap, const double* __restrict__ kuu,
                           const double* __restrict__ tan, const double* __restrict__ p,
                           const double* __restrict__ b, double* __restrict__ l_kuu,
                           double* __restrict__ l_p, double* __restrict__ iv,
                           double* __restrict__ c0, double* __restrict__ ldot,
                           double* __restrict__ ivdot, const double* __restrict__ win,
                           double* __restrict__ tri) {
  constexpr int D = K * (K + 1) / 2;
  const int j0 = blockIdx.x;
  if (blockIdx.y == 0) {
    chol_quad_chunk<K, true, kMaps, true>(m, m, lc, nmap, j0, 0, kuu, tan, nullptr, nullptr,
                                          l_kuu, ldot, iv, ivdot, nullptr, win, tri);
  } else {
    const size_t slot = static_cast<size_t>(nmap) + j0;
    const double* wc = (!kMaps && j0 > 0) ? win + (slot - 1) * 2 * D : nullptr;
    double* tc = kMaps ? tri + slot * kQuadTriStride<K> : nullptr;
    chol_fwd_chunk<K, double, kMaps, true>(m, lc, j0, p, b, l_p, iv + m, c0, wc, tc);
  }
}

// ---------------------------------------------------------------------------
// K4: tak_pair_solve_tan<K>
//
// Replaces asvgp_tpu/banded/pallas_ds_tan.py, _tak_pair_solve_tan_kernel
// (kernel B'): K2 (Takahashi bands of Kuu^-1 and P^-1, upper solve
// u = P^-1 b) plus the Takahashi tangent of the Kuu band, from K3's
// outputs, over the columns m-1..0.  Divide-free: every reciprocal pivot
// and its tangent comes from K3.
//
// What bounds it: as K6, a serial chain of column steps, here m long; one
// thread a matrix took about 2.3 ms at m = 10^4, K = 3 on an H100.
//
// What the design does about it: K6's partition (tak_quad_chunk<.., true>)
// on one stream of all m columns, tapered, both roles from the zero carry
// at column m-1 where K6 starts from the middle block's seed.  Kuu carries
// the windows of S and Sdot (2D values, map [[H, 0], [H', H]]), P those of
// S and of the upper solve (D + K, map diag(H_S, H_u), padded to 2D).  K2's
// P role (tak_fwd_chunk) runs a lane per carried value, and the one scan's
// 2D-value carry is 42 values at K = 6, more than a warp; K6's P role runs
// the unit windows of S and of u on the same D lanes, by the same column
// step.  The scan (chunk_scan_kernel<2D, double, D, true>) takes both roles
// and skips the upper-right block, zero in both maps.  Three launches when
// m spans more than one chunk (tak_quad_chunk_cols(K, m)): maps (grid
// (chunks but the last, 2)), scan, outputs (grid (chunks, 2)).  Each
// matrix's first chunk (the last columns) starts from the zero carry: the
// one-chain recursion bit for bit.
// ---------------------------------------------------------------------------
template <int K, bool kMaps>
__global__ void __launch_bounds__(32)
tak_pair_tan_chunk_kernel(int m, int lc, int nmap, const double* __restrict__ l_kuu,
                          const double* __restrict__ l_p, const double* __restrict__ iv,
                          const double* __restrict__ c0, const double* __restrict__ ldot,
                          const double* __restrict__ ivdot, double* __restrict__ s_kuu,
                          double* __restrict__ s_p, double* __restrict__ u,
                          double* __restrict__ sdot, const double* __restrict__ win,
                          double* __restrict__ hmap, double* __restrict__ ymap) {
  if (blockIdx.y == 0) {
    tak_quad_chunk<K, true, kMaps, true>(m, m, lc, nmap, blockIdx.x, 0, l_kuu, ldot, iv, ivdot,
                                         nullptr, nullptr, nullptr, s_kuu, nullptr, nullptr,
                                         sdot, win, hmap, ymap);
  } else {
    tak_quad_chunk<K, false, kMaps, true>(m, m, lc, nmap, blockIdx.x, 1, l_p, nullptr, iv,
                                          nullptr, c0, nullptr, nullptr, nullptr, s_p, u,
                                          nullptr, win, hmap, ymap);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// Columns per chunk of K5, for streams of at most h columns, and of K3
// (h = m, its P role's triple is shorter than Kuu's): at least
// ASVGP_SCHUR_CHUNK, at most kMaxChunks chunks and at most as many as the
// walk can stage the triples of (kQuadTriStride doubles each), a multiple
// of the tile; lc >= h is one chunk.  At m = 10^4 (h = 4999): 128 columns
// at every k, 40 chunks a stream.  At k = 3 on an H100, K5 took 0.088 /
// 0.093 / 0.115 / 0.142 ms of device time at 64 / 128 / 192 / 256 columns
// (tools/twist_ab.py --schur-chunk): 128 is K9's length, within 6 %.
int chol_quad_chunk_cols(int k, int h) {
  return partition_cols(2 * (static_cast<long>(k) * k + static_cast<long>(k) * (k + 1)),
                        ASVGP_SCHUR_CHUNK, h);
}

// Columns per chunk of K6 and of K4 (h = m): at least ASVGP_TAK_QUAD_CHUNK, at most kMaxChunks chunks
// and at most as many as the scan can stage the maps of ((2D)^2 + 2D
// doubles each, D = k(k+1)/2), a multiple of the tile.  At m = 10^4: 64
// columns for k <= 3, 128 at k = 4, 192 at k = 5, 320 at k = 6.  At k = 3
// on an H100, K6 took 0.069 / 0.067 / 0.079 / 0.095 ms of device time at
// 64 / 128 / 192 / 256 columns (tools/twist_ab.py --tak-chunk).
int tak_quad_chunk_cols(int k, int h) {
  const long dd = static_cast<long>(k) * (k + 1);
  return partition_cols(dd * dd + dd, ASVGP_TAK_QUAD_CHUNK, h);
}

// Doubles of workspace a Cholesky and a Takahashi sweep of nmat matrices
// on walks of at most h columns need (the larger): the Cholesky's triples
// (nmat, P-1, kQuadTriStride) and walked carries (nmat, P-1, k(k+1)); the
// Takahashi's maps H (nmat, P-1, (2D)^2), y and incoming windows (nmat,
// P-1, 2D) each; 0 when every walk is one chunk.  K5 and K6: four
// matrices on streams of h = (m - k + 1) / 2 columns; K3 and K4: two on m.
size_t tan_workspace(int k, int h, int nmat) {
  const size_t dd = static_cast<size_t>(k) * (k + 1);
  const size_t nc = static_cast<size_t>((h + chol_quad_chunk_cols(k, h) - 1) /
                                        chol_quad_chunk_cols(k, h) - 1);
  const size_t nt = static_cast<size_t>((h + tak_quad_chunk_cols(k, h) - 1) /
                                        tak_quad_chunk_cols(k, h) - 1);
  const size_t wc = nmat * nc * (2 * (static_cast<size_t>(k) * k + dd) + dd);
  const size_t wt = nmat * nt * (dd * dd + 2 * dd);
  return wc > wt ? wc : wt;
}

template <int K>
cudaError_t launch_chol_tan(int m, const double* kuu, const double* tan, const double* p,
                            const double* b, double* l_kuu, double* l_p, double* iv,
                            double* c0, double* ldot, double* ivdot, double* ws,
                            cudaStream_t st) {
  constexpr int kStride = kQuadTriStride<K>;
  const int lc = chol_quad_chunk_cols(K, m);
  const int nchunks = (m + lc - 1) / lc;
  const int nmap = nchunks - 1;
  const double* win = nullptr;
  if (nmap > 0) {
    if (ws == nullptr) return cudaErrorInvalidValue;
    double* tri = ws;
    double* w = tri + static_cast<size_t>(2) * nmap * kStride;
    chol_pair_tan_chunk_kernel<K, true><<<dim3(nmap, 2), 32, 0, st>>>(
        m, lc, nmap, kuu, tan, p, b, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
        nullptr, tri);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    const size_t smem = static_cast<size_t>(nmap) * kStride * sizeof(double);
    if (smem > kSmemLimit) return cudaErrorInvalidValue;
    static std::atomic<unsigned long long> done{0};
    e = allow_smem(chol_quad_walk_kernel<K>, done);
    if (e != cudaSuccess) return e;
    chol_quad_walk_kernel<K><<<dim3(1, 2), 32, smem, st>>>(m, m, lc, nmap, tri, w);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    win = w;
  }
  chol_pair_tan_chunk_kernel<K, false><<<dim3(nchunks, 2), 32, 0, st>>>(
      m, lc, nmap, kuu, tan, p, b, l_kuu, l_p, iv, c0, ldot, ivdot, win, nullptr);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_tak_tan(int m, const double* l_kuu, const double* l_p, const double* iv,
                           const double* c0, const double* ldot, const double* ivdot,
                           double* s_kuu, double* s_p, double* u, double* sdot, double* ws,
                           cudaStream_t st) {
  constexpr int D = K * (K + 1) / 2;
  constexpr int DD = 2 * D;
  const int lc = tak_quad_chunk_cols(K, m);
  const int nchunks = (m + lc - 1) / lc;
  const int nmap = nchunks - 1;
  const double* win = nullptr;
  if (nmap > 0) {
    if (ws == nullptr) return cudaErrorInvalidValue;
    const size_t hsz = static_cast<size_t>(nmap) * DD * DD;
    const size_t ysz = static_cast<size_t>(nmap) * DD;
    double* hmap = ws;
    double* ymap = hmap + 2 * hsz;
    double* w = ymap + 2 * ysz;
    tak_pair_tan_chunk_kernel<K, true><<<dim3(nmap, 2), 32, 0, st>>>(
        m, lc, nmap, l_kuu, l_p, iv, c0, ldot, ivdot, nullptr, nullptr, nullptr, nullptr,
        nullptr, hmap, ymap);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    e = launch_chunk_scan<DD, double, D, true>(1, 2, nmap, hmap, hsz, ymap, ysz, w, st);
    if (e != cudaSuccess) return e;
    win = w;
  }
  tak_pair_tan_chunk_kernel<K, false><<<dim3(nchunks, 2), 32, 0, st>>>(
      m, lc, nmap, l_kuu, l_p, iv, c0, ldot, ivdot, s_kuu, s_p, u, sdot, win, nullptr, nullptr);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_chol_quad(int m, int h, const double* kuu, const double* tan,
                             const double* p, const double* b, double* l,
                             double* ldot, double* iv, double* ivdot, double* y,
                             double* ws, cudaStream_t st) {
  constexpr int D = K * (K + 1) / 2;
  constexpr int kStride = kQuadTriStride<K>;
  const int lc = chol_quad_chunk_cols(K, h);
  const int nchunks = (h + lc - 1) / lc;
  const int nmap = nchunks - 1;
  const double* win = nullptr;
  if (nmap > 0) {
    if (ws == nullptr) return cudaErrorInvalidValue;
    double* tri = ws;
    double* w = tri + static_cast<size_t>(4) * nmap * kStride;
    chol_quad_chunk_kernel<K, true><<<dim3(nmap, 4), 32, 0, st>>>(
        m, h, lc, nmap, kuu, tan, p, b, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
        tri);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    const size_t smem = static_cast<size_t>(nmap) * kStride * sizeof(double);
    if (smem > kSmemLimit) return cudaErrorInvalidValue;
    static std::atomic<unsigned long long> done{0};
    e = allow_smem(chol_quad_walk_kernel<K>, done);
    if (e != cudaSuccess) return e;
    chol_quad_walk_kernel<K><<<dim3(1, 4), 32, smem, st>>>(m, h, lc, nmap, tri, w);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    win = w;
  }
  static_assert(2 * D <= kStride, "the walked carry fits a triple's stride");
  chol_quad_chunk_kernel<K, false><<<dim3(nchunks, 4), 32, 0, st>>>(
      m, h, lc, nmap, kuu, tan, p, b, l, ldot, iv, ivdot, y, win, nullptr);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_tak_quad(int m, int h, const double* l, const double* ldot,
                            const double* iv, const double* ivdot,
                            const double* y, const double* z, const double* x2,
                            double* s_kuu, double* s_p, double* u, double* sdot,
                            double* ws, cudaStream_t st) {
  constexpr int DD = K * (K + 1);
  const int lc = tak_quad_chunk_cols(K, h);
  const int nchunks = (h + lc - 1) / lc;
  const int nmap = nchunks - 1;
  const double* win = nullptr;
  if (nmap > 0) {
    if (ws == nullptr) return cudaErrorInvalidValue;
    const size_t hsz = static_cast<size_t>(nmap) * DD * DD;
    const size_t ysz = static_cast<size_t>(nmap) * DD;
    double* hmap = ws;
    double* ymap = hmap + 4 * hsz;
    double* w = ymap + 4 * ysz;
    tak_quad_chunk_kernel<K, true><<<dim3(nmap, 4), 32, 0, st>>>(
        m, h, lc, nmap, l, ldot, iv, ivdot, y, z, x2, nullptr, nullptr, nullptr, nullptr,
        nullptr, hmap, ymap);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    e = launch_chunk_scan<DD, double>(1, 4, nmap, hmap, hsz, ymap, ysz, w, st);
    if (e != cudaSuccess) return e;
    win = w;
  }
  tak_quad_chunk_kernel<K, false><<<dim3(nchunks, 4), 32, 0, st>>>(
      m, h, lc, nmap, l, ldot, iv, ivdot, y, z, x2, s_kuu, s_p, u, sdot, win, nullptr, nullptr);
  return cudaGetLastError();
}

// The twisted split the kernels assume: h = (m - K + 1) / 2 and both streams
// at least 2K columns long (twist_applicable).
bool twist_split_ok(int k, int m, int h) {
  const int g = m - h - k;
  return h == (m - k + 1) / 2 && h >= 2 * k && g >= 2 * k;
}

}  // namespace

extern "C" {

// Doubles of workspace K3 and K4 need at (k, m): 0 when the columns form
// one chunk of each.
int asvgp_tan_workspace(int k, int m) {
  if (k < 1 || k > 6 || m < 1) return -1;
  return static_cast<int>(tan_workspace(k, m, 2));
}

// K3.  kuu, tan, p: (k+1, m) lower bands; b: (m,); ws: asvgp_tan_workspace(k,
// m) doubles, or NULL when that is 0.  Writes l_kuu, l_p, ldot (k+1, m), iv
// (2, m), c0 (m,), ivdot (m,).
int asvgp_chol_pair_solve_tan(int k, int m, const double* kuu, const double* tan,
                              const double* p, const double* b, double* l_kuu, double* l_p,
                              double* iv, double* c0, double* ldot, double* ivdot, double* ws,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1) return static_cast<int>(cudaErrorInvalidValue);
  ASVGP_DISPATCH_K(k, (launch_chol_tan<K>(m, kuu, tan, p, b, l_kuu, l_p, iv, c0, ldot, ivdot,
                                              ws, s)))
}

// K4.  K3's outputs in; ws as for K3.  Writes s_kuu, s_p, sdot (k+1, m) and
// u (m,).
int asvgp_tak_pair_solve_tan(int k, int m, const double* l_kuu, const double* l_p,
                             const double* iv, const double* c0, const double* ldot,
                             const double* ivdot, double* s_kuu, double* s_p, double* u,
                             double* sdot, double* ws, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1) return static_cast<int>(cudaErrorInvalidValue);
  ASVGP_DISPATCH_K(k, (launch_tak_tan<K>(m, l_kuu, l_p, iv, c0, ldot, ivdot, s_kuu, s_p, u,
                                             sdot, ws, s)))
}

// Doubles of workspace K5 and K6 need at (k, m): 0 when every stream is one
// chunk, -1 when (k, m) has no twisted split.
int asvgp_twist_workspace(int k, int m) {
  if (k < 1 || k > 6 || !twist_split_ok(k, m, (m - k + 1) / 2)) return -1;
  return static_cast<int>(tan_workspace(k, (m - k + 1) / 2, 4));
}

// K5.  kuu, tan, p: (k+1, m); b: (m,); h = split point; ws:
// asvgp_twist_workspace(k, m) doubles, or NULL when that is 0.  Writes l
// (4, k+1, h), ldot (2, k+1, h), iv (4, h), ivdot (2, h), y (2, h).
int asvgp_chol_quad_solve_tan(int k, int m, int h, const double* kuu,
                              const double* tan, const double* p,
                              const double* b, double* l, double* ldot,
                              double* iv, double* ivdot, double* y, double* ws,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!twist_split_ok(k, m, h)) return static_cast<int>(cudaErrorInvalidValue);
  ASVGP_DISPATCH_K(k, (launch_chol_quad<K>(m, h, kuu, tan, p, b, l, ldot, iv, ivdot, y,
                                               ws, s)))
}

// K6.  K5's outputs, z (3, k, k) = [Z_Kuu, Z_P, Zdot_Kuu] and x2 (k,) in;
// ws as for K5.  Writes s_kuu, s_p, sdot (k+1, m) and u (m,).
int asvgp_tak_quad_solve_tan(int k, int m, int h, const double* l,
                             const double* ldot, const double* iv,
                             const double* ivdot, const double* y,
                             const double* z, const double* x2, double* s_kuu,
                             double* s_p, double* u, double* sdot, double* ws,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!twist_split_ok(k, m, h)) return static_cast<int>(cudaErrorInvalidValue);
  ASVGP_DISPATCH_K(k, (launch_tak_quad<K>(m, h, l, ldot, iv, ivdot, y, z, x2, s_kuu, s_p,
                                              u, sdot, ws, s)))
}

}  // extern "C"
