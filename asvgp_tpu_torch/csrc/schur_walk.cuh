// The Schur-complement partition of a banded Cholesky sweep, shared by the
// single-matrix sweep chol_fwd<K, T> (forward_sweeps.cuh: K9, K15, K17 and
// the serving sweep K1) and the twisted tangent sweep
// chol_quad_solve_tan<K> (banded_tan.cu: K5).
//
// A chunk of columns c0..c1-1 receives from the columns before it only the
// K x K update W = L[c0:c0+K, :c0] L[c0:c0+K, :c0]^T of its first K rows;
// over the chunk, W maps to the next chunk's by a Riccati map fixed by a
// triple of K x K matrices of the chunk's diagonal block A_c alone (see
// chol_fwd in forward_sweeps.cuh):
//   W' = R + Q^T (I - W P)^-1 W Q,   P = (A_c^-1)[:K, :K] = U U^T.
// Pass 1 computes the triple along the chunk's plain recursion from W = 0
// (schur_v_row, schur_triple), pass 2 walks W over the chunks
// (schur_step, schur_walk), pass 3 reruns each chunk with W subtracted.  Every helper
// is generic in the number type T: float and double for chol_fwd, and K5's
// forward-mode dual number for its Kuu tangent, so that the tangent of
// every step is the same code run on (value, tangent) pairs.

#pragma once

#include <cuda_runtime.h>

#include "chunk_scan.cuh"

// The Cholesky sweeps' chunks are at least this many columns (a multiple
// of the 64-column tile); a build may set it to measure another length
// (tools/forward_ab.py and tools/twist_ab.py --schur-chunk).
#ifndef ASVGP_SCHUR_CHUNK
#define ASVGP_SCHUR_CHUNK 128
#endif

namespace {

// the scalar type's fused multiply-add and square root (IEEE-rounded: the
// library is built without fast math), so a float instantiation never
// promotes to double
__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float sqrt_t(float a) { return sqrtf(a); }
__device__ __forceinline__ double sqrt_t(double a) { return sqrt(a); }
__device__ __forceinline__ float rsqrt_t(float a) { return rsqrtf(a); }
__device__ __forceinline__ double rsqrt_t(double a) { return rsqrt(a); }

// The lower Cholesky factor of the K x K symmetric matrix whose lower
// triangle f holds, in place, and the reciprocals rd of its diagonal; the
// strict upper triangle is set to 0.  One reciprocal square root a
// column, so a pivot <= 0 gives NaN (or inf at 0) from its column on.
template <int K, typename T>
__device__ __forceinline__ void chol_small(T (&f)[K][K], T (&rd)[K]) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    T dj = f[j][j];
#pragma unroll
    for (int p = 0; p < j; ++p) dj = fma_t(-f[j][p], f[j][p], dj);
    rd[j] = rsqrt_t(dj);
    f[j][j] = dj * rd[j];
#pragma unroll
    for (int i = j + 1; i < K; ++i) {
      T x = f[i][j];
#pragma unroll
      for (int p = 0; p < j; ++p) x = fma_t(-f[i][p], f[j][p], x);
      f[i][j] = x * rd[j];
    }
#pragma unroll
    for (int i = 0; i < j; ++i) f[i][j] = T(0);
  }
}

// Pass 1, one column t of the chunk: row t of V = L_c^-1 E,
//   vn[f] = (delta_{t, f} - sum_p L[i, i-p] V[t-p, f]) / L[i, i],
// from g[p-1] = L[i, i-p] and rv = 1 / L[i, i]; adds vn vn^T to P's upper
// triangle pa and pushes vn into the window vw (vw[p-1] = V row t-p).
template <int K, typename T>
__device__ __forceinline__ void schur_v_row(const T (&g)[K], T rv, int t, T (&vw)[K][K],
                                            T (&pa)[K][K], T (&vn)[K]) {
#pragma unroll
  for (int f = 0; f < K; ++f) {
    T acc = (t == f) ? T(1) : T(0);
#pragma unroll
    for (int p = 1; p <= K; ++p) acc = fma_t(-g[p - 1], vw[p - 1][f], acc);
    vn[f] = acc * rv;
  }
#pragma unroll
  for (int f = 0; f < K; ++f) {
#pragma unroll
    for (int h = f; h < K; ++h) pa[f][h] = fma_t(vn[f], vn[h], pa[f][h]);
  }
#pragma unroll
  for (int q = K - 1; q > 0; --q) {
#pragma unroll
    for (int f = 0; f < K; ++f) vw[q][f] = vw[q - 1][f];
  }
#pragma unroll
  for (int f = 0; f < K; ++f) vw[0][f] = vn[f];
}

// Pass 1, after the chunk's last column e-1: its triple, packed at o as
// U's lower triangle by rows (D values), Q (K x K, row-major) and R's upper
// triangle by rows (D), from the factor's window w (w[q-1][r] =
// L[e-q+r, e-q]), V's last rows vw and P's upper triangle pa.  With
// X[a][b] = L_c[e+a, e-K+b] = w[K-1-b][K+a-b] (a <= b, else 0) and
// V_last[b][f] = vw[K-1-b][f]: U = chol(P), Q = V_last^T X^T, R = X X^T.
template <int K, typename T>
__device__ __forceinline__ void schur_triple(const T (&w)[K][K + 1], const T (&vw)[K][K],
                                             const T (&pa)[K][K], T* __restrict__ o) {
  T u[K][K];
#pragma unroll
  for (int f = 0; f < K; ++f) {
#pragma unroll
    for (int h = 0; h <= f; ++h) u[f][h] = pa[h][f];
  }
  T rd[K];
  chol_small<K, T>(u, rd);
  int d = 0;
#pragma unroll
  for (int r = 0; r < K; ++r) {
#pragma unroll
    for (int c = 0; c <= r; ++c) o[d++] = u[r][c];
  }
#pragma unroll
  for (int f = 0; f < K; ++f) {
#pragma unroll
    for (int x = 0; x < K; ++x) {
      T acc = T(0);
#pragma unroll
      for (int b = x; b < K; ++b) acc = fma_t(vw[K - 1 - b][f], w[K - 1 - b][K + x - b], acc);
      o[d++] = acc;  // Q[f][x]
    }
  }
#pragma unroll
  for (int x = 0; x < K; ++x) {
#pragma unroll
    for (int y = x; y < K; ++y) {
      T acc = T(0);
#pragma unroll
      for (int b = y; b < K; ++b) acc = fma_t(w[K - 1 - b][K + x - b], w[K - 1 - b][K + y - b], acc);
      o[d++] = acc;  // R[x][y]
    }
  }
}

// Pass 1 with a lower solve, after the chunk's last column e-1: the solve's
// part of the triple, at o (after R): p0 = V^T y0 as accumulated along the
// chunk, then r0 = X y0_last, r0[a] = sum_b X[a][b] y0[e-K+b], from the
// factor's window w (X as in schur_triple) and the solve's window x
// (x[q-1] = y0[e-q]).
template <int K, typename T>
__device__ __forceinline__ void schur_solve_tail(const T (&w)[K][K + 1], const T (&x)[K],
                                                 const T (&p0)[K], T* __restrict__ o) {
#pragma unroll
  for (int f = 0; f < K; ++f) o[f] = p0[f];
#pragma unroll
  for (int a = 0; a < K; ++a) {
    T acc = T(0);
#pragma unroll
    for (int b = a; b < K; ++b) acc = fma_t(w[K - 1 - b][K + a - b], x[K - 1 - b], acc);
    o[K + a] = acc;
  }
}

// One step of pass 2: W (K x K, symmetric) through the chunk whose triple
// is at cur (U's lower triangle by rows, Q[f][x] at D + f K + x, R's upper
// triangle by rows) to the next chunk's, written also at wout (packed as
// R).  With U = chol(P), G = [U Q]^T W [U Q] and F = chol(I - G11):
//   W' = R + G22 + Y^T Y,  Y = F^-1 G12.
// kSolve also carries a lower solve's coupling beta = L[c0:c0+K, :c0]
// y[:c0] = C A[:c0, :c0]^-1 b[:c0] (C the chunk's coupling rows), from
// p0 = (A_c^-1 b_c)[:K] and r0 = X (L_c^-1 b_c)[last K], the K values each
// after R at cur; by Woodbury's identity for (A_c - E W E^T)^-1,
//   beta' = r0 + (W Q)^T d + Y^T z - Q^T beta,
//   d = p0 - U U^T beta,  z = F^-1 (W U)^T d,
// written at wout + D.
template <int K, typename T, bool kSolve = false>
__device__ __forceinline__ void schur_step(T (&W)[K][K], const T* cur, T* __restrict__ wout,
                                           T* beta = nullptr) {
  constexpr int D = K * (K + 1) / 2;
  T u[K][K];
  {
    int d = 0;
#pragma unroll
    for (int r = 0; r < K; ++r) {
#pragma unroll
      for (int cc = 0; cc < K; ++cc) u[r][cc] = (cc <= r) ? cur[d + cc] : T(0);
      d += r + 1;
    }
  }
  const T* q = cur + D;
  const T* rp = q + K * K;
  // WU = W U, then F = chol(I - U^T W U)
  T wu[K][K];
#pragma unroll
  for (int x = 0; x < K; ++x) {
#pragma unroll
    for (int y = 0; y < K; ++y) {
      T acc = T(0);
#pragma unroll
      for (int z = y; z < K; ++z) acc = fma_t(W[x][z], u[z][y], acc);
      wu[x][y] = acc;
    }
  }
  T f[K][K];
#pragma unroll
  for (int x = 0; x < K; ++x) {
#pragma unroll
    for (int y = 0; y <= x; ++y) {
      T acc = (x == y) ? T(1) : T(0);
#pragma unroll
      for (int z = x; z < K; ++z) acc = fma_t(-u[z][x], wu[z][y], acc);
      f[x][y] = acc;
    }
  }
  T rd[K];
  chol_small<K, T>(f, rd);
  // Y = F^-1 U^T W Q = F^-1 WU^T Q, and WQ = W Q
  T yy[K][K];
  T wq[K][K];
#pragma unroll
  for (int x = 0; x < K; ++x) {
#pragma unroll
    for (int y = 0; y < K; ++y) {
      T acc = T(0);
      T acq = T(0);
#pragma unroll
      for (int z = 0; z < K; ++z) {
        acc = fma_t(wu[z][x], q[z * K + y], acc);
        acq = fma_t(W[x][z], q[z * K + y], acq);
      }
      yy[x][y] = acc;
      wq[x][y] = acq;
    }
  }
#pragma unroll
  for (int x = 0; x < K; ++x) {
#pragma unroll
    for (int y = 0; y < K; ++y) {
      T acc = yy[x][y];
#pragma unroll
      for (int z = 0; z < x; ++z) acc = fma_t(-f[x][z], yy[z][y], acc);
      yy[x][y] = acc * rd[x];
    }
  }
  if constexpr (kSolve) {
    const T* p0 = rp + D;
    const T* r0 = p0 + K;
    T ub[K];  // U^T beta
#pragma unroll
    for (int x = 0; x < K; ++x) {
      T acc = T(0);
#pragma unroll
      for (int z = x; z < K; ++z) acc = fma_t(u[z][x], beta[z], acc);
      ub[x] = acc;
    }
    T dv[K];
#pragma unroll
    for (int x = 0; x < K; ++x) {
      T acc = p0[x];
#pragma unroll
      for (int y = 0; y <= x; ++y) acc = fma_t(-u[x][y], ub[y], acc);
      dv[x] = acc;
    }
    T zz[K];
#pragma unroll
    for (int x = 0; x < K; ++x) {
      T acc = T(0);
#pragma unroll
      for (int z = 0; z < K; ++z) acc = fma_t(wu[z][x], dv[z], acc);
#pragma unroll
      for (int z = 0; z < x; ++z) acc = fma_t(-f[x][z], zz[z], acc);
      zz[x] = acc * rd[x];
    }
    T nb[K];
#pragma unroll
    for (int y = 0; y < K; ++y) {
      T acc = r0[y];
#pragma unroll
      for (int z = 0; z < K; ++z) {
        acc = fma_t(wq[z][y], dv[z], acc);
        acc = fma_t(yy[z][y], zz[z], acc);
        acc = fma_t(-q[z * K + y], beta[z], acc);
      }
      nb[y] = acc;
    }
#pragma unroll
    for (int y = 0; y < K; ++y) {
      beta[y] = nb[y];
      wout[D + y] = nb[y];
    }
  }
  // W' = R + Q^T W Q + Y^T Y, symmetric: the upper triangle, mirrored
  int d = 0;
#pragma unroll
  for (int x = 0; x < K; ++x) {
#pragma unroll
    for (int y = x; y < K; ++y) {
      T acc = rp[d];
#pragma unroll
      for (int z = 0; z < K; ++z) {
        acc = fma_t(q[z * K + x], wq[z][y], acc);
        acc = fma_t(yy[z][x], yy[z][y], acc);
      }
      W[x][y] = acc;
      W[y][x] = acc;
      wout[d] = acc;
      ++d;
    }
  }
}

// Pass 2 for one matrix: its nmap triples (tstride values apart, from tri)
// staged in ts, shared memory, then one thread walks W (and, kSolve, beta)
// from 0 and writes the carry of chunk c + 1 (W packed as R, then beta) at
// win + c wstride.  Up to K = 3 the next chunk's triple of scalars is read
// into registers while the current one's step runs; beyond, and for dual
// numbers, it would not fit beside the step's.
template <int K, typename T, bool kSolve>
__device__ __forceinline__ void schur_walk(int nmap, const T* __restrict__ tri, int tstride,
                                           T* __restrict__ win, int wstride, T* ts) {
  constexpr int D = K * (K + 1) / 2;
  constexpr int kTri = K * K + 2 * D + (kSolve ? 2 * K : 0);
  for (int idx = threadIdx.x; idx < nmap * tstride; idx += 32) cp_async(&ts[idx], tri + idx);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (threadIdx.x != 0) return;

  T W[K][K];
  T beta[K];
#pragma unroll
  for (int x = 0; x < K; ++x) {
    beta[x] = T(0);
#pragma unroll
    for (int y = 0; y < K; ++y) W[x][y] = T(0);
  }
  if constexpr (K <= 3 && sizeof(T) <= sizeof(double)) {
    T nx[kTri];
#pragma unroll
    for (int i = 0; i < kTri; ++i) nx[i] = ts[i];
    for (int c = 0; c < nmap; ++c) {
      T cur[kTri];
#pragma unroll
      for (int i = 0; i < kTri; ++i) cur[i] = nx[i];
      if (c + 1 < nmap) {
#pragma unroll
        for (int i = 0; i < kTri; ++i) nx[i] = ts[(c + 1) * tstride + i];
      }
      schur_step<K, T, kSolve>(W, cur, win + c * wstride, beta);
    }
  } else {
    for (int c = 0; c < nmap; ++c) {
      schur_step<K, T, kSolve>(W, ts + c * tstride, win + c * wstride, beta);
    }
  }
}

}  // namespace
