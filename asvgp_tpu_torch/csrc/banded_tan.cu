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
// What the design does about it: as K1 and K2, one thread per matrix in one
// warp, the K-column windows of the factor, its tangent and the solve in
// registers, fully unrolled for the compile-time K, the next column's
// inputs loaded one step ahead.  The tangent chains hang off the primal
// values and add multiplies and adds but no sqrt or divide.  The P thread
// runs the tangent too, on the same T, and drops it (the "dead lane" of the
// TPU kernels), which keeps the warp converged; likewise the Kuu thread runs
// the solve and drops it.  The twisted kernels run two such pairs, one per
// stream, in four threads of one warp: each stream walks about m/2 columns,
// half the serial depth.  The TPU kernels' float32 hi/lo pairs, lane
// interleave, 128-column tiles, one-hot row masks and seed columns are TPU
// layout work with no counterpart here: the seeds of K6 are loaded into the
// register windows before the first column.

#include <cuda_runtime.h>

#include <cstddef>

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
template <int K>
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
    sb = fma(g, st.x[q - 1], sb);
#pragma unroll
    for (int j = 0; j + q <= K; ++j) {
      s[j] = fma(g, st.w[q - 1][q + j], s[j]);
      ts[j] = fma(tg, st.w[q - 1][q + j], fma(g, st.tw[q - 1][q + j], ts[j]));
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
  xi = (bc - sb) * r;
  const double e = -0.5 * r * r * (tc[0] - ts[0]);
#pragma unroll
  for (int j = 0; j <= K; ++j) {
    tcol[j] = fma(tc[j] - ts[j], r, col[j] * e) * keep[j];
  }
  tiv = r * e;

#pragma unroll
  for (int q = K - 1; q > 0; --q) {
    st.x[q] = st.x[q - 1];
#pragma unroll
    for (int rr = 0; rr <= K; ++rr) {
      st.w[q][rr] = st.w[q - 1][rr];
      st.tw[q][rr] = st.tw[q - 1][rr];
    }
  }
  st.x[0] = xi;
#pragma unroll
  for (int rr = 0; rr <= K; ++rr) {
    st.w[0][rr] = col[rr];
    st.tw[0][rr] = tcol[rr];
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
// solve entry uj; pushes the window.
template <int K>
__device__ __forceinline__ void tak_tan_step(
    TakWindow<K>& st, const double (&lc)[K + 1], const double (&tlc)[K + 1],
    double d, double td, double bc, const double (&keep)[K + 1],
    double (&col)[K + 1], double (&tcol)[K + 1], double& uj) {
  double sb = 0.0;
#pragma unroll
  for (int q = 1; q <= K; ++q) sb = fma(lc[q], st.x[q - 1], sb);
  uj = (bc - sb) * d;

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
      tacc = fma(st.tcs[lo - 1][df], lc[p], fma(st.cs[lo - 1][df], tlc[p], tacc));
    }
    sq[q] = -d * acc;
    tsq[q] = -fma(tacc, d, acc * td);
  }
  double ws = 0.0, tws = 0.0;
#pragma unroll
  for (int q = 1; q <= K; ++q) {
    ws = fma(lc[q], sq[q], ws);
    tws = fma(tlc[q], sq[q], fma(lc[q], tsq[q], tws));
  }
  col[0] = d * d - d * ws;
  tcol[0] = 2.0 * d * td - fma(tws, d, ws * td);
#pragma unroll
  for (int q = 1; q <= K; ++q) {
    col[q] = sq[q] * keep[q];
    tcol[q] = tsq[q] * keep[q];
  }

#pragma unroll
  for (int q = K - 1; q > 0; --q) {
    st.x[q] = st.x[q - 1];
#pragma unroll
    for (int rr = 0; rr <= K; ++rr) {
      st.cs[q][rr] = st.cs[q - 1][rr];
      st.tcs[q][rr] = st.tcs[q - 1][rr];
    }
  }
  st.x[0] = uj;
#pragma unroll
  for (int rr = 0; rr <= K; ++rr) {
    st.cs[0][rr] = col[rr];
    st.tcs[0][rr] = tcol[rr];
  }
}

// ---------------------------------------------------------------------------
// K3: chol_pair_solve_tan<K>
//
// Replaces asvgp_tpu/banded/pallas_ds_tan.py, _chol_pair_solve_tan_kernel
// (kernel A' of factor_takahashi_solve_tan_ds): K1 (banded Cholesky of Kuu
// and P, lower solve L_P c0 = b, reciprocal pivots) plus the tangent of the
// Kuu factor and of its reciprocal pivots in the direction T.  Thread 0
// walks Kuu, thread 1 walks P; rows i + j >= m are zeroed.
// ---------------------------------------------------------------------------
template <int K>
__global__ void __launch_bounds__(32)
chol_pair_solve_tan_kernel(int m, const double* __restrict__ kuu,
                           const double* __restrict__ tan,
                           const double* __restrict__ p,
                           const double* __restrict__ b,
                           double* __restrict__ l_kuu, double* __restrict__ l_p,
                           double* __restrict__ iv, double* __restrict__ c0,
                           double* __restrict__ ldot,
                           double* __restrict__ ivdot) {
  const int t = threadIdx.x;
  if (t >= 2) return;
  const double* __restrict__ a = (t == 0) ? kuu : p;
  double* __restrict__ l = (t == 0) ? l_kuu : l_p;
  double* __restrict__ ivt = iv + static_cast<size_t>(t) * m;
  const size_t ms = static_cast<size_t>(m);

  CholWindow<K> st;
  chol_window_zero(st);
  double an[K + 1], tn[K + 1];
#pragma unroll
  for (int r = 0; r <= K; ++r) {
    an[r] = a[r * ms];
    tn[r] = tan[r * ms];
  }
  double bn = b[0];

  for (int i = 0; i < m; ++i) {
    double ac[K + 1], tc[K + 1], keep[K + 1];
#pragma unroll
    for (int r = 0; r <= K; ++r) {
      ac[r] = an[r];
      tc[r] = tn[r];
      keep[r] = (i + r < m) ? 1.0 : 0.0;
    }
    const double bc = bn;
    if (i + 1 < m) {
#pragma unroll
      for (int r = 0; r <= K; ++r) {
        an[r] = a[r * ms + i + 1];
        tn[r] = tan[r * ms + i + 1];
      }
      bn = b[i + 1];
    }
    double col[K + 1], tcol[K + 1], rp, tiv, xi;
    chol_tan_step<K>(st, ac, tc, bc, keep, col, tcol, rp, tiv, xi);
#pragma unroll
    for (int j = 0; j <= K; ++j) l[j * ms + i] = col[j];
    ivt[i] = rp;
    if (t == 0) {
#pragma unroll
      for (int j = 0; j <= K; ++j) ldot[j * ms + i] = tcol[j];
      ivdot[i] = tiv;
    } else {
      c0[i] = xi;
    }
  }
}

// ---------------------------------------------------------------------------
// K4: tak_pair_solve_tan<K>
//
// Replaces asvgp_tpu/banded/pallas_ds_tan.py, _tak_pair_solve_tan_kernel
// (kernel B'): K2 (Takahashi bands of Kuu^-1 and P^-1, upper solve
// u = P^-1 b) plus the Takahashi tangent of the Kuu band, from K3's outputs.
// Divide-free: every reciprocal pivot and its tangent comes from K3.
// ---------------------------------------------------------------------------
template <int K>
__global__ void __launch_bounds__(32)
tak_pair_solve_tan_kernel(int m, const double* __restrict__ l_kuu,
                          const double* __restrict__ l_p,
                          const double* __restrict__ iv,
                          const double* __restrict__ c0,
                          const double* __restrict__ ldot,
                          const double* __restrict__ ivdot,
                          double* __restrict__ s_kuu, double* __restrict__ s_p,
                          double* __restrict__ u, double* __restrict__ sdot) {
  const int t = threadIdx.x;
  if (t >= 2) return;
  const double* __restrict__ l = (t == 0) ? l_kuu : l_p;
  double* __restrict__ s_out = (t == 0) ? s_kuu : s_p;
  const double* __restrict__ ivt = iv + static_cast<size_t>(t) * m;
  const size_t ms = static_cast<size_t>(m);

  TakWindow<K> st;
#pragma unroll
  for (int q = 0; q < K; ++q) {
    st.x[q] = 0.0;
#pragma unroll
    for (int r = 0; r <= K; ++r) st.cs[q][r] = st.tcs[q][r] = 0.0;
  }

  double ln[K + 1], tln[K + 1];
#pragma unroll
  for (int r = 0; r <= K; ++r) {
    ln[r] = l[r * ms + (m - 1)];
    tln[r] = ldot[r * ms + (m - 1)];
  }
  double dn = ivt[m - 1], tdn = ivdot[m - 1], bn = c0[m - 1];

  for (int j = m - 1; j >= 0; --j) {
    double lc[K + 1], tlc[K + 1], keep[K + 1];
#pragma unroll
    for (int r = 0; r <= K; ++r) {
      lc[r] = ln[r];
      tlc[r] = tln[r];
      keep[r] = (j + r < m) ? 1.0 : 0.0;
    }
    const double d = dn, td = tdn, bc = bn;
    if (j > 0) {
#pragma unroll
      for (int r = 0; r <= K; ++r) {
        ln[r] = l[r * ms + (j - 1)];
        tln[r] = ldot[r * ms + (j - 1)];
      }
      dn = ivt[j - 1];
      tdn = ivdot[j - 1];
      bn = c0[j - 1];
    }
    double col[K + 1], tcol[K + 1], uj;
    tak_tan_step<K>(st, lc, tlc, d, td, bc, keep, col, tcol, uj);
#pragma unroll
    for (int r = 0; r <= K; ++r) s_out[r * ms + j] = col[r];
    if (t == 0) {
#pragma unroll
      for (int r = 0; r <= K; ++r) sdot[r * ms + j] = tcol[r];
    } else {
      u[j] = uj;
    }
  }
}

// ---------------------------------------------------------------------------
// K5: chol_quad_solve_tan<K>
//
// Replaces asvgp_tpu/banded/pallas_ds_twist.py, _chol_quad_solve_tan_kernel
// (kernel A of factor_takahashi_solve_tan_twist): K3 on two independent
// streams, F on columns 0..h-1 of (Kuu, T, P, b) and R on columns 0..g-1 of
// the index-reversed bands (band'[r, j] = band[r, m-1-r-j], read in place)
// and of b reversed, g = m - h - K.  Thread t: stream t >> 1 (F, R), matrix
// t & 1 (Kuu, P).  No row taper: the last K columns of a stream keep their
// rows h.. (the spill L21 into the middle block, which the mid step reads).
//
// Outputs, stream-local over h columns (R's column h-1 is zero when g < h):
// l (4, K+1, h) = [F Kuu, F P, R Kuu, R P], iv (4, h), ldot (2, K+1, h) and
// ivdot (2, h) of [F Kuu, R Kuu], y (2, h) = the lower solves of [F P, R P].
// ---------------------------------------------------------------------------
template <int K>
__global__ void __launch_bounds__(32)
chol_quad_solve_tan_kernel(int m, int h, const double* __restrict__ kuu,
                           const double* __restrict__ tan,
                           const double* __restrict__ p,
                           const double* __restrict__ b,
                           double* __restrict__ l, double* __restrict__ ldot,
                           double* __restrict__ iv, double* __restrict__ ivdot,
                           double* __restrict__ y) {
  const int t = threadIdx.x;
  if (t >= 4) return;
  const int stream = t >> 1;
  const bool is_kuu = (t & 1) == 0;
  const int n = (stream == 0) ? h : m - h - K;
  const double* __restrict__ a = is_kuu ? kuu : p;
  const size_t ms = static_cast<size_t>(m);
  const size_t hs = static_cast<size_t>(h);
  double* __restrict__ lt = l + static_cast<size_t>(t) * (K + 1) * hs;
  double* __restrict__ ivt = iv + static_cast<size_t>(t) * hs;
  double* __restrict__ ldt = ldot + static_cast<size_t>(stream) * (K + 1) * hs;
  double* __restrict__ ivdt = ivdot + static_cast<size_t>(stream) * hs;
  double* __restrict__ yt = y + static_cast<size_t>(stream) * hs;

  // element (r, j) of the stream's band: F reads band[r, j], R reads
  // band[r, m-1-r-j]
  auto at = [&](int r, int j) -> size_t {
    return r * ms + ((stream == 0) ? j : (m - 1 - r - j));
  };
  auto bat = [&](int j) -> int { return (stream == 0) ? j : (m - 1 - j); };

  CholWindow<K> st;
  chol_window_zero(st);
  double keep[K + 1];
#pragma unroll
  for (int r = 0; r <= K; ++r) keep[r] = 1.0;
  double an[K + 1], tn[K + 1];
#pragma unroll
  for (int r = 0; r <= K; ++r) {
    an[r] = a[at(r, 0)];
    tn[r] = tan[at(r, 0)];
  }
  double bn = b[bat(0)];

  for (int i = 0; i < n; ++i) {
    double ac[K + 1], tc[K + 1];
#pragma unroll
    for (int r = 0; r <= K; ++r) {
      ac[r] = an[r];
      tc[r] = tn[r];
    }
    const double bc = bn;
    if (i + 1 < n) {
#pragma unroll
      for (int r = 0; r <= K; ++r) {
        an[r] = a[at(r, i + 1)];
        tn[r] = tan[at(r, i + 1)];
      }
      bn = b[bat(i + 1)];
    }
    double col[K + 1], tcol[K + 1], rp, tiv, xi;
    chol_tan_step<K>(st, ac, tc, bc, keep, col, tcol, rp, tiv, xi);
#pragma unroll
    for (int j = 0; j <= K; ++j) lt[j * hs + i] = col[j];
    ivt[i] = rp;
    if (is_kuu) {
#pragma unroll
      for (int j = 0; j <= K; ++j) ldt[j * hs + i] = tcol[j];
      ivdt[i] = tiv;
    } else {
      yt[i] = xi;
    }
  }
  // the R stream is one column shorter when m - K is odd: zero the rest
  for (int i = n; i < h; ++i) {
#pragma unroll
    for (int j = 0; j <= K; ++j) lt[j * hs + i] = 0.0;
    ivt[i] = 0.0;
    if (is_kuu) {
#pragma unroll
      for (int j = 0; j <= K; ++j) ldt[j * hs + i] = 0.0;
      ivdt[i] = 0.0;
    } else {
      yt[i] = 0.0;
    }
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
//       (by the F threads); right padding zeroed (by the R threads).
// ---------------------------------------------------------------------------
template <int K>
__global__ void __launch_bounds__(32)
tak_quad_solve_tan_kernel(int m, int h, const double* __restrict__ l,
                          const double* __restrict__ ldot,
                          const double* __restrict__ iv,
                          const double* __restrict__ ivdot,
                          const double* __restrict__ y,
                          const double* __restrict__ z,
                          const double* __restrict__ x2,
                          double* __restrict__ s_kuu, double* __restrict__ s_p,
                          double* __restrict__ u, double* __restrict__ sdot) {
  const int t = threadIdx.x;
  if (t >= 4) return;
  const int stream = t >> 1;
  const bool is_kuu = (t & 1) == 0;
  const int n = (stream == 0) ? h : m - h - K;
  const size_t ms = static_cast<size_t>(m);
  const size_t hs = static_cast<size_t>(h);
  const double* __restrict__ lt = l + static_cast<size_t>(t) * (K + 1) * hs;
  const double* __restrict__ ivt = iv + static_cast<size_t>(t) * hs;
  const double* __restrict__ ldt = ldot + static_cast<size_t>(stream) * (K + 1) * hs;
  const double* __restrict__ ivdt = ivdot + static_cast<size_t>(stream) * hs;
  const double* __restrict__ yt = y + static_cast<size_t>(stream) * hs;
  const double* __restrict__ zs = z + (is_kuu ? 0 : K * K);
  const double* __restrict__ zd = z + 2 * K * K;
  double* __restrict__ s_out = is_kuu ? s_kuu : s_p;

  TakWindow<K> st;
#pragma unroll
  for (int p = 1; p <= K; ++p) {
    st.x[p - 1] = (stream == 0) ? x2[p - 1] : x2[K - p];
#pragma unroll
    for (int r = 0; r <= K; ++r) {
      const bool inside = p - 1 + r <= K - 1;
      const int zi = (stream == 0) ? (p - 1 + r) * K + (p - 1) : (K - p - r) * K + (K - p);
      st.cs[p - 1][r] = inside ? zs[zi] : 0.0;
      st.tcs[p - 1][r] = inside ? zd[zi] : 0.0;
    }
  }

  if (stream == 0) {
    // the dense middle block, from the seed windows
#pragma unroll
    for (int c = 0; c < K; ++c) {
#pragma unroll
      for (int r = 0; r + c <= K - 1; ++r) {
        s_out[r * ms + h + c] = st.cs[c][r];
        if (is_kuu) sdot[r * ms + h + c] = st.tcs[c][r];
      }
      if (!is_kuu) u[h + c] = x2[c];
    }
  } else {
    // right padding: rows past the end of the last K columns
#pragma unroll
    for (int r = 1; r <= K; ++r) {
      for (int c = m - r; c < m; ++c) {
        s_out[r * ms + c] = 0.0;
        if (is_kuu) sdot[r * ms + c] = 0.0;
      }
    }
  }

  double keep[K + 1];
#pragma unroll
  for (int r = 0; r <= K; ++r) keep[r] = 1.0;
  double ln[K + 1], tln[K + 1];
#pragma unroll
  for (int r = 0; r <= K; ++r) {
    ln[r] = lt[r * hs + (n - 1)];
    tln[r] = ldt[r * hs + (n - 1)];
  }
  double dn = ivt[n - 1], tdn = ivdt[n - 1], bn = yt[n - 1];

  for (int j = n - 1; j >= 0; --j) {
    double lc[K + 1], tlc[K + 1];
#pragma unroll
    for (int r = 0; r <= K; ++r) {
      lc[r] = ln[r];
      tlc[r] = tln[r];
    }
    const double d = dn, td = tdn, bc = bn;
    if (j > 0) {
#pragma unroll
      for (int r = 0; r <= K; ++r) {
        ln[r] = lt[r * hs + (j - 1)];
        tln[r] = ldt[r * hs + (j - 1)];
      }
      dn = ivt[j - 1];
      tdn = ivdt[j - 1];
      bn = yt[j - 1];
    }
    double col[K + 1], tcol[K + 1], uj;
    tak_tan_step<K>(st, lc, tlc, d, td, bc, keep, col, tcol, uj);
#pragma unroll
    for (int r = 0; r <= K; ++r) {
      const size_t o = r * ms + ((stream == 0) ? j : (m - 1 - j - r));
      s_out[o] = col[r];
      if (is_kuu) sdot[o] = tcol[r];
    }
    if (!is_kuu) u[(stream == 0) ? j : (m - 1 - j)] = uj;
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <int K>
cudaError_t launch_chol_tan(int m, const double* kuu, const double* tan,
                            const double* p, const double* b, double* l_kuu,
                            double* l_p, double* iv, double* c0, double* ldot,
                            double* ivdot, cudaStream_t stream) {
  chol_pair_solve_tan_kernel<K><<<1, 2, 0, stream>>>(m, kuu, tan, p, b, l_kuu,
                                                     l_p, iv, c0, ldot, ivdot);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_tak_tan(int m, const double* l_kuu, const double* l_p,
                           const double* iv, const double* c0,
                           const double* ldot, const double* ivdot,
                           double* s_kuu, double* s_p, double* u, double* sdot,
                           cudaStream_t stream) {
  tak_pair_solve_tan_kernel<K><<<1, 2, 0, stream>>>(m, l_kuu, l_p, iv, c0, ldot,
                                                    ivdot, s_kuu, s_p, u, sdot);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_chol_quad(int m, int h, const double* kuu, const double* tan,
                             const double* p, const double* b, double* l,
                             double* ldot, double* iv, double* ivdot, double* y,
                             cudaStream_t stream) {
  chol_quad_solve_tan_kernel<K><<<1, 4, 0, stream>>>(m, h, kuu, tan, p, b, l,
                                                     ldot, iv, ivdot, y);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_tak_quad(int m, int h, const double* l, const double* ldot,
                            const double* iv, const double* ivdot,
                            const double* y, const double* z, const double* x2,
                            double* s_kuu, double* s_p, double* u, double* sdot,
                            cudaStream_t stream) {
  tak_quad_solve_tan_kernel<K><<<1, 4, 0, stream>>>(m, h, l, ldot, iv, ivdot, y,
                                                    z, x2, s_kuu, s_p, u, sdot);
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

// K3.  kuu, tan, p: (k+1, m) lower bands; b: (m,).  Writes l_kuu, l_p, ldot
// (k+1, m), iv (2, m), c0 (m,), ivdot (m,).
int asvgp_chol_pair_solve_tan(int k, int m, const double* kuu,
                              const double* tan, const double* p,
                              const double* b, double* l_kuu, double* l_p,
                              double* iv, double* c0, double* ldot,
                              double* ivdot, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (k) {
    case 1: return launch_chol_tan<1>(m, kuu, tan, p, b, l_kuu, l_p, iv, c0, ldot, ivdot, s);
    case 2: return launch_chol_tan<2>(m, kuu, tan, p, b, l_kuu, l_p, iv, c0, ldot, ivdot, s);
    case 3: return launch_chol_tan<3>(m, kuu, tan, p, b, l_kuu, l_p, iv, c0, ldot, ivdot, s);
    case 4: return launch_chol_tan<4>(m, kuu, tan, p, b, l_kuu, l_p, iv, c0, ldot, ivdot, s);
    case 5: return launch_chol_tan<5>(m, kuu, tan, p, b, l_kuu, l_p, iv, c0, ldot, ivdot, s);
    case 6: return launch_chol_tan<6>(m, kuu, tan, p, b, l_kuu, l_p, iv, c0, ldot, ivdot, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K4.  K3's outputs in; writes s_kuu, s_p, sdot (k+1, m) and u (m,).
int asvgp_tak_pair_solve_tan(int k, int m, const double* l_kuu,
                             const double* l_p, const double* iv,
                             const double* c0, const double* ldot,
                             const double* ivdot, double* s_kuu, double* s_p,
                             double* u, double* sdot, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (k) {
    case 1: return launch_tak_tan<1>(m, l_kuu, l_p, iv, c0, ldot, ivdot, s_kuu, s_p, u, sdot, s);
    case 2: return launch_tak_tan<2>(m, l_kuu, l_p, iv, c0, ldot, ivdot, s_kuu, s_p, u, sdot, s);
    case 3: return launch_tak_tan<3>(m, l_kuu, l_p, iv, c0, ldot, ivdot, s_kuu, s_p, u, sdot, s);
    case 4: return launch_tak_tan<4>(m, l_kuu, l_p, iv, c0, ldot, ivdot, s_kuu, s_p, u, sdot, s);
    case 5: return launch_tak_tan<5>(m, l_kuu, l_p, iv, c0, ldot, ivdot, s_kuu, s_p, u, sdot, s);
    case 6: return launch_tak_tan<6>(m, l_kuu, l_p, iv, c0, ldot, ivdot, s_kuu, s_p, u, sdot, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K5.  kuu, tan, p: (k+1, m); b: (m,); h = split point.  Writes l
// (4, k+1, h), ldot (2, k+1, h), iv (4, h), ivdot (2, h), y (2, h).
int asvgp_chol_quad_solve_tan(int k, int m, int h, const double* kuu,
                              const double* tan, const double* p,
                              const double* b, double* l, double* ldot,
                              double* iv, double* ivdot, double* y,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!twist_split_ok(k, m, h)) return static_cast<int>(cudaErrorInvalidValue);
  switch (k) {
    case 1: return launch_chol_quad<1>(m, h, kuu, tan, p, b, l, ldot, iv, ivdot, y, s);
    case 2: return launch_chol_quad<2>(m, h, kuu, tan, p, b, l, ldot, iv, ivdot, y, s);
    case 3: return launch_chol_quad<3>(m, h, kuu, tan, p, b, l, ldot, iv, ivdot, y, s);
    case 4: return launch_chol_quad<4>(m, h, kuu, tan, p, b, l, ldot, iv, ivdot, y, s);
    case 5: return launch_chol_quad<5>(m, h, kuu, tan, p, b, l, ldot, iv, ivdot, y, s);
    case 6: return launch_chol_quad<6>(m, h, kuu, tan, p, b, l, ldot, iv, ivdot, y, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K6.  K5's outputs, z (3, k, k) = [Z_Kuu, Z_P, Zdot_Kuu] and x2 (k,) in;
// writes s_kuu, s_p, sdot (k+1, m) and u (m,).
int asvgp_tak_quad_solve_tan(int k, int m, int h, const double* l,
                             const double* ldot, const double* iv,
                             const double* ivdot, const double* y,
                             const double* z, const double* x2, double* s_kuu,
                             double* s_p, double* u, double* sdot,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!twist_split_ok(k, m, h)) return static_cast<int>(cudaErrorInvalidValue);
  switch (k) {
    case 1: return launch_tak_quad<1>(m, h, l, ldot, iv, ivdot, y, z, x2, s_kuu, s_p, u, sdot, s);
    case 2: return launch_tak_quad<2>(m, h, l, ldot, iv, ivdot, y, z, x2, s_kuu, s_p, u, sdot, s);
    case 3: return launch_tak_quad<3>(m, h, l, ldot, iv, ivdot, y, z, x2, s_kuu, s_p, u, sdot, s);
    case 4: return launch_tak_quad<4>(m, h, l, ldot, iv, ivdot, y, z, x2, s_kuu, s_p, u, sdot, s);
    case 5: return launch_tak_quad<5>(m, h, l, ldot, iv, ivdot, y, z, x2, s_kuu, s_p, u, sdot, s);
    case 6: return launch_tak_quad<6>(m, h, l, ldot, iv, ivdot, y, z, x2, s_kuu, s_p, u, sdot, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
