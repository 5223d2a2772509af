"""The chunk-length rule of the partitioned linear sweeps, in numpy.

A copy, in the kernels' order of operations, of what ``chunk_rule_kernel``
(csrc/forward_sweeps.cuh) computes on the card for the linear sweeps on the
scan: the Takahashi band K11/K19, the adjoints K7, K8, K10, K12, K18, K20,
K23, and the Takahashi roles of K2, K4 and K6.  Past the two-chunk limit
(``TWO_CHUNK_COLS``, the adjoints and K11/K19 only) each such sweep takes
the shortest multiple of the 64-column tile, no shorter than its
partition's length lc0, after which the homogeneous response of an
interior chunk of the factor (walk positions lc0.. of columns n-1..0,
started from the D = k(k+1)/2 unit windows of S) has no entry above
``TAU`` (``TAU_TAN`` for the tangent sweeps K4 and K6), or the whole walk
when none does; the longest over the factors of a call.  The CPU runs the
plain recursions and never chunks: the tests and ``chip_smoke.py`` use
this copy to know the lengths the card chooses.
"""

from __future__ import annotations

import numpy as np

TILE = 64
TWO_CHUNK_COLS = 512
TAU = 2e-3       # kRuleTau: the linear sweeps and K2
TAU_TAN = 5e-5   # kRuleTauTan: K4 and K6


def rule_cols(l, lc0: int, tau: float, n: int | None = None) -> int:
    """The rule's chunk length for one factor ``l`` ((k+1, ≥ n) lower band,
    numpy or a CPU tensor, float64 or float32) whose walk has n positions
    (default: its columns) and whose partition has chunks of lc0."""
    l = np.asarray(l)
    dt = l.dtype.type
    kp1 = l.shape[0]
    k = kp1 - 1
    n = l.shape[1] if n is None else n
    d_ = k * (k + 1) // 2
    slots = [(c, r) for c in range(k) for r in range(k - c)]
    cs = np.zeros((k, kp1, d_), dt)
    for d, (c, r) in enumerate(slots):
        cs[c, r, d] = 1
    for u0 in range(lc0, n, TILE):
        cnt = min(TILE, n - u0)
        for t in range(cnt):
            j = n - 1 - (u0 + t)
            lc = l[:, j]
            dinv = dt(1) / lc[0]
            sq = [None] * kp1
            for q in range(1, kp1):
                acc = np.zeros(d_, dt)
                for p in range(1, kp1):
                    acc = cs[min(p, q) - 1, abs(q - p)] * lc[p] + acc
                sq[q] = (-dinv) * acc
            ws = np.zeros(d_, dt)
            for q in range(1, kp1):
                ws = lc[q] * sq[q] + ws
            col = [dt(0) * (dinv * dinv) - dinv * ws]
            col += [sq[q] * dt(1 if j + q < n else 0) for q in range(1, kp1)]
            cs[1:] = cs[:-1].copy()
            cs[0] = np.stack(col)
        h = max(float(np.max(np.abs(cs[c, r]))) for c, r in slots)
        if h <= tau:
            return min(max(-(-(u0 + cnt - lc0) // TILE) * TILE, lc0), n)
    return n


def sweep_cols(factors, lc0: int, tau: float, n: int | None = None) -> int:
    """The chunk length a call over ``factors`` takes: lc0 when that is its
    whole walk, else the longest of the rule's lengths."""
    n = np.asarray(factors[0]).shape[1] if n is None else n
    if lc0 >= n:
        return lc0
    return max(rule_cols(f, lc0, tau, n) for f in factors)
