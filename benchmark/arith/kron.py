"""Operations and bytes of the kron family's work, from a configuration's
sizes: one prediction request, one statistics build.  Counts are of
useful work (an fma counts 2), never of what an implementation repeats;
where a count is a model, it says so.
"""

from __future__ import annotations

import math


def sizes(cfg: dict) -> dict:
    """D, the orders k_d and sizes m_d, and M = Π m_d."""
    ks = [d["order"] for d in cfg["dims"]]
    ms = [d["m"] for d in cfg["dims"]]
    return {"D": len(ks), "ks": ks, "ms": ms, "M": math.prod(ms)}


def t_band_entries(cfg: dict) -> int:
    s = sizes(cfg)
    return (s["ks"][0] + 1) * math.prod(2 * k + 1 for k in s["ks"][1:]) * s["M"]


def point_flops(cfg: dict) -> int:
    """Operations of one predicted point: the basis values (a degree-k
    polynomial for each of k+1 functions per dimension), the trailing
    window's weights, the mean (Σ over the (k_1+1)·T window), the
    quadratic form in the block band of P⁻¹ over the symmetric pairs of
    block rows ((k_1+1)(k_1+2)/2 of T × T each), the per-dimension forms in
    Kuu_d⁻¹ and the variance's sum."""
    s = sizes(cfg)
    ks = s["ks"]
    T = math.prod(k + 1 for k in ks[1:])
    basis = sum(2 * k * (k + 1) for k in ks)
    weights = T * (len(ks) - 2)
    mean = 2 * (ks[0] + 1) * T
    quad_p = (ks[0] + 1) * (ks[0] + 2) // 2 * (2 * T * T + 3)
    quad_k = sum(2 * (k + 1) ** 2 for k in ks)
    return basis + weights + mean + quad_p + quad_k + 3


def request_work(cfg: dict, n: int) -> tuple:
    """(operations, bytes) of one request of n points: the points read
    once; of the posterior, the mean weights, the per-dimension bands and
    the entries of P⁻¹'s block band that the windows can reach (block row
    offsets 0..k_1, trailing offsets within ±k_d) read once; mean and
    variance written once."""
    s = sizes(cfg)
    ks, ms = s["ks"], s["ms"]
    sp = (ks[0] + 1) * ms[0] * math.prod(m * (2 * k + 1) for k, m in zip(ks[1:], ms[1:]))
    nbytes = 8 * (n * s["D"] + s["M"] + sp + sum((k + 1) * m for k, m in zip(ks, ms)) + 2 * n)
    return n * point_flops(cfg), nbytes


def stats_work(cfg: dict, n: int) -> tuple:
    """(operations, bytes) of the statistics of n points: per point the
    basis values, the per-dimension pair products, one product and one
    sum for each series of pair products (Π_d (k_d+1)(k_d+2)/2) and each
    Kuf·y term; X and y read once; Kuf·y, the multiband, yᵀy and n written
    once."""
    s = sizes(cfg)
    ks = s["ks"]
    pairs = [(k + 1) * (k + 2) // 2 for k in ks]
    per_point = (sum(2 * k * (k + 1) for k in ks) + sum(pairs)
                 + math.prod(pairs) * s["D"] + math.prod(k + 1 for k in ks) * (s["D"] + 1))
    nbytes = 8 * (n * (s["D"] + 1) + s["M"] + t_band_entries(cfg) + 2)
    return n * per_point, nbytes
