"""The numbers that decide ``correct``: gaps between what the program
produced and what the reference works out from the same inputs."""

from __future__ import annotations

import statistics

import torch


def rel_max(got, ref) -> float:
    """max |got − ref| over max |ref|, elementwise over the whole array."""
    got = torch.as_tensor(got).detach().to("cpu", torch.float64).reshape(-1)
    ref = torch.as_tensor(ref).detach().to("cpu", torch.float64).reshape(-1)
    if got.shape != ref.shape:
        return float("inf")
    scale = float(torch.max(torch.abs(ref)))
    return float(torch.max(torch.abs(got - ref))) / scale if scale > 0 else float("inf")


def rel(got, ref) -> float:
    got, ref = float(got), float(ref)
    return abs(got - ref) / abs(ref) if ref != 0 else float("inf")


def leaf_gap(got: dict, ref: dict, base: dict | None = None) -> float:
    """The worst leaf's gap: |got − ref| of each leaf over the reference's
    move of that leaf from ``base`` (0 without one) or the median leaf's
    move, whichever is larger."""
    base = base or {k: 0.0 for k in ref}
    moves = {k: abs(float(ref[k]) - float(base[k])) for k in ref}
    floor = statistics.median(moves.values())
    worst = 0.0
    for k in ref:
        scale = max(moves[k], floor)
        gap = abs(float(got.get(k, float("inf"))) - float(ref[k]))
        worst = max(worst, gap / scale if scale > 0 else float("inf"))
    return worst
