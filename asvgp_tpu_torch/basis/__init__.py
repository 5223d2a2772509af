"""B-spline basis engine (orders 1-6) on a uniform mesh."""

from asvgp_tpu_torch.basis.splines import (
    BSplineBasis,
    B1Spline,
    B2Spline,
    B3Spline,
    B4Spline,
    B5Spline,
    B6Spline,
)
from asvgp_tpu_torch.basis import bsplines

__all__ = [
    "BSplineBasis",
    "B1Spline",
    "B2Spline",
    "B3Spline",
    "B4Spline",
    "B5Spline",
    "B6Spline",
    "bsplines",
]
