"""Utility helpers: profiling and scipy interop."""

from asvgp_tpu_torch.utils.profiling import timed, trace_to
from asvgp_tpu_torch.utils.interop import (
    kuf_to_scipy,
    lower_band_to_scipy,
    scipy_to_lower_band,
)

__all__ = [
    "timed",
    "trace_to",
    "lower_band_to_scipy",
    "scipy_to_lower_band",
    "kuf_to_scipy",
]
