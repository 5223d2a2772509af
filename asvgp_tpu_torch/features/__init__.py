"""Inducing-feature layer: RKHS Gram (Kuu) assembly and structured Kuf;
the Fourier features of the VFF baseline."""

from asvgp_tpu_torch.features.fourier import FourierBasis1D, make_kuu_vff
from asvgp_tpu_torch.features.spline_features import SplineFeatures1D, make_kuu, make_kuf

__all__ = ["FourierBasis1D", "SplineFeatures1D", "make_kuu", "make_kuf", "make_kuu_vff"]
