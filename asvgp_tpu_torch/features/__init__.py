"""Inducing-feature layer: RKHS Gram (Kuu) assembly and structured Kuf."""

from asvgp_tpu_torch.features.spline_features import SplineFeatures1D, make_kuu, make_kuf

__all__ = ["SplineFeatures1D", "make_kuu", "make_kuf"]
