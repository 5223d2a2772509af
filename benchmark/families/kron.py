"""The kron family: the program's GPRKron (tensor-product B-spline features,
any D ≥ 2) built from a configuration, the plain reference of the same
model, and the outputs that the two are compared by.

A config gives one entry of ``dims`` per input dimension (basis domain
[a, b], m functions of ``order``, a Matérn kernel of 2ν = ``nu2`` with its
variance and lengthscale) and ``noise_variance``.

What a loop in ``entries/`` asks of a family:

  parts(cfg), build(cfg, parts, X, y, device)   the program's model
  stats(model)                   the statistics the model built
  posterior(model)               the program's posterior: ``predict_f(X)``
  ref_stats(cfg, X, y, dtype)    the reference's statistics, keyed as ``stats``
  ref_posterior(cfg, X, y, dtype)   the reference's posterior: ``predict(X)``
  compare_stats(got, ref)        {number: gap} between two sets of statistics
"""

from __future__ import annotations

import math

import torch

import asvgp_tpu_torch.models as models
from asvgp_tpu_torch.basis import BSplineBasis
from benchmark import compare as cmp
from benchmark.reference import kron as ref_kron


def parts(cfg: dict) -> tuple:
    """(kernels, bases): what a user hands GPRKron besides the data."""
    kernels = [models.Matern(variance=d["variance"], lengthscales=d["lengthscale"], nu2=d["nu2"])
               for d in cfg["dims"]]
    bases = [BSplineBasis(d["a"], d["b"], d["m"], d["order"]) for d in cfg["dims"]]
    return kernels, bases


def build(cfg: dict, parts_: tuple, X: torch.Tensor, y: torch.Tensor, device):
    """GPRKron on (X, y): its statistics are built here, on ``device``."""
    kernels, bases = parts_
    return models.GPRKron((X, y), kernels, bases, noise_variance=cfg["noise_variance"],
                          device=device)


def posterior(model):
    """The posterior at the model's parameters, which are the config's."""
    return model.posterior()


def stats(model) -> dict:
    """The statistics the model built: Kuf·y, the multiband of KufKfu, yᵀy, n."""
    return {"kuf_y": model.kuf_y, "t_band": model.t_band, "yty": model.yty, "n": model.n}


def raw_init(cfg: dict) -> dict:
    """The configuration's initial values as raw (inverse-softplus) floats."""
    def inv(v):
        return v + math.log(-math.expm1(-v))
    out = {"noise": inv(cfg["noise_variance"])}
    for d, dim in enumerate(cfg["dims"]):
        out[f"ell{d}"] = inv(dim["lengthscale"])
        out[f"var{d}"] = inv(dim["variance"])
    return out


def ref_stats(cfg: dict, X: torch.Tensor, y: torch.Tensor, dtype) -> dict:
    """The plain statistics of (X, y) in ``dtype``."""
    ref_kron.no_tf32()
    return ref_kron.statistics(cfg["dims"], X, y, dtype)


def ref_posterior(cfg: dict, X: torch.Tensor, y: torch.Tensor, dtype):
    """The plain dense posterior on (X, y) at the config's initial
    parameters, in ``dtype``."""
    ref_kron.no_tf32()
    dims = cfg["dims"]
    st = ref_kron.statistics(dims, X, y, dtype)
    kk = ref_kron.band_to_dense(st["t_band"], dims)
    raw = {k: torch.tensor(v, dtype=dtype, device=X.device) for k, v in raw_init(cfg).items()}
    return ref_kron.Posterior(dims, st, kk, raw)


def compare_stats(got: dict, ref: dict) -> dict:
    """Arrays by max |got − ref| over max |ref|, yᵀy relative, n exactly."""
    return {"kuf_y": cmp.rel_max(got["kuf_y"], ref["kuf_y"]),
            "t_band": cmp.rel_max(got["t_band"], ref["t_band"]),
            "yty": cmp.rel(got["yty"], ref["yty"]),
            "n": abs(float(got["n"]) - float(ref["n"]))}
