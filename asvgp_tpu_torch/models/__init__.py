"""Model classes: GPR1D, GPRKron, GPRAdditive, SVGP1D, the exact GP, the VFF
baseline, Matérn kernels, Gaussian likelihood."""

from asvgp_tpu_torch.models.kernels import Matern, Matern12, Matern32, Matern52
from asvgp_tpu_torch.models.likelihoods import Gaussian
from asvgp_tpu_torch.models.gpr1d import GPR1D, Posterior1D
from asvgp_tpu_torch.models.exact_gp import ExactGPR
from asvgp_tpu_torch.models.svgp import SVGP1D, fit_svgp
from asvgp_tpu_torch.models.kron import GPRKron, PosteriorKron
from asvgp_tpu_torch.models.additive import GPRAdditive, PosteriorAdditive
from asvgp_tpu_torch.models.vff import GPRVFF

__all__ = [
    "Matern",
    "Matern12",
    "Matern32",
    "Matern52",
    "Gaussian",
    "GPR1D",
    "ExactGPR",
    "Posterior1D",
    "SVGP1D",
    "fit_svgp",
    "GPRKron",
    "PosteriorKron",
    "GPRAdditive",
    "PosteriorAdditive",
    "GPRVFF",
]
