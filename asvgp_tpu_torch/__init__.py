"""asvgp_tpu_torch: the PyTorch and CUDA port of asvgp_tpu.

Actually Sparse Variational Gaussian Processes with B-spline inducing
features and banded linear algebra, for an NVIDIA Hopper GPU.  It mirrors
the JAX package's layout:

  banded/    banded linear algebra: plain-PyTorch recursions and the
             hand-written CUDA sweeps and adjoints (csrc/)
  basis/     B-spline basis engine (orders 1-6) on a uniform mesh
  features/  RKHS Gram (Kuu) assembly + sparse design (Kuf) features
  stats/     sufficient-statistic assembly on the data's device
  models/    GPR1D, GPRKron (2-D), GPRAdditive, SVGP1D, the exact GP,
             Matérn kernels, Gaussian likelihood
  train/     L-BFGS, minibatch Adam, metrics (NLPD, MSE)

Everything is float64, except GPR1D with ``dtype=torch.float32`` (the JAX
package's float32 route, with the float32 kernels K17–K22).  Tensors on
the CPU run the plain versions of the kernels; tensors on a CUDA device run
the kernels, built with nvcc at first use.  The package imports torch and numpy, never jax.
"""

from asvgp_tpu_torch import banded, basis, features, models, stats, train

__version__ = "0.1.0"

__all__ = [
    "banded",
    "basis",
    "features",
    "models",
    "stats",
    "train",
]
