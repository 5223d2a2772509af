"""The parts GPRKron and GPRAdditive share: one Matérn kernel and one
B-spline basis per input dimension and a Gaussian likelihood.

``PerDimensionGP`` holds the hyperparameters as float64 ``nn.Parameter``s
and carries them to and from the JAX package's params pytree;
``PerDimensionPosterior`` batches a posterior's predictions over test
points of D columns.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from asvgp_tpu_torch.models.kernels import Matern
from asvgp_tpu_torch.models.likelihoods import Gaussian
from asvgp_tpu_torch.models.parameters import positive, positive_inverse
from asvgp_tpu_torch.utils.profiling import host_value, span, to_device

_F64 = torch.float64


def params_to_kernels(params, nu2s):
    """The per-dimension Matérn kernels of a params pytree."""
    return [
        Matern(variance=positive(p["raw_variance"]), lengthscales=positive(p["raw_lengthscales"]),
               nu2=nu2)
        for p, nu2 in zip(params["kernels"], nu2s)
    ]


def check_domain(xv, bases) -> None:
    """Raise unless every input lies strictly inside its basis' domain (on
    the host when the caller passed host data)."""
    for d, basis in enumerate(bases):
        lo, hi = host_value(xv[:, d].min()), host_value(xv[:, d].max())
        if not (lo > basis.a and hi < basis.b):
            raise ValueError(f"dim {d}: inputs must lie strictly inside "
                             f"[{basis.a}, {basis.b}], got [{lo}, {hi}]")


class PerDimensionPosterior:
    """A cached posterior of a model with one kernel and one basis per input
    dimension: ``_predict_chunk`` gives the mean and marginal variance of a
    chunk of points (n, D) on ``device``; this class batches them and adds
    the likelihood."""

    def __init__(self, kernels, lik, bases, device):
        self.kernels = kernels
        self.likelihood = lik
        self.bases = bases
        self.device = device

    def _predict_chunk(self, x):
        raise NotImplementedError

    def predict_f(self, Xnew, full_cov: bool = False, batch: int | None = None):
        """Posterior mean and marginal variance at Xnew (n, D), each (n, 1).

        ``batch`` chunks the test points; the last chunk is padded to the
        batch size with the domain's centre and cut, so no point is
        dropped."""
        if full_cov:
            raise NotImplementedError("full_cov prediction is not implemented")
        with span("predict_f", self.device):
            D = len(self.bases)
            x = to_device(Xnew, _F64, self.device).reshape(-1, D)
            n = x.shape[0]
            if not batch or n <= batch:
                mean, var = self._predict_chunk(x)
                return mean[:, None], var[:, None]
            n_pad = (-n) % batch
            centre = to_device([0.5 * (b.a + b.b) for b in self.bases], x.dtype, x.device)
            xp = torch.cat([x, centre.expand(n_pad, D)])
            means, vars_ = [], []
            for lo in range(0, n + n_pad, batch):
                mc, vc = self._predict_chunk(xp[lo:lo + batch])
                means.append(mc)
                vars_.append(vc)
            return torch.cat(means)[:n, None], torch.cat(vars_)[:n, None]

    def predict_y(self, Xnew, batch: int | None = None):
        mean, var = self.predict_f(Xnew, batch=batch)
        return self.likelihood.predict_mean_and_var(mean, var)

    def predict_log_density(self, data, batch: int | None = None):
        Xnew, ynew = data
        mean, var = self.predict_f(Xnew, batch=batch)
        y = torch.as_tensor(ynew, dtype=_F64, device=mean.device).reshape(mean.shape)
        return self.likelihood.predict_log_density(mean, var, y)


class PerDimensionGP(nn.Module):
    """The hyperparameters of a model with one Matérn kernel per input
    dimension and a Gaussian likelihood (GPRKron, GPRAdditive): float64
    ``nn.Parameter``s ``raw_variances`` and ``raw_lengthscales`` (one per
    dimension) and ``raw_noise_variance``.

    A params pytree in the JAX package's layout, ``{"kernels":
    [{"raw_lengthscales", "raw_variance"}, ...], "likelihood":
    {"raw_variance"}}``, can stand in for them: ``params()`` returns one,
    ``load_jax_params`` sets them from one, and the objectives and
    predictions take one (``None``: the module's own parameters).
    """

    def _init_parameters(self, kernels, noise_variance, device) -> None:
        self.nu2s = [k.nu2 for k in kernels]
        self.kernels_init = list(kernels)
        self.noise_variance_init = noise_variance
        init = self.init_params()

        def param(value):
            return nn.Parameter(to_device(value, _F64, device))

        self.raw_variances = nn.ParameterList(
            [param(p["raw_variance"]) for p in init["kernels"]])
        self.raw_lengthscales = nn.ParameterList(
            [param(p["raw_lengthscales"]) for p in init["kernels"]])
        self.raw_noise_variance = param(init["likelihood"]["raw_variance"])

    def init_params(self) -> dict:
        """The initial parameters in the JAX package's layout (numpy)."""

        def inv(value):
            return positive_inverse(torch.as_tensor(value, dtype=_F64).detach().cpu()).numpy()

        return {
            "kernels": [{"raw_variance": inv(k.variance), "raw_lengthscales": inv(k.lengthscales)}
                        for k in self.kernels_init],
            "likelihood": {"raw_variance": inv(self.noise_variance_init)},
        }

    def params(self) -> dict:
        """The current parameters in the JAX package's layout: detached
        float64 copies on the model's device (``fit_lbfgs`` starts there)."""
        own = self._params(None)
        return {
            "kernels": [{name: v.detach().clone() for name, v in p.items()}
                        for p in own["kernels"]],
            "likelihood": {"raw_variance": own["likelihood"]["raw_variance"].detach().clone()},
        }

    def _params(self, params):
        """``params``, or the module's own parameters for ``None``, in the
        JAX package's layout (differentiable into the module)."""
        if params is not None:
            return params
        return {
            "kernels": [{"raw_lengthscales": ell, "raw_variance": var}
                        for var, ell in zip(self.raw_variances, self.raw_lengthscales)],
            "likelihood": {"raw_variance": self.raw_noise_variance},
        }

    def load_jax_params(self, params) -> None:
        """Set the parameters from a params pytree in the JAX package's
        layout, of tensors (any device) or numpy arrays."""
        if len(params["kernels"]) != self.D:
            raise ValueError(f"need {self.D} kernels' parameters, got {len(params['kernels'])}")
        pairs = [(self.raw_noise_variance, params["likelihood"]["raw_variance"])]
        for d, p in enumerate(params["kernels"]):
            pairs += [(self.raw_variances[d], p["raw_variance"]),
                      (self.raw_lengthscales[d], p["raw_lengthscales"])]
        with torch.no_grad():
            for target, value in pairs:
                v = (value.detach() if isinstance(value, torch.Tensor)
                     else torch.as_tensor(np.array(value, dtype=np.float64)))
                if v.numel() != target.numel():
                    raise ValueError(f"parameter of {target.numel()} values given {v.numel()}")
                target.copy_(v.reshape(target.shape))

    def _build(self, params=None):
        p = self._params(params)
        return (params_to_kernels(p, self.nu2s),
                Gaussian(positive(p["likelihood"]["raw_variance"])))

    def elbo(self, params=None) -> torch.Tensor:
        raise NotImplementedError

    def maximum_log_likelihood_objective(self, params=None) -> torch.Tensor:
        return self.elbo(params)

    def training_loss(self, params=None) -> torch.Tensor:
        return -self.elbo(params)

    def posterior(self, params=None) -> PerDimensionPosterior:
        raise NotImplementedError

    def predict_f(self, Xnew, full_cov: bool = False, batch: int | None = None, params=None):
        """Posterior mean and marginal variance at Xnew; ``full_cov`` is not
        implemented, matching the reference; ``batch`` chunks the points."""
        if full_cov:
            raise NotImplementedError("full_cov prediction is not implemented")
        return self.posterior(params).predict_f(Xnew, batch=batch)

    def predict_y(self, Xnew, batch: int | None = None, params=None):
        return self.posterior(params).predict_y(Xnew, batch=batch)

    def predict_log_density(self, data, batch: int | None = None, params=None):
        return self.posterior(params).predict_log_density(data, batch=batch)
