"""Parameter transforms: positive-constrained hyperparameters.

PyTorch counterpart of ``asvgp_tpu/models/parameters.py``: hyperparameters
are stored unconstrained and mapped through softplus.
"""

from __future__ import annotations

import torch


def positive(raw: torch.Tensor) -> torch.Tensor:
    """softplus: raw (unconstrained) -> positive, as log(1 + e^raw)."""
    return torch.logaddexp(raw, torch.zeros_like(raw))


def positive_inverse(value) -> torch.Tensor:
    """Inverse softplus: positive -> unconstrained (stable for small/large).

    Takes a tensor or a number; a number becomes a float64 tensor."""
    value = torch.as_tensor(value, dtype=torch.float64)
    return value + torch.log(-torch.expm1(-value))
