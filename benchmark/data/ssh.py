"""The eNATL60 stand-in: synthetic_ssh's field (experiments/spatial_2d/
ocean_ssh_torch.py), its points and noise drawn on the device.

  f(u, v) = sin(9u + 3v) + 0.6 cos(14v) sin(5u) + 0.3 sin(31uv + 2),
  y = f + 0.15 ε,  (u, v) uniform on (0.02, 0.98)²
"""

from __future__ import annotations

import torch

LO, HI, NOISE = 0.02, 0.98, 0.15


def field(X: torch.Tensor) -> torch.Tensor:
    u, v = X[:, 0], X[:, 1]
    return (torch.sin(9 * u + 3 * v) + 0.6 * torch.cos(14 * v) * torch.sin(5 * u)
            + 0.3 * torch.sin(31 * u * v + 2))


def make(n: int, gen: torch.Generator, dtype=torch.float64):
    """(X (n, 2), y (n,)) on ``gen``'s device, from its state."""
    X = LO + (HI - LO) * torch.rand((n, 2), generator=gen, dtype=dtype, device=gen.device)
    y = field(X) + NOISE * torch.randn(n, generator=gen, dtype=dtype, device=gen.device)
    return X, y
