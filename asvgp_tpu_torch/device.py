"""The device an entry point of the port runs on."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """An entry point's device: ``None`` means the current CUDA device, and
    raises when there is none (no silent fall back to the CPU)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the port runs on the CUDA device unless told otherwise, and there "
                'is none: pass device="cpu" to run on the CPU'
            )
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
