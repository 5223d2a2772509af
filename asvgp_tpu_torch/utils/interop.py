"""scipy.sparse interop: host-side bridges to the reference's CSR surface.

PyTorch counterpart of ``asvgp_tpu/utils/interop.py`` (the reference's
band ↔ sparse conversions and its CSR Kuf).  The compute path never builds
a CSR matrix; these helpers are for inspecting the same objects as the
reference.  Tensors on any device are copied to the host explicitly.
"""

from __future__ import annotations

import numpy as np
import torch

from asvgp_tpu_torch.device import resolve_device


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def lower_band_to_scipy(band):
    """(k+1, m) lower band of a symmetric matrix → scipy CSR (m, m)."""
    import scipy.sparse as sp

    band = _host(band)
    k = band.shape[0] - 1
    m = band.shape[1]
    diags = [band[0]]
    offsets = [0]
    for j in range(1, k + 1):
        diags.append(band[j][: m - j])
        offsets.append(-j)
        diags.append(band[j][: m - j])
        offsets.append(j)
    return sp.diags(diags, offsets, shape=(m, m)).tocsr()


def scipy_to_lower_band(mat, bandwidth: int, device=None) -> torch.Tensor:
    """scipy sparse symmetric matrix → (k+1, m) float64 lower band, on the
    CUDA device unless ``device`` says otherwise (``device="cpu"`` on the
    CPU); raises without a card, as the models do."""
    device = resolve_device(device)
    m = mat.shape[0]
    band = np.zeros((bandwidth + 1, m))
    for j in range(bandwidth + 1):
        band[j, : m - j] = np.asarray(mat.diagonal(-j)).ravel()
    return torch.as_tensor(band, device=device)


def kuf_to_scipy(basis, X, device=None):
    """Structured-sparse Kuf → scipy CSR (m, n), the reference's make_Kuf
    shape.  A tensor ``X`` is evaluated on its own device; any other ``X``
    (or a tensor given a ``device``) on the CUDA device unless ``device``
    says otherwise (``device="cpu"`` on the CPU); raises without a card."""
    import scipy.sparse as sp

    if isinstance(X, torch.Tensor) and device is None:
        x = X
    else:
        x = torch.as_tensor(X, device=resolve_device(device))
    if not x.is_floating_point():
        x = x.to(torch.float64)
    vals, start = basis.evaluate_basis(x, dx=0)
    vals, start = _host(vals), _host(start)
    n, kp1 = vals.shape
    rows = (start[:, None] + np.arange(kp1)[None, :]).ravel()
    cols = np.repeat(np.arange(n), kp1)
    return sp.csr_matrix((vals.ravel(), (rows, cols)), shape=(basis.m, n))
