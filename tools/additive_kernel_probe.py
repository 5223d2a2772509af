"""Which kernel moves GPRAdditive's gradient, on the GPU.

Builds the model as ``chip_smoke.py`` phase 6m does (N = 5·10⁵, D = 4,
4 × B3Spline(0, 1, 250), Matern32(ℓ = 0.2), noise 0.1) and, beyond the
linear sweeps' two-chunk limit (``kTwoChunkCols`` = 512 columns in
``csrc/banded_adjoint.cu``), the same data with 1000 features a dimension
at the same ℓ/δ = 49.4 (ℓ = 49.4/997), where those sweeps take sixteen
64-column chunks.  Prints one JSON object, for each of the two widths:

  - the value-and-grad step's loss and its gradient's largest relative
    distance from the step with all four of K9–K12 swapped for their plain
    versions on CPU copies of their arguments, with the kernels and with
    each of K9–K12 swapped alone (at 250 features also from
    ``chip_smoke.ANCHOR_ADD_GRAD``, the JAX package on a CPU in float64);
  - each of K9–K12 against its plain version on the step's first
    arguments (relative to the largest entry);
  - dimension 0's Kuu (κ), and at 250 features the distance of K9's L and
    K11's band of Kuu⁻¹ from an extended-precision (``np.longdouble``)
    reference, beside the plain versions' distance.

Run from the repository root, on the card (about a minute after the
build):

    python tools/additive_kernel_probe.py
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

SWEEPS = ("chol_fwd", "chol_bwd", "tak_fwd", "tak_bwd")
BEYOND_M = 1000  # features a dimension past the two-chunk limit


def rel(got, want) -> float:
    got, want = (np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t, dtype=np.float64)
                 for t in (got, want))
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def band_dense(band: np.ndarray) -> np.ndarray:
    """The symmetric dense matrix of a lower band, in its dtype."""
    kp1, m = band.shape
    out = np.zeros((m, m), dtype=band.dtype)
    for j in range(kp1):
        idx = np.arange(m - j)
        out[idx + j, idx] = band[j, : m - j]
        out[idx, idx + j] = band[j, : m - j]
    return out


def lower_band(dense: np.ndarray, kp1: int) -> np.ndarray:
    m = dense.shape[0]
    return np.stack([np.concatenate([np.diagonal(dense, -j), np.zeros(j, dense.dtype)])
                     for j in range(kp1)])


def extended_references(a_band: np.ndarray, l_band: np.ndarray):
    """(L of A, band of (L Lᵀ)⁻¹ for the given float64 L) in long double:
    the Cholesky by columns, the inverse of L refined by Newton steps."""
    kp1, m = a_band.shape
    A = band_dense(a_band.astype(np.longdouble))
    L = np.zeros_like(A)
    for j in range(m):
        L[j, j] = np.sqrt(A[j, j] - L[j, :j] @ L[j, :j])
        L[j + 1:, j] = (A[j + 1:, j] - L[j + 1:, :j] @ L[j, :j]) / L[j, j]
    lg = np.tril(band_dense(l_band.astype(np.longdouble)))
    inv = np.linalg.inv(lg.astype(np.float64)).astype(np.longdouble)
    eye = np.eye(m, dtype=np.longdouble)
    for _ in range(3):
        inv = inv @ (2 * eye - lg @ inv)
    return lower_band(L, kp1), lower_band(inv.T @ inv, kp1)


def probe(cs, m_per_dim: int, ell: float, extended: bool) -> dict:
    """The readings above for the additive model at ``m_per_dim`` features
    a dimension and lengthscale ``ell``, on the card."""
    from asvgp_tpu_torch.banded import single
    from asvgp_tpu_torch.basis import B3Spline
    from asvgp_tpu_torch.models import GPRAdditive, Matern32

    dev = torch.device("cuda", 0)
    X, y = cs.probe_data(cs.N_ADD, cs.ADD_SEED)
    model = GPRAdditive((X, y), [Matern32(lengthscales=ell)] * cs.ADD_D,
                        [B3Spline(0.0, 1.0, m_per_dim)] * cs.ADD_D, noise_variance=cs.ADD_NOISE,
                        device=dev)
    kernels = {name: getattr(single, name) for name in SWEEPS}
    plains = {name: getattr(single, f"{name}_plain") for name in SWEEPS}
    step_args = {name: [] for name in SWEEPS}

    def use(plain_names, capture=False):
        for name in SWEEPS:
            if name in plain_names:
                fn = (lambda *a, p=plains[name]: p(*[t.cpu() for t in a]).to(dev))
            elif capture:
                def fn(*a, k=kernels[name], n=name):
                    step_args[n].append(tuple(t.detach().clone() for t in a))
                    return k(*a)
            else:
                fn = kernels[name]
            setattr(single, name, fn)

    grads = {}
    for plain_names in (SWEEPS, (), *((n,) for n in SWEEPS)):
        use(plain_names, capture=not plain_names)
        key = "kernels" if not plain_names else "plain " + "+".join(plain_names)
        grads[key] = cs.per_dim_value_and_grad(model)
    use(())
    plain_grad = np.asarray(grads["plain " + "+".join(SWEEPS)][1])
    steps = {}
    for key, (loss, grad) in grads.items():
        grad = np.asarray(grad)
        steps[key] = {"loss": loss,
                      "grad_rel_vs_plain": float(np.max(np.abs(grad - plain_grad)
                                                        / np.abs(plain_grad)))}
        if extended:
            want = np.asarray(cs.ANCHOR_ADD_GRAD)
            steps[key]["grad_rel_vs_jax"] = float(np.max(np.abs(grad - want) / np.abs(want)))
    kernel_vs_plain = {name: rel(kernels[name](*step_args[name][0]),
                                 plains[name](*[t.cpu() for t in step_args[name][0]]))
                       for name in SWEEPS}
    a = step_args["chol_fwd"][0][0]
    out = {"m_per_dim": m_per_dim, "ell": ell, "steps": steps,
           "kernel_vs_plain": kernel_vs_plain,
           "kuu_kappa": float(np.linalg.cond(band_dense(a.cpu().numpy())))}
    if extended:
        l_plain = plains["chol_fwd"](a.cpu())
        l_ref, s_ref = extended_references(a.cpu().numpy(), l_plain.numpy())
        l_dev = l_plain.to(dev)
        out["chol_vs_extended"] = {"kernel": rel(kernels["chol_fwd"](a), l_ref),
                                   "plain": rel(l_plain, l_ref)}
        out["tak_vs_extended"] = {"kernel": rel(kernels["tak_fwd"](l_dev), s_ref),
                                  "plain": rel(plains["tak_fwd"](l_plain), s_ref)}
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")

    import chip_smoke as cs
    from asvgp_tpu_torch.banded import _build

    _build.build()
    ell_over_delta = cs.ADD_ELL * (cs.ADD_M - 3)
    out = {
        "card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], capture_output=True,
                               text=True).stdout.strip(),
        "widths": [probe(cs, cs.ADD_M, cs.ADD_ELL, True),
                   probe(cs, BEYOND_M, ell_over_delta / (BEYOND_M - 3), False)],
    }
    print(json.dumps(out))

if __name__ == "__main__":
    main()
