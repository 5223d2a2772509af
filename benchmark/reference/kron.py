"""The plain GPRKron: statistics, posterior and prediction with dense
matrices, in plain PyTorch.

It follows the model's definition and none of the program's algorithms:
the basis by the Cox–de Boor recursion, the statistics by scatter-adding
every point's products, and P = Kuu + KufKfu/σ² (Kuu = ⊗_d Kuu_d) as one
dense M × M matrix, factored by ``torch.linalg.cholesky``.  It imports
nothing of the program.  ``dtype`` float32 computes it all in float32 with
TF32 off: the control that a comparison must tell apart from the program.

The statistics' layout is the program's, so that the two can be compared
entry by entry: ``kuf_y`` flat row-major over (m_1, …, m_D), and the
multiband ``t_band[p, o_2+k_2, …, o_D+k_D, j_1, …, j_D] = KufKfu[(j_1+p,
j_2+o_2, …), (j_1, …, j_D)]`` (p in 0..k_1, o_d in −k_d..k_d).
"""

from __future__ import annotations

import itertools
import math

import torch

from benchmark.reference.kuu import kuu_dense

_CHUNK = 1 << 21  # points whose products are scatter-added per call


def no_tf32() -> None:
    """Plain float32 is float32: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def basis_values(dim: dict, x: torch.Tensor):
    """(vals (n, k+1), cell (n,)): the k+1 B-splines alive at each x,
    vals[:, s] that of function cell + s, by the Cox–de Boor recursion on
    the local coordinate t of x in its mesh cell."""
    k, a, b, m = dim["order"], dim["a"], dim["b"], dim["m"]
    cells = m - k
    delta = (b - a) / cells
    c = torch.clamp(torch.floor((x - a) / delta).to(torch.int64), 0, cells - 1)
    t = (x - (a + c.to(x.dtype) * delta)) / delta
    vals = [torch.ones_like(t)]
    for j in range(1, k + 1):
        new = []
        for i in range(j + 1):
            v = torch.zeros_like(t)
            if i >= 1:
                v = v + (t + (j - i)) * vals[i - 1]
            if i < j:
                v = v + ((i + 1) - t) * vals[i]
            new.append(v / j)
        vals = new
    return torch.stack(vals, dim=1), c


def _flat(idx, ms):
    """Row-major flat index of the per-dimension indices ``idx``."""
    out = idx[0]
    for i, m in zip(idx[1:], ms[1:]):
        out = out * m + i
    return out


def statistics(dims, X: torch.Tensor, y: torch.Tensor, dtype=torch.float64) -> dict:
    """kuf_y, t_band, yᵀy and n of the points (X (n, D), y (n,)) in
    ``dtype``, every point's products scatter-added (``index_add_``)."""
    X, y = X.to(dtype), y.reshape(-1).to(dtype)
    D = len(dims)
    ks, ms = [d["order"] for d in dims], [d["m"] for d in dims]
    n = X.shape[0]
    band_shape = (ks[0] + 1, *(2 * k + 1 for k in ks[1:]), *ms)
    kuf_y = X.new_zeros(math.prod(ms))
    t_band = X.new_zeros(math.prod(band_shape))
    for lo in range(0, n, _CHUNK):
        vc = [basis_values(d, X[lo:lo + _CHUNK, i]) for i, d in enumerate(dims)]
        yc = y[lo:lo + _CHUNK]
        for s in itertools.product(*(range(k + 1) for k in ks)):
            w = yc
            for (v, _), si in zip(vc, s):
                w = w * v[:, si]
            kuf_y.index_add_(0, _flat([c + si for (_, c), si in zip(vc, s)], ms), w)
        # dimension 1: the lower offsets p ≥ 0; the others: −k..k
        terms = [[(p, s1, s1 + p) for p in range(ks[0] + 1) for s1 in range(ks[0] + 1 - p)]]
        for k in ks[1:]:
            terms.append([(o + k, s, s + o) for o in range(-k, k + 1)
                          for s in range(max(0, -o), min(k, k - o) + 1)])
        for combo in itertools.product(*terms):
            w = None
            idx = []
            for (v, c), (_, s, r) in zip(vc, combo):
                f = v[:, s] * v[:, r]
                w = f if w is None else w * f
                idx.append(c + s)
            head = [torch.full_like(idx[0], o) for o, _, _ in combo]
            t_band.index_add_(0, _flat(head + idx, band_shape), w)
    return {"kuf_y": kuf_y, "t_band": t_band.reshape(band_shape),
            "yty": torch.sum(y * y), "n": float(n)}


def band_to_dense(t_band: torch.Tensor, dims) -> torch.Tensor:
    """The dense symmetric M × M KufKfu of the multiband ``t_band``."""
    D = len(dims)
    ks, ms = [d["order"] for d in dims], [d["m"] for d in dims]
    M = math.prod(ms)
    grids = torch.meshgrid(*(torch.arange(s, device=t_band.device) for s in t_band.shape),
                           indexing="ij")
    offs = [grids[0]] + [g - k for g, k in zip(grids[1:D], ks[1:])]
    cols = list(grids[D:])
    rows = [c + o for c, o in zip(cols, offs)]
    ok = torch.ones_like(rows[0], dtype=torch.bool)
    for r, m in zip(rows, ms):
        ok &= (r >= 0) & (r < m)
    r = _flat([x[ok] for x in rows], ms)
    c = _flat([x[ok] for x in cols], ms)
    v = t_band[ok]
    dense = t_band.new_zeros((M, M))
    dense[r, c] = v
    dense[c, r] = v
    return dense


def hyper(raw: dict, D: int) -> tuple:
    """(variances, lengthscales, noise variance) from the raw (softplus)
    parameters ``var<d>``, ``ell<d>`` and ``noise``."""
    def pos(v):
        return torch.logaddexp(v, torch.zeros_like(v))
    return ([pos(raw[f"var{d}"]) for d in range(D)], [pos(raw[f"ell{d}"]) for d in range(D)],
            pos(raw["noise"]))


def kuu(dims, variances, lengthscales) -> torch.Tensor:
    """Dense Kuu = ⊗_d Kuu_d, row-major over the dimensions."""
    out = None
    for d, var, ell in zip(dims, variances, lengthscales):
        kd = kuu_dense(d["nu2"], d["order"], d["a"], d["b"], d["m"], var, ell)
        out = kd if out is None else torch.kron(out, kd)
    return out


class Posterior:
    """w = P⁻¹ Kuf y / σ², P⁻¹ and Kuu⁻¹ dense; a prediction gathers each
    point's window of Π_d (k_d+1) features from them."""

    def __init__(self, dims, stats, kk, raw: dict):
        with torch.no_grad():
            variances, lengthscales, s2 = hyper(raw, len(dims))
            kuu_m = kuu(dims, variances, lengthscales)
            self.p_inv = torch.cholesky_inverse(torch.linalg.cholesky(kuu_m + kk / s2))
            self.kuu_inv = torch.cholesky_inverse(torch.linalg.cholesky(kuu_m))
            self.w = self.p_inv @ stats["kuf_y"] / s2
            self.kdiag = math.prod(variances)
        self.dims = dims

    @torch.no_grad()
    def predict(self, x: torch.Tensor, chunk: int = 32768):
        """Mean and marginal variance of f at x (n, D)."""
        ks, ms = [d["order"] for d in self.dims], [d["m"] for d in self.dims]
        x = x.to(self.w.dtype)
        means, vars_ = [], []
        for lo in range(0, x.shape[0], chunk):
            vc = [basis_values(d, x[lo:lo + chunk, i]) for i, d in enumerate(self.dims)]
            idx, val = [], []
            for s in itertools.product(*(range(k + 1) for k in ks)):
                v = None
                for (vd, _), si in zip(vc, s):
                    v = vd[:, si] if v is None else v * vd[:, si]
                val.append(v)
                idx.append(_flat([c + si for (_, c), si in zip(vc, s)], ms))
            idx, val = torch.stack(idx, 1), torch.stack(val, 1)
            means.append(torch.sum(val * self.w[idx], 1))
            quad_p = torch.einsum("na,nab,nb->n", val, self.p_inv[idx[:, :, None], idx[:, None, :]],
                                  val)
            quad_k = torch.einsum("na,nab,nb->n", val,
                                  self.kuu_inv[idx[:, :, None], idx[:, None, :]], val)
            vars_.append(self.kdiag + quad_p - quad_k)
        return torch.cat(means), torch.cat(vars_)
