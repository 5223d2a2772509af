"""How far each chunk-partitioned sweep of the port lies from its one-chunk
run, at chunk lengths from 64 columns up, beside the one-chunk run's own
spread when its band is perturbed by one rounding (1e-16 relative in
float64, 6e-8 in float32).

The sweeps run as the CPU emulations of the partition tests run them
(``tests/test_torch_*_partition.py``, ``tests/test_torch_solve.py``), in
the kernels' order of operations:

- linear sweeps on the scan: K10/K8/K18 ``chol_bwd``, K12/K7/K20/K23
  ``tak_bwd``, K11/K19 ``tak_fwd`` (on L of Kuu and of P), K13/K21 and
  K14/K22 (L_P⁻¹ Kuf·y and L_P⁻ᵀ of it), K2 and K4 (Kuu and P), K6 (the
  twisted route's streams);
- the Schur walks (``--walks``): K9/K15/K17 ``chol_fwd``, K1, K3, K5.

Settings (``--setting``):
  i    B3 × Matérn-3/2, ℓ/δ = 49.4, m = 1000 and 2000 (the additive fault)
  ii   B3 × Matérn-5/2, m = 1000, ℓ = 0.05: the large-regression
       protocol's Kuu, its P on make_data(2·10⁴, 0) at the model's default
       noise 1.0
  iii  B3 × Matérn-3/2, ℓ/δ = 100, m = 320
  ns   the north star's ℓ/δ = 10, m = 320
P at i, iii and ns is GPR1D's on the partition tests' data (N = 100 m
points, noise 0.1).

Prints one JSON line per (setting, m, sweep, dtype): for each chunk length
the largest map entry (``h``) and the distance from the one-chunk run
relative to its largest entry (``d``), and the one-chunk run's spread.
CPU only, numpy; about ten minutes for all settings.

  python tools/chunk_rule_probe.py --setting ii
  python tools/chunk_rule_probe.py --setting ii --walks
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

from asvgp_tpu_torch.banded import core, ops, tan, twist  # noqa: E402
from asvgp_tpu_torch.banded.twisted import split_point  # noqa: E402
from asvgp_tpu_torch.basis import B3Spline  # noqa: E402
from asvgp_tpu_torch.features.spline_features import make_kuu  # noqa: E402
from asvgp_tpu_torch.models import GPR1D, Matern  # noqa: E402

import test_torch_adjoint_partition as adj  # noqa: E402
import test_torch_core_partition as corep  # noqa: E402
import test_torch_forward_partition as fwd  # noqa: E402
import test_torch_solve as solvep  # noqa: E402
import test_torch_tan_partition as tanp  # noqa: E402
import test_torch_twist_partition as twp  # noqa: E402

EPS = {np.float64: 1e-16, np.float32: 6e-8}


def make_data(n, seed):
    """The large-regression protocol's synthetic data."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(0.002, 0.998, n)
    f = np.sin(7 * x) + 0.5 * np.sin(23 * x) * np.exp(-x)
    return x, f + 0.3 * rng.randn(n)


def bands(setting, m):
    """(Kuu, T = ∂Kuu/∂ℓ, P, Kuf·y), float64 tensors."""
    if setting == "ii":
        nu2, ell, noise = 5, 0.05, 1.0
        x, y = make_data(20_000, 0)
    else:
        nu2, noise = 3, 0.1
        ell = {"i": 49.4, "iii": 100.0, "ns": 10.0}[setting] / (m - 3)
        rng = np.random.RandomState(5)
        x = rng.uniform(0.005, 0.995, 100 * m)
        y = np.sin(140.8 * x) + 0.5 * np.sin(35.2 * x) + 0.3 * rng.randn(x.shape[0])
    basis = B3Spline(0.0, 1.0, m)
    model = GPR1D((x, y), Matern(1.0, ell, nu2=nu2), basis, noise_variance=noise, device="cpu")
    with torch.no_grad():
        e = torch.tensor(ell, dtype=torch.float64)
        v = torch.tensor(1.0, dtype=torch.float64)
        kuu, tanb = torch.func.jvp(lambda l_: make_kuu(Matern(v, l_, nu2=nu2), basis),
                                   (e,), (torch.ones_like(e),))
        p = model.kufkfu_band / noise + kuu
    return kuu, tanb, p, model.kuf_y


def perturb(a, dt, rng):
    """``a`` (numpy) times 1 + eps·N(0, 1) entrywise, in ``dt``."""
    a = np.asarray(a, np.float64)
    return (a * (1.0 + EPS[dt] * rng.standard_normal(a.shape))).astype(dt)


def dist(got, one):
    got = [np.asarray(g, np.float64) for g in (got if isinstance(got, tuple) else (got,))]
    one = [np.asarray(o, np.float64) for o in (one if isinstance(one, tuple) else (one,))]
    return max(float(np.nanmax(np.abs(g - o)) / np.nanmax(np.abs(o))) for g, o in zip(got, one))


def linear_sweeps(kuu, tanb, p, b):
    """name -> (run(lc, perturbed) -> (outputs, largest map entry), walk
    length, dtype)."""
    rng = np.random.RandomState(12)
    m = kuu.shape[1]
    k = kuu.shape[0] - 1
    out = {}
    for dt in (np.float64, np.float32):
        tag = "" if dt == np.float64 else "_f32"
        tdt = torch.float64 if dt == np.float64 else torch.float32
        for role, a in (("kuu", kuu), ("p", p)):
            l = ops.cholesky_band_plain(a.to(tdt)).numpy()
            s = ops.takahashi_inverse_band_plain(torch.from_numpy(l)).numpy()
            cot = rng.randn(k + 1, m).astype(dt)
            prng = np.random.RandomState(99)
            pl = perturb(l, dt, prng)

            def cb(lc, pert, l=l, cot=cot, pl=pl):
                return adj.partitioned(pl if pert else l, cot, lc)

            def tb(lc, pert, l=l, s=s, cot=cot, pl=pl):
                return adj.partitioned(pl if pert else l, cot, lc, s=s, chol=False)

            def tf(lc, pert, l=l, pl=pl):
                return fwd.partitioned_tak(pl if pert else l, lc)

            out[f"chol_bwd{tag}:{role}"] = (cb, m, dt)
            out[f"tak_bwd{tag}:{role}"] = (tb, m, dt)
            out[f"tak_fwd{tag}:{role}"] = (tf, m, dt)
            if role == "p":
                bb = b.numpy().astype(dt)
                for upper in (False, True):
                    def sv(lc, pert, l=l, pl=pl, bb=bb, upper=upper):
                        return solvep.partitioned_solve(pl if pert else l, bb, upper, lc)
                    out[f"solve_{'upper_t' if upper else 'lower'}{tag}:p"] = (sv, m, dt)
    # K2 and K4 from their plain producers' outputs; K6 from K5's and the mid step
    k1 = core.chol_pair_solve_plain(kuu, p, b)
    prng = np.random.RandomState(98)
    k1p = tuple(torch.from_numpy(perturb(t.numpy(), np.float64, prng)) if i < 2 else t
                for i, t in enumerate(k1))
    out["k2"] = (lambda lc, pert: corep.partitioned_k2(*(k1p if pert else k1), lc), m, np.float64)
    k3 = tan.chol_pair_solve_tan_plain(kuu, tanb, p, b)
    k3p = tuple(torch.from_numpy(perturb(t.numpy(), np.float64, prng)) if i < 2 else t
                for i, t in enumerate(k3))
    out["k4"] = (lambda lc, pert: tanp.partitioned_k4(*(k3p if pert else k3), lc), m, np.float64)
    if twist.twist_applicable(k, m):
        k5 = twist.chol_quad_solve_tan_plain(kuu, tanb, p, b)
        _, z, x2, _ = twist.mid_step(kuu, tanb, p, b, k5[0], k5[1], k5[4])
        k5p = (torch.from_numpy(perturb(k5[0].numpy(), np.float64, prng)),) + tuple(k5[1:])
        out["k6"] = (lambda lc, pert: twp.partitioned_k6(*(k5p if pert else k5), z, x2, m, lc),
                     split_point(m, k), np.float64)
    return out


def walks(kuu, tanb, p, b):
    """The Schur walks: name -> (run(lc, perturbed) -> (outputs, record),
    walk length)."""
    m = kuu.shape[1]
    k = kuu.shape[0] - 1
    prng = np.random.RandomState(97)
    pk, pp = (torch.from_numpy(perturb(a.numpy(), np.float64, prng)) for a in (kuu, p))
    out = {}
    for role, a, pa in (("kuu", kuu, pk), ("p", p, pp)):
        def cf(lc, pert, a=a, pa=pa):
            l, w_max, s_min = fwd.partitioned_chol((pa if pert else a).numpy(), lc)
            return l, {"w": w_max, "sigma": s_min}
        out[f"chol_fwd:{role}"] = (cf, m)
    out["k1"] = (lambda lc, pert: corep.partitioned_k1(pk if pert else kuu, pp if pert else p,
                                                       b, lc), m)
    out["k3"] = (lambda lc, pert: tanp.partitioned_k3(pk if pert else kuu, tanb,
                                                      pp if pert else p, b, lc), m)
    if twist.twist_applicable(k, m):
        out["k5"] = (lambda lc, pert: twp.partitioned_k5(pk if pert else kuu, tanb,
                                                         pp if pert else p, b, lc),
                     split_point(m, k))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--setting", choices=("i", "ii", "iii", "ns"), required=True)
    ap.add_argument("--m", type=int, nargs="*", default=None)
    ap.add_argument("--lcs", type=int, nargs="*", default=[64, 128, 192, 256, 320, 384, 512])
    ap.add_argument("--only", nargs="*", default=None, help="sweep names to run")
    ap.add_argument("--walks", action="store_true", help="the Schur walks instead")
    args = ap.parse_args()
    ms = args.m or {"i": [1000, 2000], "ii": [1000], "iii": [320], "ns": [320]}[args.setting]
    for m in ms:
        kuu, tanb, p, b = bands(args.setting, m)
        table = walks(kuu, tanb, p, b) if args.walks else linear_sweeps(kuu, tanb, p, b)
        for name, spec in table.items():
            if args.only and name not in args.only:
                continue
            run, n = spec[0], spec[1]
            one, _ = run(n, False)
            one_p, _ = run(n, True)
            row = {"setting": args.setting, "m": m, "sweep": name, "walk": n,
                   "spread": dist(one_p, one), "by_lc": {}}
            for lc in args.lcs:
                if lc >= n:
                    continue
                got, rec = run(lc, False)
                row["by_lc"][lc] = {"d": dist(got, one),
                                    **({"h": rec} if not isinstance(rec, dict) else rec)}
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
