"""Snelson 1-D toy regression on the PyTorch port.

The torch leg of ``example.py``: fit an exact GP, then ASVGP with B3
splines (m = 100, Matérn-3/2) on [-3.5, 10.5], and print both objectives
side by side: the ELBO must lower-bound and approach the exact log
marginal likelihood.  ``--device`` defaults to the CUDA device
(``--device cpu`` for the CPU).

Run:  python experiments/snelson/example_torch.py [--m 100] [--order 3]
      [--device cpu] [--plot out.png]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from asvgp_tpu_torch.basis import BSplineBasis  # noqa: E402
from asvgp_tpu_torch.device import resolve_device  # noqa: E402
from asvgp_tpu_torch.models import GPR1D, ExactGPR, Matern32  # noqa: E402
from asvgp_tpu_torch.train import fit_lbfgs  # noqa: E402

DATA = os.path.join(os.path.dirname(__file__), "..", "..", "data", "snelson")


def load():
    X = np.loadtxt(os.path.join(DATA, "train_inputs")).reshape(-1, 1)
    y = np.loadtxt(os.path.join(DATA, "train_outputs")).reshape(-1, 1)
    return X, y


def run(m=100, order=3, a=-3.5, b=10.5, device=None):
    """The exact GP's and ASVGP's fits: (gp, (params, loss, iters), model,
    (params, loss, iters), seconds of the ASVGP fit)."""
    device = resolve_device(device)
    X, y = load()
    gp = ExactGPR((X, y), Matern32(), device=device)
    gp_fit = fit_lbfgs(gp.training_loss, gp.params())
    gp.load_jax_params(gp_fit[0])
    t0 = time.time()
    model = GPR1D((X, y), Matern32(), BSplineBasis(a, b, m, order), device=device)
    fit = fit_lbfgs(model.training_loss, model.params())
    model.load_jax_params(fit[0])
    return gp, gp_fit, model, fit, time.time() - t0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=100)
    ap.add_argument("--order", type=int, default=3)
    ap.add_argument("--a", type=float, default=-3.5)
    ap.add_argument("--b", type=float, default=10.5)
    ap.add_argument("--device", type=str, default=None,
                    help="the device to run on (default: the CUDA device; 'cpu' for the CPU)")
    ap.add_argument(
        "--plot",
        default=None,
        metavar="PATH",
        help="write the predictive plot (mean, ±2σ band, training points) to PATH",
    )
    args = ap.parse_args()

    _, (_, loss, it), model, (_, lossf, itf), seconds = run(args.m, args.order, args.a, args.b,
                                                            args.device)
    print(f"GP: ELBO = {-float(loss):.6f}  ({int(it)} iters)")
    print(f"ASVGP: ELBO = {-float(lossf):.6f}  ({int(itf)} iters, {seconds:.2f}s total)")

    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        X, y = load()
        xs = np.linspace(args.a, args.b, 600).reshape(-1, 1)
        mean, var = model.predict_f(xs)
        mean = mean.cpu().numpy()[:, 0]
        sd = np.sqrt(var.cpu().numpy()[:, 0])
        fig, ax = plt.subplots(figsize=(8, 4))
        ax.fill_between(xs[:, 0], mean - 2 * sd, mean + 2 * sd, alpha=0.25, lw=0, label="±2σ")
        ax.plot(xs[:, 0], mean, lw=1.5, label="predictive mean")
        ax.plot(X[:, 0], y[:, 0], "kx", ms=4, alpha=0.7, label="train")
        ax.set_xlim(args.a, args.b)
        ax.set_title(f"ASVGP on Snelson (m={args.m}, order {args.order}); "
                     f"ELBO {-float(lossf):.3f} vs exact logZ {-float(loss):.3f}")
        ax.legend(loc="upper right", fontsize=8)
        fig.tight_layout()
        fig.savefig(args.plot, dpi=120)
        print(f"wrote {args.plot}")


if __name__ == "__main__":
    main()
