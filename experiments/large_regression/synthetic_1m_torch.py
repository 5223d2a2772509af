"""Large-scale 1-D regression on the PyTorch port: N = 10⁶ points, m up to 10⁴.

The torch leg of ``synthetic_1m.py``, the same protocol on
``asvgp_tpu_torch``: 5 random 95/5 splits, GPR1D fitted by L-BFGS
(``curv_rtol=10.0`` with restarts), NLPD and MSE on the held-out 5 %, the
optimisation and prediction times, and the optional baselines (minibatch
Adam on the collapsed bound, the uncollapsed SVGP with minibatch Adam, VFF
with 100 frequencies), then the mean ± std table over the splits.  The
flags, defaults and row keys are the JAX script's; ``--device`` is new and
defaults to the CUDA device (``--device cpu`` runs the plain versions of
the kernels on the CPU).

Run:  python experiments/large_regression/synthetic_1m_torch.py \\
          [--n 1000000] [--m 1000] [--splits 5] [--adam-baseline] \\
          [--svgp-baseline] [--vff-baseline] [--device cpu] [--out rows.json]
"""

import argparse
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from asvgp_tpu_torch.basis import BSplineBasis  # noqa: E402
from asvgp_tpu_torch.device import resolve_device  # noqa: E402
from asvgp_tpu_torch.features import FourierBasis1D  # noqa: E402
from asvgp_tpu_torch.models import GPR1D, GPRVFF, SVGP1D, Matern52, fit_svgp  # noqa: E402
from asvgp_tpu_torch.models.parameters import positive  # noqa: E402
from asvgp_tpu_torch.train import fit_adam_minibatch, fit_lbfgs, mse, nlpd  # noqa: E402


def make_data(n, seed):
    """The protocol's synthetic data: x uniform on (0.002, 0.998),
    y = sin 7x + ½ sin(23x) e^{-x} + 0.3 ε."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(0.002, 0.998, n)
    f = np.sin(7 * x) + 0.5 * np.sin(23 * x) * np.exp(-x)
    return x, f + 0.3 * rng.randn(n)


def load_data(path):
    """``--data``: a real dataset as (x, y), run through the same protocol.

    Accepts ``.npz`` with arrays named ``x`` and ``y``, ``.npy`` (an (n, 2)
    array), a two-column ``.csv``, or a pickle of anything with two columns
    (e.g. a pandas DataFrame).  Inputs are min-max scaled strictly inside
    (0, 1) and targets standardised, as the synthetic data lie.  Raises
    ``ValueError`` for an ``.npz`` without both names and for a constant x
    or y, which the scaling cannot take."""
    if path.endswith(".npz"):
        z = np.load(path)
        if "x" not in z or "y" not in z:
            raise ValueError(f"{path}: an .npz needs arrays named 'x' and 'y', "
                             f"found {sorted(z.files)}")
        x, y = z["x"], z["y"]
    elif path.endswith(".npy"):
        arr = np.load(path)
        x, y = arr[:, 0], arr[:, 1]
    elif path.endswith(".csv"):
        arr = np.loadtxt(path, delimiter=",")
        x, y = arr[:, 0], arr[:, 1]
    else:
        import pickle

        with open(path, "rb") as f:
            obj = pickle.load(f)
        arr = np.asarray(obj)
        x, y = arr[:, 0], arr[:, 1]
    x = np.asarray(x, np.float64).ravel()
    y = np.asarray(y, np.float64).ravel()
    lo, hi = x.min(), x.max()
    if not hi > lo:
        raise ValueError(f"{path}: x is constant ({lo}); it cannot be scaled into (0, 1)")
    if not y.std() > 0:
        raise ValueError(f"{path}: y is constant ({y[0]}); it cannot be standardised")
    x = 0.002 + 0.996 * (x - lo) / (hi - lo)
    y = (y - y.mean()) / y.std()
    return x, y


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_split(args, seed, data=None, indices=None, stage=None, record=None):
    """One 95/5 split: the row of metrics.

    For a caller that checks the run: ``indices`` ({"adam": (steps, batch),
    "svgp": (steps, batch)}, either optional) replaces the baselines'
    minibatch draws; ``stage(name)``, a context manager, wraps each stage
    ("precompute", "fit", "predict", "adam", "svgp", "svgp_predict",
    "vff_precompute", "vff_fit", "vff_predict"); ``record`` (a dict) gets
    the models, the fitted parameters and the baselines' loss histories."""
    device = resolve_device(args.device)
    stage = stage or (lambda name: contextlib.nullcontext())
    indices = indices or {}
    record = {} if record is None else record
    if data is not None:
        # 5 random 95/5 splits of the SAME dataset (the reference protocol)
        xall, yall = data
        perm = np.random.RandomState(seed).permutation(xall.shape[0])
        x, y = xall[perm], yall[perm]
    else:
        x, y = make_data(args.n, seed)
    n_test = max(1, x.shape[0] // 20)  # 95/5 split
    xtr, ytr = x[n_test:], y[n_test:]
    xte, yte = x[:n_test], y[:n_test]
    yte_d = torch.as_tensor(yte, dtype=torch.float64, device=device)[:, None]

    basis = BSplineBasis(0.0, 1.0, args.m, args.order)
    # a data-scale lengthscale: at ℓ = 1 the spline Gram's κ reaches ~1e18
    # at m = 1000 and the trace term is ill-posed in any implementation

    def kern():
        return Matern52(lengthscales=args.lengthscale_init)

    t0 = time.time()
    with stage("precompute"):
        model = GPR1D((xtr, ytr), kern(), basis, device=device)
        _sync(device)
    t_pre = time.time() - t0

    t0 = time.time()
    fit_info = {}
    with stage("fit"):
        params, loss, iters = fit_lbfgs(
            model.training_loss, model.params(), max_iters=args.iters, info=fit_info,
            restarts=args.restarts,
            # the large-scale protocol's line search: Armijo and an
            # approximate decrease, ~1.2 evaluations an iteration
            curv_rtol=10.0,
        )
        _sync(device)
    t_opt = time.time() - t0
    model.load_jax_params(params)
    record.update(model=model, params=params, fit_info=fit_info)

    t0 = time.time()
    with stage("predict"):
        ld = model.predict_log_density((xte, yte))
        mean, _ = model.predict_f(xte)
        _sync(device)
    t_pred = time.time() - t0

    row = {
        "elbo": -float(loss),
        "nlpd": float(nlpd(ld)),
        "mse": float(mse(yte_d, mean)),
        "t_precompute": t_pre,
        "t_opt": t_opt,
        "t_pred": t_pred,
        "iters": int(iters),
        "grad_norm": fit_info.get("grad_norm"),
        "converged": fit_info.get("converged"),
        "restarts": fit_info.get("restarts"),
        "ls_evals": fit_info.get("ls_evals"),
        "evals_per_iter": fit_info.get("evals_per_iter"),
        "stopping_rule": fit_info.get("stopping_rule"),
        "noise_variance": float(positive(params["likelihood"]["raw_variance"])),
    }

    if args.adam_baseline:
        t0 = time.time()
        with stage("adam"):
            p_adam, losses = fit_adam_minibatch(
                basis, 5, xtr, ytr, model.init_params(), batch_size=args.batch,
                steps=args.adam_steps, device=device, indices=indices.get("adam"))
            _sync(device)
        row["t_adam"] = time.time() - t0
        record.update(adam_params=p_adam, adam_losses=losses)
        model.load_jax_params(p_adam)
        row["nlpd_adam"] = float(nlpd(model.predict_log_density((xte, yte))))
        model.load_jax_params(params)

    if args.svgp_baseline:
        # the reference's baseline: an SVGP with minibatch Adam, batch 100.
        # A baseline's failure is recorded in its row and the run goes on.
        try:
            t0 = time.time()
            with stage("svgp"):
                svgp = SVGP1D(kern(), basis, num_data=len(xtr), device=device)
                p_svgp, losses = fit_svgp(
                    svgp, xtr, ytr, svgp.init_params(), batch_size=args.svgp_batch,
                    steps=args.svgp_steps, device=device, indices=indices.get("svgp"))
                _sync(device)
            row["t_svgp"] = time.time() - t0
            t0 = time.time()
            with stage("svgp_predict"):
                ld_s = svgp.predict_log_density((xte, yte), params=p_svgp)
                mean_s, _ = svgp.predict_f(xte, params=p_svgp)
                _sync(device)
            row["t_svgp_pred"] = time.time() - t0
            row["nlpd_svgp"] = float(nlpd(ld_s))
            row["mse_svgp"] = float(mse(yte_d, mean_s))
            row["noise_svgp"] = float(positive(torch.as_tensor(
                p_svgp["likelihood"]["raw_variance"])))
            record.update(svgp=svgp, svgp_params=p_svgp, svgp_losses=losses)
            losses = np.asarray(losses, dtype=float)
            tail = losses[-args.svgp_steps // 10:]
            head = losses[-args.svgp_steps // 5: -args.svgp_steps // 10]
            row["svgp_elbo_tail_drop"] = float(head.mean() - tail.mean())
        except Exception as e:  # noqa: BLE001 — recorded, the run continues
            row["svgp_error"] = f"{type(e).__name__}: {e}"[:300]
            print(f"SVGP baseline failed on this fold: {row['svgp_error']}", flush=True)

    if args.vff_baseline:
        fb = FourierBasis1D(0.0, 1.0, args.vff_frequencies)
        t0 = time.time()
        with stage("vff_precompute"):
            vff = GPRVFF((xtr, ytr), kern(), fb, device=device)
            _sync(device)
        row["t_vff_precompute"] = time.time() - t0
        t0 = time.time()
        vff_info = {}
        with stage("vff_fit"):
            p_vff, loss_vff, vff_iters = fit_lbfgs(vff.training_loss, vff.params(),
                                                   max_iters=args.iters, info=vff_info)
            _sync(device)
        row["t_vff_opt"] = time.time() - t0
        record.update(vff=vff, vff_params=p_vff, vff_iters=vff_iters, vff_info=vff_info)
        t0 = time.time()
        with stage("vff_predict"):
            ld_v = vff.predict_log_density((xte, yte), params=p_vff)
            mean_v, _ = vff.predict_f(xte, params=p_vff)
            _sync(device)
        row["t_vff_pred"] = time.time() - t0
        row["elbo_vff"] = -float(loss_vff)
        row["nlpd_vff"] = float(nlpd(ld_v))
        row["mse_vff"] = float(mse(yte_d, mean_v))
    return row


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--m", type=int, default=1000)  # the reference protocol
    ap.add_argument("--lengthscale-init", type=float, default=0.05)
    ap.add_argument("--order", type=int, default=3)
    ap.add_argument("--splits", type=int, default=5)
    ap.add_argument("--iters", type=int, default=200)
    # stall-escape reruns of the fit from the point reached
    ap.add_argument("--restarts", type=int, default=2)
    ap.add_argument("--adam-baseline", action="store_true")
    ap.add_argument("--svgp-baseline", action="store_true")
    ap.add_argument("--vff-baseline", action="store_true")
    ap.add_argument("--vff-frequencies", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--adam-steps", type=int, default=2000)
    # the SVGP baseline's protocol is the reference's
    ap.add_argument("--svgp-batch", type=int, default=100)
    ap.add_argument("--svgp-steps", type=int, default=10000)
    ap.add_argument("--out", type=str, default=None,
                    help="write a JSON metrics artifact here")
    ap.add_argument("--data", type=str, default=None,
                    help="real dataset (.npz with x and y, .npy, .csv, pickle of x,y) run "
                         "through the same 5-split protocol; default is the synthetic data")
    ap.add_argument("--device", type=str, default=None,
                    help="the device to run on (default: the CUDA device; 'cpu' for the CPU)")
    return ap


def summarize(rows):
    """The mean ± std table over the splits, of every numeric key."""
    table = {}
    for key in sorted({k for r in rows for k in r}):
        try:
            vals = np.array([r[key] for r in rows if key in r], dtype=float)
        except (TypeError, ValueError):  # non-numeric (e.g. *_error strings)
            continue
        table[key] = {"mean": float(vals.mean()), "std": float(vals.std())}
    return table


def main():
    args = parser().parse_args()
    data = load_data(args.data) if args.data else None
    device = resolve_device(args.device)
    rows = []
    for seed in range(args.splits):
        rows.append(run_split(args, seed, data=data))
        print(f"split {seed}: " + ", ".join(
            f"{k}={v:.6g}" if isinstance(v, (int, float)) else f"{k}={v}"
            for k, v in rows[-1].items()), flush=True)
    table = summarize(rows)
    print(f"{'metric':14s}  mean ± std over {args.splits} splits")
    for key, v in table.items():
        print(f"{key:14s}  {v['mean']:.6g} ± {v['std']:.3g}")
    if args.out:
        name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        with open(args.out, "w") as f:
            json.dump({"config": vars(args), "device": name, "rows": rows, "table": table},
                      f, indent=1)


if __name__ == "__main__":
    main()
