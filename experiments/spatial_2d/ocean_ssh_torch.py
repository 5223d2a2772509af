"""2-D spatial regression at eNATL60 scale on the PyTorch port.

The torch leg of ``ocean_ssh.py``, the same protocol on ``asvgp_tpu_torch``:
sea-surface height on N = 2,000,000 points with GPRKron, 2 × Matérn-3/2
(ℓ = 0.1) × B4-spline (m = 100 per dimension) = 10⁴ tensor-product
features, noise 0.1, full-batch L-BFGS (``curv_rtol=10.0``), one posterior
for the predictive mean and the log density on the held-out points, MSE
and NLL.  The NetCDF ocean data are not distributable, so the data are
the JAX script's synthetic SSH-like field (``synthetic_ssh``, the same
bits); ``--data`` points at an (N, 3) [lon, lat, ssh] .npy file instead.

The flags, defaults and artifact keys are the JAX script's, except:
``--device`` is new and defaults to the CUDA device (raising without one;
``--device cpu`` runs the plain versions of the kernels on the CPU); the
artifact has no ``relay_wait_s``, and the CPU baseline's
``tpu_exec_per_iter_s`` is ``gpu_exec_per_iter_s``.  ``--cpu-baseline-steps
K`` times K value-and-grad steps of the port's own plain versions on the
CPU at the same shape.

``--mesh N`` has the JAX flag's meaning, data-parallel statistics over N
devices (0: none): the script starts N ranks (``parallel.run_ranks``), on
the first N CUDA devices over NCCL (raising when there are fewer), or with
``--device cpu`` on the CPU over gloo.  Rank r builds the statistics of its
block of the training rows, one ``all_reduce`` sums them, and each rank
then fits and predicts on the summed statistics, as the JAX script does on
its mesh; rank 0 writes the artifact.  The training rows must divide by N.

Run:  python experiments/spatial_2d/ocean_ssh_torch.py [--n 2000000] [--m 100]
          [--n-test 100000] [--iters 100] [--mesh N] [--device cpu] [--out run.json]
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
from asvgp_tpu_torch.models import GPRKron, Matern32  # noqa: E402
from asvgp_tpu_torch.models.gpr1d import resolve_device  # noqa: E402
from asvgp_tpu_torch.parallel import run_ranks, shard_data  # noqa: E402
from asvgp_tpu_torch.parallel.launch import file_function_rank  # noqa: E402
from asvgp_tpu_torch.train import fit_lbfgs, mse, nlpd  # noqa: E402
from asvgp_tpu_torch.train.logging import WallClock  # noqa: E402

ELL, NOISE = 0.1, 0.1


def synthetic_ssh(n, seed=1997):
    rng = np.random.RandomState(seed)
    X = rng.uniform(0.02, 0.98, (n, 2))
    u, v = X[:, 0], X[:, 1]
    f = (
        np.sin(9 * u + 3 * v)
        + 0.6 * np.cos(14 * v) * np.sin(5 * u)
        + 0.3 * np.sin(31 * u * v + 2)
    )
    return X, (f + 0.15 * rng.randn(n)).reshape(-1, 1)


def load_data(args):
    """The protocol's (X, y): ``--data``'s [lon, lat, ssh] scaled into the
    mesh box, else ``synthetic_ssh(n + n_test)``."""
    if args.data:
        arr = np.load(args.data)
        X, y = arr[:, :2], arr[:, 2:3]
        lo, hi = X.min(0), X.max(0)
        return 0.02 + 0.96 * (X - lo) / (hi - lo), y
    return synthetic_ssh(args.n + args.n_test)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args, stage=None, record=None, group=None, rank=0, world=1, device=None) -> dict:
    """The protocol once: the artifact of the JAX script (without
    ``relay_wait_s``).

    For a caller that checks the run: ``stage(name)``, a context manager,
    wraps each stage ("precompute", "optimize", "predict"); ``record`` (a
    dict) gets the model, the fitted parameters and the posterior.  With a
    process ``group`` (``run_mesh``), this is rank ``rank`` of ``world`` on
    ``device``: its model takes its block of the training rows and sums the
    statistics over the group."""
    device = resolve_device(args.device) if device is None else device
    stage = stage or (lambda name: contextlib.nullcontext())
    record = {} if record is None else record
    X, y = load_data(args)
    Xtr, ytr = X[args.n_test:], y[args.n_test:]
    Xte, yte = X[:args.n_test], y[:args.n_test]

    bases = [BSplineBasis(0.0, 1.0, args.m, args.order)] * 2
    kernels = [Matern32(lengthscales=ELL), Matern32(lengthscales=ELL)]
    train = (Xtr, ytr)
    if group is not None:
        train = tuple(a.numpy() for a in shard_data(Xtr, ytr, rank, world))

    clock = WallClock(device)
    with stage("precompute"), clock.section("precompute"):
        model = GPRKron(train, kernels, bases, noise_variance=NOISE, device=device, group=group)
    stats_phases = {"exec_s": round(clock.times["precompute"], 2)}
    print(f"precompute: {clock.times['precompute']:.1f}s "
          f"(N={len(ytr)}, features={args.m ** 2}, device={device})", flush=True)

    fit_info = {}
    with stage("optimize"), clock.section("optimize"):
        params, loss, iters = fit_lbfgs(
            model.training_loss, model.params(), max_iters=args.iters, info=fit_info,
            # the large-scale protocols' line search: Armijo and an
            # approximate decrease, about 1.1 evaluations an iteration
            curv_rtol=10.0,
        )
    opt_phases = {"exec_s": round(clock.times["optimize"], 2)}
    print(f"optimize: {clock.times['optimize']:.1f}s "
          f"(ELBO={-float(loss):.2f}, {int(iters)} iters)", flush=True)

    with stage("predict"), clock.section("predict"):
        # factor once, predict many: both metrics use one posterior
        t0 = time.perf_counter()
        post = model.posterior(params)
        _sync(device)
        t_factor = time.perf_counter() - t0
        t0 = time.perf_counter()
        mean, var = post.predict_f(Xte)
        ld = post.predict_log_density((Xte, yte))
        _sync(device)
        t_cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        post.predict_f(Xte)
        _sync(device)
        t_warm = time.perf_counter() - t0
    pred_phases = {"factor_s": round(t_factor, 2), "cold_s": round(t_cold, 2),
                   "warm_exec_s": round(t_warm, 2)}
    record.update(model=model, params=params, posterior=post, mean=mean, var=var)
    yte_d = torch.as_tensor(yte, dtype=torch.float64, device=device)
    score_mse, score_nll = float(mse(yte_d, mean)), float(nlpd(ld))
    print(f"predict: {clock.times['predict']:.1f}s ({args.n_test} points, "
          f"phases {pred_phases})")
    print(f"MSE = {score_mse:.6f}")
    print(f"NLL = {score_nll:.6f}")
    print("timings:", {k: round(v, 2) for k, v in clock.summary().items()}, flush=True)

    cpu_baseline = None
    if args.cpu_baseline_steps:
        cpu_baseline = cpu_baseline_steps(args, (Xtr, ytr), bases, kernels,
                                          opt_phases["exec_s"] / max(int(iters), 1))
        print(f"cpu-f64 baseline: {cpu_baseline}", flush=True)
    return {
        "n_train": len(ytr),
        "n_test": args.n_test,
        "features": args.m ** 2,
        "order": args.order,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "elbo": -float(loss),
        "iters": int(iters),
        "grad_norm": fit_info.get("grad_norm"),
        "converged": fit_info.get("converged"),
        "opt_info": fit_info,
        "mse": score_mse,
        "nll": score_nll,
        "timings_s": {k: round(v, 2) for k, v in clock.summary().items()},
        "opt_phases_s": opt_phases,
        "stats_phases_s": stats_phases,
        "pred_phases_s": pred_phases,
        "cpu_f64_baseline": cpu_baseline,
    }


def mesh_rank(rank, world, group, device, args) -> dict:
    """``run`` on one rank of ``run_mesh``'s group; rank 0 writes the
    artifact to ``--out``."""
    artifact = run(args, group=group, rank=rank, world=world, device=device)
    if rank == 0 and args.out:
        with open(args.out, "w") as f:
            json.dump(artifact, f, indent=1)
    return artifact


def run_mesh(args, timeout: float = 3600.0) -> dict:
    """The protocol on ``args.mesh`` ranks (``--mesh``): on the first
    ``args.mesh`` CUDA devices over NCCL, or with ``--device cpu`` on the
    CPU over gloo.  Returns rank 0's artifact."""
    backend = "gloo" if args.device == "cpu" else "nccl"
    if backend == "nccl" and args.device not in (None, "cuda"):
        raise ValueError("--mesh places rank r on cuda:r: pass no --device, or --device cpu")
    if args.data is None and args.n % args.mesh:
        raise ValueError(f"--n {args.n} training rows do not divide into --mesh {args.mesh} "
                         "shards")
    out = run_ranks(file_function_rank, args.mesh, args=(os.path.abspath(__file__),
                                                           "mesh_rank", args),
                    backend=backend, timeout=timeout)
    return out[0]


def cpu_baseline_steps(args, train, bases, kernels, exec_per_iter_s) -> dict:
    """The port's plain versions on the CPU at the same shape: the model's
    construction, a first value-and-grad step, then ``--cpu-baseline-steps``
    more, each to ``backward()``."""
    t0 = time.perf_counter()
    model = GPRKron(train, kernels, bases, noise_variance=NOISE, device="cpu")
    t_pre = time.perf_counter() - t0

    def step():
        model.zero_grad(set_to_none=True)
        model.training_loss().backward()

    t0 = time.perf_counter()
    step()
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(args.cpu_baseline_steps):
        step()
    step_s = (time.perf_counter() - t0) / args.cpu_baseline_steps
    return {
        "device": "cpu",
        "m": args.m,
        "t_precompute_s": round(t_pre, 2),
        "first_call_s": round(t_first, 2),
        "step_value_grad_s": round(step_s, 3),
        "steps_timed": args.cpu_baseline_steps,
        "cpu_loadavg": round(os.getloadavg()[0], 2),
        # per L-BFGS iteration, its line-search evaluations included
        # (opt_info.evals_per_iter)
        "gpu_exec_per_iter_s": round(exec_per_iter_s, 3),
        "vs_baseline_step": round(step_s / exec_per_iter_s, 1) if exec_per_iter_s else None,
    }


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2_000_000)
    ap.add_argument("--n-test", type=int, default=100_000)
    ap.add_argument("--m", type=int, default=100)
    ap.add_argument("--order", type=int, default=4)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--mesh", type=int, default=0, help="data-parallel devices")
    ap.add_argument("--data", type=str, default=None)
    ap.add_argument("--out", type=str, default=None,
                    help="write a JSON metrics artifact here")
    ap.add_argument("--cpu-baseline-steps", type=int, default=0,
                    help="time K value+grad steps of the plain versions on the CPU "
                         "at the same shape")
    ap.add_argument("--device", type=str, default=None,
                    help="the device to run on (default: the CUDA device; 'cpu' for the CPU)")
    return ap


def main():
    args = parser().parse_args()
    if args.mesh:
        run_mesh(args)  # rank 0 writes --out
        return
    artifact = run(args)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(artifact, f, indent=1)


if __name__ == "__main__":
    main()
