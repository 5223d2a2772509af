"""Smoke run of the PyTorch/CUDA port (asvgp_tpu_torch) on one NVIDIA GPU.

Drives the GPR1D serving path at the north-star shape — N = 10⁶ points from
bench.py's generator, m = 10⁴ B3-spline features on [0, 1], Matérn-3/2 —
through the port's public entry points, on the card:

  0. card check: prints nvidia-smi's name and power limit; no CUDA, no run
  1. build: compiles the CUDA sweeps (csrc/banded_core.cu) with nvcc
  2. kernel parity: K1 + K2 against their plain PyTorch versions, for
     k = 1..6 on random SPD bands, and at the main path's shapes on its
     real Kuu and P
  3. main path: GPR1D on the card → training_loss (held to the CPU-float64
     value of the JAX package) → posterior → predict_f on 10⁵ held-out
     points in batches → NLPD; predictions held against a posterior built
     by the plain versions on a CPU copy
  4. proof of path: the kernels' launch counters rose in phase 3 and no
     plain version ran on a CUDA tensor
  5. times on the card (CUDA events, median of REPS)

Every phase prints one JSON line; any failure raises.  The second-last
line lists the kernels, the last line is the device record.  Run from the
repository root:

    python3 chip_smoke.py
"""

from __future__ import annotations

import copy
import json
import math
import subprocess
import time

import numpy as np
import torch

N = 1_000_000
M = 10_000
SEED = 0
N_TEST = 100_000
TEST_SEED = 1
PREDICT_BATCH = 30_000  # 10⁵ points in 4 chunks: the last one is padded
PARITY_M = 1000
REPS = 5

# training_loss at bench.py's shape and init params, computed on a CPU in
# float64 through the JAX package's lax.scan recursions
ANCHOR_LOSS = 233371.85202107206
# max |kernel - plain| / max |plain| over every output: random diagonally
# dominant bands are well conditioned, so the two summation orders agree to
# a few ulps of float64
TOL_PARITY = 1e-11
# at the main path's shapes κ(Kuu) amplifies the rounding differences
# between the two orders of summation
TOL_PARITY_MAIN = 1e-8
TOL_LOSS = 1e-7      # relative, against ANCHOR_LOSS
TOL_PREDICT = 1e-9   # max |card - cpu| / max |cpu|, mean and variance

CU_SOURCE = "asvgp_tpu_torch/csrc/banded_core.cu"
REPLACES = {
    "chol_pair_solve": "asvgp_tpu/banded/pallas_ds_core.py:74",
    "tak_pair_solve": "asvgp_tpu/banded/pallas_ds_core.py:152",
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def bench_data(n: int, seed: int):
    """bench.py's generator: ~700 periods on (0.005, 0.995), noise 0.3."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(0.005, 0.995, n)
    y = np.sin(4400.0 * x) + 0.5 * np.sin(1100.0 * x) + 0.3 * rng.randn(n)
    return x, y


def spd_band(k: int, m: int, rng) -> np.ndarray:
    """Random diagonally dominant SPD lower band (k+1, m), right-padded."""
    a = 0.3 * rng.randn(k + 1, m)
    a[0] = np.abs(a[0]) + 2.0 * k + 1.0
    for j in range(1, k + 1):
        a[j, m - j:] = 0.0
    return a


def rel_err(got, ref) -> float:
    ref = ref.detach().to("cpu")
    got = got.detach().to("cpu")
    return float(torch.max(torch.abs(got - ref)) / torch.max(torch.abs(ref)))


def abs_err(got, ref) -> float:
    return float(torch.max(torch.abs(got.detach().cpu() - ref.detach().cpu())))


def cuda_ms(fn, reps: int = REPS) -> dict:
    """Median and all times (ms) of ``fn`` between CUDA events, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end))
    return {"median_ms": float(np.median(ts)), "ms": ts}


def make_model(x, y, m: int, device):
    from asvgp_tpu_torch.basis import B3Spline
    from asvgp_tpu_torch.models import GPR1D, Matern32

    return GPR1D(
        (x, y), Matern32(variance=1.0, lengthscales=1e-3), B3Spline(0.0, 1.0, m),
        noise_variance=0.1, device=device,
    )


def model_bands(model):
    """The main path's (Kuu, P, Kuf·y) at the model's init params."""
    from asvgp_tpu_torch.features.spline_features import make_kuu

    with torch.no_grad():
        kernel, lik = model._build()
        kuu = make_kuu(kernel, model.basis)
        p_band = model.kufkfu_band / lik.variance + kuu
    return kuu, p_band, model.kuf_y


def kernel_parity(device, m: int, bands) -> dict:
    """K1 + K2 against their plain versions on CPU copies of the inputs.

    ``bands`` = (kuu, p_band, b) on ``device``.  Each kernel is given the
    same inputs as its plain version; the chain of both is compared on all
    seven outputs of factor_takahashi_solve."""
    from asvgp_tpu_torch.banded import core

    kuu, p_band, b = bands
    cpu = [t.detach().to("cpu") for t in bands]
    k1 = core.chol_pair_solve(kuu, p_band, b)
    k1_ref = core.chol_pair_solve_plain(*cpu)
    k2 = core.tak_pair_solve(*k1)
    k2_ref = core.tak_pair_solve_plain(*[t.to("cpu") for t in k1])
    chain = core.factor_takahashi_solve(kuu, p_band, b)
    chain_ref = core.factor_takahashi_solve_plain(*cpu)
    return {
        "k": kuu.shape[0] - 1,
        "m": m,
        "chol_pair_solve_rel": max(rel_err(g, r) for g, r in zip(k1, k1_ref)),
        "chol_pair_solve_abs": max(abs_err(g, r) for g, r in zip(k1, k1_ref)),
        "tak_pair_solve_rel": max(rel_err(g, r) for g, r in zip(k2, k2_ref)),
        "tak_pair_solve_abs": max(abs_err(g, r) for g, r in zip(k2, k2_ref)),
        "chain_rel": max(rel_err(g, r) for g, r in zip(chain, chain_ref)),
    }


def main_path(device, x, y, x_test, y_test, m: int, batch: int) -> dict:
    """Phase 3 and 4: the serving path on ``device`` with fresh counters."""
    from asvgp_tpu_torch.banded import core
    from asvgp_tpu_torch.stats import compute_stats
    from asvgp_tpu_torch.train import nlpd

    xt = torch.as_tensor(x_test, dtype=torch.float64, device=device)
    yt = torch.as_tensor(y_test, dtype=torch.float64, device=device)
    core.reset_counters()
    model = make_model(x, y, m, device)
    with torch.no_grad():
        loss = float(model.training_loss())
    post = model.posterior()
    mean, var = post.predict_f(xt, batch=batch)
    score = float(nlpd(post.predict_log_density((xt, yt))))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    launches = dict(core.LAUNCHES)
    plain_calls = dict(core.PLAIN_CALLS)

    if not (mean.shape == var.shape == (x_test.shape[0], 1)):
        raise AssertionError(f"predict_f shapes {tuple(mean.shape)}, {tuple(var.shape)}")
    if not (bool(torch.isfinite(mean).all()) and bool(torch.isfinite(var).all())):
        raise AssertionError("non-finite predictions")
    if not bool((var > 0).all()):
        raise AssertionError(f"non-positive variance: min {float(var.min())}")
    if not math.isfinite(score):
        raise AssertionError(f"NLPD {score} is not finite")

    # the statistics are built in a fixed order of summation: a second build
    # from the same data must give the same bits
    again = compute_stats(
        model.basis,
        torch.as_tensor(x, dtype=torch.float64, device=device),
        torch.as_tensor(y, dtype=torch.float64, device=device),
    )
    stats_repeatable = bool(
        torch.equal(again.kuf_y, model.kuf_y)
        and torch.equal(again.kufkfu_band, model.kufkfu_band)
    )

    # the same posterior from the plain versions, on a CPU copy
    cpu_model = copy.deepcopy(model).to("cpu")
    t0 = time.perf_counter()
    cpu_post = cpu_model.posterior()
    cpu_posterior_s = time.perf_counter() - t0
    mean_c, var_c = cpu_post.predict_f(torch.as_tensor(x_test), batch=batch)
    return {
        "model": model,
        "posterior": post,
        "x_test": xt,
        "loss": loss,
        "nlpd": score,
        "min_var": float(var.min()),
        "mean_rel_vs_cpu": rel_err(mean, mean_c),
        "var_rel_vs_cpu": rel_err(var, var_c),
        "cpu_plain_posterior_s": cpu_posterior_s,
        "stats_repeatable": stats_repeatable,
        "launches": launches,
        "plain_calls": plain_calls,
    }


def main() -> None:
    # ---- phase 0: card check ------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit(
            "chip_smoke: torch.cuda.is_available() is false; this script runs "
            "only on an NVIDIA GPU"
        )
    from asvgp_tpu_torch.banded import _build, core

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    card = {"name_power": smi, "kind": torch.cuda.get_device_name(0)}
    emit("0_card", **card, torch=torch.__version__, cuda=torch.version.cuda)

    # ---- phase 1: build ----------------------------------------------------
    t0 = time.perf_counter()
    info = _build.build()
    _build.load()
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    emit("1_build", seconds=time.perf_counter() - t0, nvcc_seconds=info["seconds"],
         library=info["path"], ptxas=ptxas)

    # ---- phase 2: kernel parity --------------------------------------------
    rng = np.random.RandomState(SEED)
    for k in range(1, 7):
        bands = [spd_band(k, PARITY_M, rng), spd_band(k, PARITY_M, rng),
                 rng.randn(PARITY_M)]
        bands = [torch.as_tensor(a, dtype=torch.float64, device=device) for a in bands]
        res = kernel_parity(device, PARITY_M, bands)
        emit("2_parity_random", **res, tol=TOL_PARITY)
        if max(res["chain_rel"], res["chol_pair_solve_rel"],
               res["tak_pair_solve_rel"]) > TOL_PARITY:
            raise AssertionError(f"kernel parity at k={k}: {res}")

    x, y = bench_data(N, SEED)
    x_test, y_test = bench_data(N_TEST, TEST_SEED)
    x_d = torch.as_tensor(x, dtype=torch.float64, device=device)
    y_d = torch.as_tensor(y, dtype=torch.float64, device=device)
    parity_model = make_model(x_d, y_d, M, device)
    main_bands = model_bands(parity_model)
    main_parity = kernel_parity(device, M, main_bands)
    emit("2_parity_main_shape", **main_parity, tol=TOL_PARITY_MAIN)
    if max(main_parity["chain_rel"], main_parity["chol_pair_solve_rel"],
           main_parity["tak_pair_solve_rel"]) > TOL_PARITY_MAIN:
        raise AssertionError(f"kernel parity at the main path's shape: {main_parity}")

    # ---- phase 3: main path --------------------------------------------------
    run = main_path(device, x, y, x_test, y_test, M, PREDICT_BATCH)
    loss_rel = abs(run["loss"] - ANCHOR_LOSS) / abs(ANCHOR_LOSS)
    emit("3_main_path", n=N, m=M, n_test=N_TEST, batch=PREDICT_BATCH,
         training_loss=run["loss"], anchor=ANCHOR_LOSS, loss_rel_err=loss_rel,
         nlpd=run["nlpd"], min_var=run["min_var"],
         mean_rel_vs_cpu=run["mean_rel_vs_cpu"], var_rel_vs_cpu=run["var_rel_vs_cpu"],
         cpu_plain_posterior_s=run["cpu_plain_posterior_s"],
         stats_repeatable=run["stats_repeatable"])
    if not loss_rel <= TOL_LOSS:
        raise AssertionError(f"training_loss {run['loss']} vs {ANCHOR_LOSS}: rel {loss_rel}")
    if not max(run["mean_rel_vs_cpu"], run["var_rel_vs_cpu"]) <= TOL_PREDICT:
        raise AssertionError(f"predictions differ from the CPU posterior: {run}")
    if not run["stats_repeatable"]:
        raise AssertionError("a second stats build from the same data gave other bits")

    # ---- phase 4: proof of path -------------------------------------------
    launches, plain_calls = run["launches"], run["plain_calls"]
    emit("4_proof_of_path", launches=launches, plain_calls=plain_calls)
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    if plain_calls.get("cuda", 0) != 0:
        raise AssertionError(f"a plain version ran on a CUDA tensor: {plain_calls}")

    # ---- phase 5: times on the card ---------------------------------------
    from asvgp_tpu_torch.stats import compute_stats

    model, post, xt = run["model"], run["posterior"], run["x_test"]
    kuu, p_band, b = main_bands
    k1_out = core.chol_pair_solve(kuu, p_band, b)

    def elbo_value():
        with torch.no_grad():
            model.training_loss()

    times = {
        "stats_build": cuda_ms(lambda: compute_stats(model.basis, x_d, y_d)),
        "elbo_value": cuda_ms(elbo_value),
        "posterior": cuda_ms(model.posterior),
        "predict_1e5": cuda_ms(lambda: post.predict_f(xt, batch=PREDICT_BATCH)),
        "chol_pair_solve": cuda_ms(lambda: core.chol_pair_solve(kuu, p_band, b)),
        "tak_pair_solve": cuda_ms(lambda: core.tak_pair_solve(*k1_out)),
        "factor_takahashi_solve": cuda_ms(lambda: core.factor_takahashi_solve(kuu, p_band, b)),
        "chol_pair_solve_plain": cuda_ms(lambda: core.chol_pair_solve_plain(kuu, p_band, b)),
        "tak_pair_solve_plain": cuda_ms(lambda: core.tak_pair_solve_plain(*k1_out)),
    }
    for name, t in times.items():
        emit("5_time", what=name, card=smi, median_ms=t["median_ms"], ms=t["ms"])

    kernels = []
    for name in ("chol_pair_solve", "tak_pair_solve"):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": CU_SOURCE,
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": main_parity[f"{name}_abs"],
            "ms": times[name]["median_ms"],
            "plain_ms": times[f"{name}_plain"]["median_ms"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
