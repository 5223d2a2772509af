"""SVGP1D and fit_svgp (models/svgp.py) and the band products they use,
against the JAX package's ``asvgp_tpu.models.svgp`` and ``banded.ops``.

The same float64 function on both sides: values and gradients must agree
to 1e-10 relative, predictions to 1e-10 of the largest value, the band
products exactly up to the order of two sums.  ``fit_svgp`` runs on JAX's
own index stream (drawn here with the JAX loop's ``split``/``randint``
calls and handed over as ``indices``): losses per step ≤ 1e-10 relative,
final parameters ≤ 1e-9.  The optimal-q identity of tests/test_svgp.py is
held in the port alone.  On the CPU the Cholesky and Takahashi kernels
(K9–K12) run their plain versions; the ``cuda`` test runs them on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asvgp_tpu.banded import layout as jlayout
from asvgp_tpu.banded import ops as jops
from asvgp_tpu.basis import B3Spline as JB3Spline
from asvgp_tpu.models import Matern32 as JMatern32
from asvgp_tpu.models.svgp import SVGP1D as JSVGP1D
from asvgp_tpu.models.svgp import fit_svgp as jfit_svgp
from asvgp_tpu_torch import banded
from asvgp_tpu_torch.banded import core, single
from asvgp_tpu_torch.basis import B3Spline
from asvgp_tpu_torch.models import GPR1D, SVGP1D, Matern32, fit_svgp
from asvgp_tpu_torch.train import Adam
from test_torch_adam import jax_indices

N, M, BATCH, STEPS = 512, 24, 64, 10
KERNEL, NOISE = (0.8, 0.3), 0.15


def rel(got, want):
    got = np.asarray(got.detach().cpu() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def data(n=N, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.uniform(0.02, 0.98, n)
    return x, np.sin(8 * x) + 0.1 * rng.randn(n)


def models(num_data=N, m=M):
    port = SVGP1D(Matern32(*KERNEL), B3Spline(0.0, 1.0, m), noise_variance=NOISE,
                  num_data=num_data, device="cpu")
    ref = JSVGP1D(JMatern32(*KERNEL), JB3Spline(0.0, 1.0, m), noise_variance=NOISE,
                  num_data=num_data)
    return port, ref


def moved_params(seed=1, m=M):
    """Parameters away from the prior: a random mean and correction."""
    rng = np.random.RandomState(seed)
    _, ref = models(m=m)
    p = jax.tree.map(np.asarray, ref.init_params())
    p["q_mu"] = rng.randn(m)
    p["q_prec_corr"] = 0.5 * rng.randn(4, m)
    p["kernel"]["raw_variance"] = p["kernel"]["raw_variance"] + 0.2
    return p


def leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from leaves(tree[key], prefix + (key,))
    else:
        yield prefix, tree


def as_torch(params, requires_grad=False):
    return jax.tree.map(lambda v: torch.tensor(np.asarray(v), dtype=torch.float64,
                                               requires_grad=requires_grad), params)


@pytest.mark.parametrize("k", [1, 3])
def test_band_products_and_masks_match_jax(k):
    rng = np.random.RandomState(k)
    m = 17
    a, b, x = rng.randn(k + 1, m), rng.randn(k + 2, m), rng.randn(m)
    kw = dict(a_lower=k, a_upper=0, b_lower=1, b_upper=k, out_lower=k, out_upper=1)

    @jax.jit
    def reference(a, b, x):
        return (jops.product_band_band(a, b, **kw),
                jops.matvec_band(b, x, lower=1, upper=k), jops.matvec_symmetric_band(a, x),
                jlayout.mask_lower_band(a), jlayout.mask_band(b, 1, k))

    want = reference(*map(jnp.asarray, (a, b, x)))
    ta, tb, tx = map(torch.from_numpy, (a, b, x))
    got = (banded.product_band_band(ta, tb, **kw), banded.matvec_band(tb, tx, lower=1, upper=k),
           banded.matvec_symmetric_band(ta, tx), banded.mask_lower_band(ta),
           banded.mask_band(tb, 1, k))
    for g, w in zip(got, want):
        assert rel(g, w) <= 1e-15


def grads_close(params, want, tol=1e-10):
    """Each gradient leaf within ``tol`` of the largest reference entry (at
    least 1): a component that vanishes in exact arithmetic is held in
    absolute terms."""
    ws = [np.asarray(w) for _, w in leaves(want)]
    scale = max(1.0, max(float(np.max(np.abs(w))) for w in ws))
    for (path, g), w in zip(leaves(params), ws):
        got = np.zeros_like(w) if g.grad is None else g.grad.numpy()  # None: no dependence
        assert float(np.max(np.abs(got - w))) <= tol * scale, path


def _jax_terms():
    x, y = data()
    _, ref = models()
    p = jax.tree.map(jnp.asarray, moved_params())
    xb, yb = jnp.asarray(x[:100]), jnp.asarray(y[:100])
    elbo, grad = jax.jit(jax.value_and_grad(ref.elbo))(p, xb, yb)
    kl, kl_grad = jax.jit(jax.value_and_grad(ref.kl))(p)
    mean, var = ref.predict_f(p, x[100:160])
    lpd = ref.predict_log_density(p, (x[100:160], y[100:160]))
    return (float(elbo), grad, float(kl), kl_grad, np.asarray(mean), np.asarray(var),
            np.asarray(lpd))


def test_svgp_terms_and_gradients_match_jax():
    """``elbo``, ``kl``, ``predict_f`` and ``predict_log_density`` and the
    gradients of the first two, at parameters away from the prior."""
    x, y = data()
    port, _ = models()
    params = moved_params()
    elbo, grad, kl, kl_grad, mean, var, lpd = _jax_terms()

    p = as_torch(params, requires_grad=True)
    got = port.elbo(x[:100], y[:100], p)
    got.backward()
    assert abs(float(got.detach()) - elbo) <= 1e-10 * abs(elbo)
    grads_close(p, grad)

    p = as_torch(params, requires_grad=True)
    got = port.kl(p)
    got.backward()
    assert abs(float(got.detach()) - kl) <= 1e-10 * abs(kl)
    grads_close(p, kl_grad)

    # the module's own parameters stand in for the pytree
    port.load_jax_params(params)
    m_got, v_got = port.predict_f(x[100:160])
    assert rel(m_got, mean) <= 1e-10 and rel(v_got, var) <= 1e-10
    assert rel(port.predict_log_density((x[100:160], y[100:160])), lpd) <= 1e-10
    with pytest.raises(NotImplementedError):
        port.predict_f(x[:3], full_cov=True)


def test_params_round_trip():
    port, _ = models()
    params = moved_params()
    port.load_jax_params(params)
    back = port.params()
    for (path, got), (_, want) in zip(leaves(back), leaves(params)):
        assert np.array_equal(got.numpy(), np.asarray(want)), path
    assert {name for name, _ in port.named_parameters()} == {
        "raw_variance", "raw_lengthscales", "raw_noise_variance", "q_mu", "q_prec_corr"}


def test_optimal_q_recovers_collapsed_elbo():
    """The Titsias-optimal (mu, C) in the uncollapsed ELBO gives the
    collapsed GPR1D ELBO exactly; any other q is below it."""
    from asvgp_tpu_torch.features.spline_features import make_kuu

    x, y = data(400)
    basis = B3Spline(0.0, 1.0, 28)
    kernel = Matern32(0.8, 0.3)
    gpr = GPR1D((x, y), kernel, basis, noise_variance=NOISE, device="cpu")
    with torch.no_grad():
        collapsed = float(gpr.elbo())
    kuu = make_kuu(kernel, basis)
    p_band = gpr.kufkfu_band / NOISE + kuu
    mu = banded.cholesky_solve_band(banded.cholesky_band(p_band), gpr.kuf_y) / NOISE
    svgp = SVGP1D(kernel, basis, noise_variance=NOISE, num_data=400, device="cpu")
    params = {**svgp.init_params(), "q_mu": mu,
              "q_prec_corr": banded.cholesky_band(gpr.kufkfu_band) / np.sqrt(NOISE)}
    with torch.no_grad():
        uncollapsed = float(svgp.elbo(x, y, params))
        worse = float(svgp.elbo(x, y, {**params, "q_mu": 1.1 * mu}))
    assert abs(uncollapsed - collapsed) <= 1e-9 * abs(collapsed)
    assert worse < collapsed


def test_fit_svgp_matches_jax():
    x, y = data()
    port, ref = models(num_data=None)
    want_params, want_losses = jfit_svgp(ref, jnp.asarray(x), jnp.asarray(y), ref.init_params(),
                                         batch_size=BATCH, steps=STEPS, learning_rate=1e-3)
    params, losses = fit_svgp(port, x, y, port.init_params(), batch_size=BATCH, steps=STEPS,
                              learning_rate=1e-3, device="cpu",
                              indices=jax_indices(0, STEPS, BATCH, N))
    assert port.num_data == N
    want = np.asarray(want_losses)
    assert float(np.max(np.abs(losses.numpy() - want) / np.abs(want))) <= 1e-10
    for (path, got), (_, w) in zip(leaves(params), leaves(want_params)):
        assert rel(got, w) <= 1e-9, path


def test_svgp_runs_the_kernels_as_the_jax_structure_says(monkeypatch):
    """The launch pattern that chip_smoke.py holds on the card, counted here
    at the kernel wrappers: a training step K9 ×4, K11 ×3 and their
    adjoints K10 ×4, K12 ×3 (``elbo`` calls ``kl``, which factors again);
    the C* seeding one K9; a prediction K9 ×2, K11 ×2."""
    calls = dict.fromkeys(("chol_fwd", "chol_bwd", "tak_fwd", "tak_bwd"), 0)
    for name in calls:
        fn = getattr(single, name)

        def counted(*args, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*args)

        monkeypatch.setattr(single, name, counted)
    x, y = data()
    port, _ = models(num_data=None)
    params, _ = fit_svgp(port, x, y, port.init_params(), batch_size=16, steps=2, device="cpu")
    assert calls == {"chol_fwd": 1 + 2 * 4, "chol_bwd": 2 * 4, "tak_fwd": 2 * 3, "tak_bwd": 2 * 3}
    calls.update(dict.fromkeys(calls, 0))
    port.predict_f(x[:10], params=params)
    assert calls == {"chol_fwd": 2, "chol_bwd": 0, "tak_fwd": 2, "tak_bwd": 0}


def test_device_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card, tested on the GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        SVGP1D(Matern32(), B3Spline(0.0, 1.0, M))
    port, _ = models()
    x, y = data()
    with pytest.raises(RuntimeError, match="CUDA"):
        fit_svgp(port, x, y, port.init_params(), steps=1)


@pytest.mark.cuda
def test_cuda_fit_svgp_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA sweeps have no CPU mode")
    x, y = data()
    idx = jax_indices(0, STEPS, BATCH, N)
    cpu, _ = models(num_data=None)
    want_params, want = fit_svgp(cpu, x, y, cpu.init_params(), batch_size=BATCH, steps=STEPS,
                                 device="cpu", indices=idx)
    gpu = SVGP1D(Matern32(*KERNEL), B3Spline(0.0, 1.0, M), noise_variance=NOISE)
    core.reset_counters()
    params, losses = fit_svgp(gpu, x, y, gpu.init_params(), batch_size=BATCH, steps=STEPS,
                              indices=idx)
    torch.cuda.synchronize()
    assert {k: v for k, v in core.LAUNCHES.items() if v} == {
        "chol_fwd": 1 + 4 * STEPS, "chol_bwd": 4 * STEPS, "tak_fwd": 3 * STEPS,
        "tak_bwd": 3 * STEPS}
    assert core.PLAIN_CALLS["cuda"] == 0
    assert float(torch.max(torch.abs(losses - want) / torch.abs(want))) <= 1e-10
    for (path, got), (_, w) in zip(leaves(params), leaves(want_params)):
        assert got.is_cuda and rel(got, w) <= 1e-9, path


def test_adam_turns_rounding_level_gradients_into_lr_sized_steps():
    """The reference behaviour behind the SVGP losses that part from the
    JAX run at ~1e-7 in three middle steps of the north star's 20
    (tools/svgp_qmu_trace.py; ROADMAP queue 3).  A feature that no batch
    has touched gets a q_mu gradient from the KL term alone, which cancels
    to rounding there: at step 5 of that run one such entry is +5.2e-12 in
    the port and −1.8e-12 in the JAX package, against a largest entry of
    1.6e5.  Adam normalises each entry by its own running magnitude, so the
    two take steps of opposite sign and up to the learning rate in size.

    Here the port's Adam (``train.Adam``, which ``adam_loop`` steps with)
    and the JAX loop's ``optax.adam`` agree on one gradient history to
    rounding, and two histories that differ only at a rounding-level entry
    (±3e-11 of the largest one) part there by about twice the learning rate per step."""
    import optax

    lr, steps = 1e-3, 3
    big = 1.5e5
    history = {sign: [np.array([big * (1 + 0.1 * s), sign * 3e-11 * big]) for s in range(steps)]
               for sign in (1.0, -1.0)}

    def torch_adam(grads):
        p = torch.zeros(2, dtype=torch.float64)
        opt = Adam(lr)
        state = opt.init(p)
        for g in grads:
            updates, state = opt.update(torch.from_numpy(g), state)
            p = opt.apply(p, updates)
        return p.numpy()

    def optax_adam(grads):
        opt = optax.adam(lr)
        p = jnp.zeros(2)
        state = opt.init(p)
        for g in grads:
            updates, state = opt.update(jnp.asarray(g), state, p)
            p = optax.apply_updates(p, updates)
        return np.asarray(p)

    for grads in history.values():
        assert rel(torch_adam(grads), optax_adam(grads)) <= 1e-12
    plus, minus = (torch_adam(h) for h in history.values())
    assert plus[0] == minus[0]
    assert minus[1] - plus[1] >= 1.9 * lr * steps
