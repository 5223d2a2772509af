"""The chunk-length rule of the partitioned linear sweeps (K2, K4, K6 and
K7, K8, K10-K12, K18-K20, K23), emulated on the CPU.

Each such sweep carries an affine state across chunks: the scan applies a
chunk's map H to an incoming carry that holds the rounding of every chunk
before it.  At a high κ(Kuu) the maps of short chunks are large (5.9e4 at
64 columns for the large-regression protocol's Kuu), and the carries lose
digits.  So the card chooses each call's chunk length from its factors
(``banded/chunk_rule.py``, ``chunk_rule_kernel`` in
csrc/forward_sweeps.cuh): the shortest tile multiple, no shorter than the
partition's length, after which an interior chunk's homogeneous response
has decayed below a threshold.  Here, at the additive model's Kuu
(B3 × Matérn-3/2, ℓ/δ = 49.4, m = 1000 and 2000) and at the
large-regression protocol's (B3 × Matérn-5/2, m = 1000, ℓ = 0.05,
κ = 7.8e9; its P on the protocol's data at 2·10⁴ points), each sweep's
emulation (the partition tests') at the rule's length lies within 5× the
one-chunk run's own spread under a perturbation of its factors by one
rounding (1e-16 relative; float32: 6e-8), where at the old 64-column
chunks it lies farther; its first chunk stays the one-chunk run bit for
bit; and at the north star's ℓ/δ = 10 the rule keeps 64 columns.  Past
the two-chunk limit the adjoints and the Takahashi sweep also refine their
scanned carries (each chunk but the last rerun from its scanned carry):
at the protocol's Kuu the trace term's gradient, a sum over the Cholesky
adjoint's output that cancels twelve digits, keeps the one-chunk run's
accuracy only with it.
"""

import functools

import numpy as np
import pytest
import torch

from asvgp_tpu_torch.banded import chunk_rule, ops, tan, twist
from asvgp_tpu_torch.banded.tan import band_weights
from asvgp_tpu_torch.banded.twisted import split_point
from asvgp_tpu_torch.basis import B3Spline
from asvgp_tpu_torch.features.spline_features import make_kuu
from asvgp_tpu_torch.models import GPR1D, Matern
from test_torch_adjoint_partition import partitioned
from test_torch_core_partition import partitioned_k2
from test_torch_forward_partition import partitioned_tak
from test_torch_tan_partition import partitioned_k4
from test_torch_twist_partition import partitioned_k6

OLD = 64      # the partitions' length at k = 3 before the rule
SPREAD = 5.0  # the bar: within 5× the one-chunk run's own spread
EPS = {np.float64: 1e-16, np.float32: 6e-8}


def make_data(n, seed):
    """The large-regression protocol's synthetic data."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(0.002, 0.998, n)
    f = np.sin(7 * x) + 0.5 * np.sin(23 * x) * np.exp(-x)
    return x, f + 0.3 * rng.randn(n)


@functools.lru_cache(maxsize=None)
def bands(setting):
    """(Kuu, T = ∂Kuu/∂ℓ, P, Kuf·y) at a setting: "i1000" and "i2000" the
    additive model's Kuu at m = 1000 / 2000 (ℓ/δ = 49.4; P on 100 m points
    of the partition tests' data, noise 0.1), "ii" the large-regression
    protocol's, "ns" the north star's ℓ/δ = 10 (m = 320)."""
    if setting == "ii":
        m, nu2, ell, noise = 1000, 5, 0.05, 1.0
        x, y = make_data(20_000, 0)
    else:
        m = {"i1000": 1000, "i2000": 2000, "ns": 320}[setting]
        nu2, noise = 3, 0.1
        ell = (10.0 if setting == "ns" else 49.4) / (m - 3)
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


def perturbed(a, dt, seed):
    """``a`` times 1 + eps·N(0, 1) entrywise, in ``dt``: one rounding."""
    a = np.asarray(a, np.float64)
    rng = np.random.RandomState(seed)
    return (a * (1.0 + EPS[dt] * rng.standard_normal(a.shape))).astype(dt)


def dist(got, one):
    got = got if isinstance(got, tuple) else (got,)
    one = one if isinstance(one, tuple) else (one,)
    return max(float(np.nanmax(np.abs(np.asarray(g, np.float64) - np.asarray(o, np.float64)))
                     / np.nanmax(np.abs(np.asarray(o, np.float64))))
               for g, o in zip(got, one))


def linear_case(sweep, setting, dt):
    """(run(lc, perturbed) -> outputs, the factors the rule reads, walk)."""
    kuu = bands(setting)[0]
    l = ops.cholesky_band_plain(kuu.to(torch.float64)).numpy().astype(dt)
    pl = perturbed(l, dt, 99)
    rng = np.random.RandomState(12)
    cot = rng.randn(*l.shape).astype(dt)
    s = ops.takahashi_inverse_band_plain(torch.from_numpy(l)).numpy()

    def run(lc, pert):
        # past the two-chunk limit the kernels refine the scanned carries
        # at the rule's lengths, not at the partition's own
        lf, refine = (pl if pert else l), (2 if lc > OLD else 0)
        if sweep == "chol_bwd":
            return partitioned(lf, cot, lc, refine=refine)[0]
        if sweep == "tak_bwd":
            return partitioned(lf, cot, lc, s=s, chol=False, refine=refine)[0]
        return partitioned_tak(lf, lc, refine=refine)[0]

    return run, (l,), l.shape[1]


def pair_case(sweep, setting):
    """K2 (``sweep`` "k2") or K4 ("k4") from their plain producers'
    outputs, the factors of Kuu and P perturbed for the spread."""
    kuu, tanb, p, b = bands(setting)
    if sweep == "k2":
        outs = tuple(t.numpy() for t in twist_free_k1(kuu, p, b))
        emulate = partitioned_k2
    else:
        outs = tuple(t.numpy() for t in tan.chol_pair_solve_tan_plain(kuu, tanb, p, b))
        emulate = partitioned_k4
    pert = tuple(perturbed(o, np.float64, 98 + i) if i < 2 else o for i, o in enumerate(outs))

    def run(lc, pt):
        args = pert if pt else outs
        return tuple(t.numpy() for t in emulate(*(torch.from_numpy(a) for a in args), lc)[0])

    return run, outs[:2], kuu.shape[1]


def twist_free_k1(kuu, p, b):
    from asvgp_tpu_torch.banded import core
    return core.chol_pair_solve_plain(kuu, p, b)


def k6_case(setting):
    kuu, tanb, p, b = bands(setting)
    m, k = kuu.shape[1], kuu.shape[0] - 1
    k5 = twist.chol_quad_solve_tan_plain(kuu, tanb, p, b)
    _, z, x2, _ = twist.mid_step(kuu, tanb, p, b, k5[0], k5[1], k5[4])
    l_pert = torch.from_numpy(perturbed(k5[0].numpy(), np.float64, 97))

    def run(lc, pt):
        args = ((l_pert,) + tuple(k5[1:])) if pt else k5
        return tuple(t.numpy() for t in partitioned_k6(*args, z, x2, m, lc)[0])

    h = split_point(m, k)
    return run, tuple(k5[0].numpy()), m - h - k


# (sweep, setting, dtype, the rule's length)
CASES = [
    *[(s, st, np.float64, 256) for s in ("chol_bwd", "tak_bwd", "tak_fwd")
      for st in ("i1000", "i2000")],
    *[(s, "ii", np.float64, 384) for s in ("chol_bwd", "tak_bwd", "tak_fwd")],
    *[(s, "i1000", np.float32, 256) for s in ("chol_bwd", "tak_bwd", "tak_fwd")],
    ("k2", "i1000", np.float64, 256), ("k2", "ii", np.float64, 384),
    ("k4", "i1000", np.float64, 320), ("k4", "ii", np.float64, 384),
    ("k6", "i2000", np.float64, 320), ("k6", "ii", np.float64, 384),
]


@pytest.mark.parametrize("sweep, setting, dt, want_lc", CASES,
                         ids=[f"{c[0]}-{c[1]}-{np.dtype(c[2]).name}" for c in CASES])
def test_rule_length_keeps_the_one_chunk_accuracy(sweep, setting, dt, want_lc):
    """The rule's length at the setting, and the sweep's emulation there
    within 5× the one-chunk run's spread, its first chunk the one-chunk
    run bit for bit; at the old 64-column chunks it lies more than 5× the
    spread away (the fault the rule repairs)."""
    if sweep in ("k2", "k4"):
        run, factors, n = pair_case(sweep, setting)
        tau = chunk_rule.TAU if sweep == "k2" else chunk_rule.TAU_TAN
    elif sweep == "k6":
        run, factors, n = k6_case(setting)
        tau = chunk_rule.TAU_TAN
    else:
        run, factors, n = linear_case(sweep, setting, dt)
        tau = chunk_rule.TAU
    lc = chunk_rule.sweep_cols(factors, OLD, tau, n)
    assert lc == want_lc
    one = run(n, False)
    spread = dist(run(n, True), one)
    got = run(lc, False)
    assert 0.0 < spread and dist(got, one) <= SPREAD * spread, (dist(got, one), spread)
    old = run(OLD, False)
    assert dist(old, one) > SPREAD * spread
    if sweep not in ("k2", "k4", "k6"):
        # chunk 0 walks the last columns (the Takahashi adjoint the first)
        first = slice(0, lc) if sweep == "tak_bwd" else slice(n - lc, n)
        assert np.array_equal(got[:, first], one[:, first])


@pytest.mark.parametrize("m", [320, 10_000])
def test_rule_keeps_the_north_star_length(m):
    """At the north star's ℓ/δ = 10 the maps decay below 1e-5 in 64
    columns: the rule keeps the partitions' 64 columns at both thresholds,
    on Kuu and on P (m = 320), in float64 and float32."""
    if m == 320:
        kuu, _, p, _ = bands("ns")
        factors = [ops.cholesky_band_plain(a).numpy() for a in (kuu, p)]
    else:
        kuu = make_kuu(Matern(1.0, 1e-3, nu2=3), B3Spline(0.0, 1.0, m))
        factors = [ops.cholesky_band_plain(kuu).numpy()]
    factors += [f.astype(np.float32) for f in factors]
    for tau in (chunk_rule.TAU, chunk_rule.TAU_TAN):
        assert chunk_rule.sweep_cols(factors, OLD, tau) == OLD


@pytest.mark.parametrize("k, lc0", [(5, 128), (6, 192)])
def test_rule_never_shortens_the_partition(k, lc0):
    """At k = 5, 6 the partition's chunks are longer than a tile (so that
    the scan can stage every map): where the maps decay within one tile the
    rule keeps the partition's length, never a shorter one, for which the
    grids and the workspace would not suffice."""
    rng = np.random.RandomState(k)
    a = 0.3 * rng.randn(k + 1, 10_000)
    a[0] = np.abs(a[0]) + 2.0 * k + 1.0
    l = ops.cholesky_band_plain(torch.from_numpy(a)).numpy()
    assert chunk_rule.rule_cols(l, lc0, chunk_rule.TAU) == lc0
    assert chunk_rule.sweep_cols([l], lc0, chunk_rule.TAU_TAN) == lc0


def test_rule_takes_one_chunk_when_the_maps_do_not_decay():
    """At ℓ/δ = 100 (m = 320) no tile multiple within the walk brings the
    maps below the threshold: the rule takes the whole walk, one chunk;
    a factor that failed (NaN) gives one chunk too."""
    kuu = make_kuu(Matern(1.0, 100.0 / 317, nu2=3), B3Spline(0.0, 1.0, 320))
    l = ops.cholesky_band_plain(kuu).numpy()
    assert chunk_rule.sweep_cols([l], OLD, chunk_rule.TAU) == 320
    bad = l.copy()
    bad[:, 100:] = np.nan
    assert chunk_rule.rule_cols(bad, OLD, chunk_rule.TAU) == 320
    assert chunk_rule.sweep_cols([l[:, :64]], OLD, chunk_rule.TAU) == OLD


def test_refined_carries_keep_the_trace_gradient():
    """The trace term's gradient in ℓ at the protocol's Kuu, Σ Ā ∘ ∂Kuu/∂ℓ
    with Ā = chol_bwd(L, tak_bwd(L, S, w∘B)) (the collapsed core's
    backward, B = KufKfu): its terms cancel to 1e-12 of their absolute sum,
    so it keeps only a few digits.  At the rule's 384-column chunks the
    refined adjoints leave it within 5× of its move when L is perturbed by
    one rounding; from the scanned carries alone it lies more than 5×
    that away, though each adjoint's output lies within its own spread."""
    kuu, tanb, p, _ = bands("ii")
    l = ops.cholesky_band_plain(kuu)
    s = ops.takahashi_inverse_band_plain(l).numpy()
    m = l.shape[1]
    cot = (band_weights(3, m, l) * (p - kuu)).numpy()
    iv = (1.0 / l[0]).numpy()
    t = tanb.numpy()

    def grad(lf, lc, refine=0):
        lbar, _ = partitioned(lf, cot, lc, s=s, iv=iv, chol=False, refine=refine)
        return float(np.sum(partitioned(lf, lbar, lc, refine=refine)[0] * t))

    one = grad(l.numpy(), m)
    spread = max(abs(grad(perturbed(l.numpy(), np.float64, seed), m) - one) / abs(one)
                 for seed in (0, 1))
    lc = chunk_rule.sweep_cols([l.numpy()], OLD, chunk_rule.TAU)
    assert lc == 384 and 0.0 < spread
    assert abs(grad(l.numpy(), lc, refine=2) - one) / abs(one) <= SPREAD * spread
    assert abs(grad(l.numpy(), lc) - one) / abs(one) > SPREAD * spread
