"""The benchmark's frozen bound and peaks against the program's chip
script, and the reference's pieces against the program's on the CPU."""

import importlib.util
from pathlib import Path

import pytest
import torch

from benchmark.arith import roofline
from benchmark.reference import kron as ref_kron
from benchmark.reference.kuu import kuu_dense

REPO = Path(__file__).resolve().parents[2]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_frozen_check",
                                                  REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("ops,nbytes", [(1.03e9, 3.0e7), (5.5e9, 1.3e8), (4.0e8, 6.4e7),
                                         (6.7e10, 1e6)])
def test_bound_and_peaks_are_the_chip_scripts(smoke, ops, nbytes):
    ours = roofline.bound(ops, nbytes)
    theirs = smoke.bound(ops, nbytes, smoke.PEAK_FP64_TC_PER_S)
    assert ours["bound_s"] * 1e3 == pytest.approx(theirs["bound_ms"], rel=1e-15)
    assert ours["bound_by"] == theirs["bound_by"]
    assert (roofline.PEAK_BYTES_PER_S, roofline.PEAK_FP64_PER_S, roofline.PEAK_FP64_TC_PER_S) == (
        smoke.PEAK_BYTES_PER_S, smoke.PEAK_FP64_PER_S, smoke.PEAK_FP64_TC_PER_S)


@pytest.mark.parametrize("order", [3, 4])
def test_reference_basis_matches_the_program(order):
    from asvgp_tpu_torch.basis import BSplineBasis

    x = torch.rand(500, dtype=torch.float64, generator=torch.Generator().manual_seed(3)) * 0.96 + 0.02
    vals, c = ref_kron.basis_values({"order": order, "a": 0.0, "b": 1.0, "m": 30}, x)
    pv, pc = BSplineBasis(0.0, 1.0, 30, order).evaluate_basis(x)
    assert torch.equal(c, pc)
    assert torch.allclose(vals, pv, rtol=0, atol=1e-14)


@pytest.mark.parametrize("nu2,order", [(1, 2), (3, 3), (3, 4), (5, 4)])
def test_reference_kuu_matches_the_program(nu2, order):
    from asvgp_tpu_torch import banded
    from asvgp_tpu_torch.basis import BSplineBasis
    from asvgp_tpu_torch.features.spline_features import make_kuu
    from asvgp_tpu_torch.models import Matern

    var, ell = torch.tensor(1.3, dtype=torch.float64), torch.tensor(0.2, dtype=torch.float64)
    ours = kuu_dense(nu2, order, 0.0, 1.0, 25, var, ell)
    band = make_kuu(Matern(var, ell, nu2=nu2), BSplineBasis(0.0, 1.0, 25, order))
    theirs = banded.band_to_dense(banded.symmetrise_lower_band(band), order, order)
    assert torch.allclose(ours, theirs, rtol=1e-13, atol=1e-13 * float(theirs.abs().max()))
