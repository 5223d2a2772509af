"""The tiny cells on the card: the program's CUDA kernels against the plain
reference, the profiler's device trace read, and the control caught."""

import pytest
import torch

from benchmark.core import Bench, run_cell
from benchmark.tests.tiny import TINY_CELLS, make_root


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return Bench(make_root(tmp_path_factory.mktemp("bench_cuda")))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_tiny_cell_on_the_card(bench, cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    result, checks = run_cell(bench, cell, 2 ** 31 + 21, 0.5, True, "cuda")
    assert result["correct"], checks
    assert result["device"]["platform"] == "gpu" and result["device"]["busy_s"] > 0
    assert result["metrics"]
    result, checks = run_cell(bench, cell, 2 ** 31 + 22, 0.2, False, "cuda", control=True)
    assert not result["correct"], checks
