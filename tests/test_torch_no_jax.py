"""The port, its GPU smoke script, its protocol legs and its A/B tools
(tools/*_ab.py, which run on the card) import neither JAX nor the JAX
package.

The test process imports jax (its conftest does), so its ``sys.modules``
cannot show it; the check reads every import statement of the sources
instead, ``asvgp_tpu_torch/parallel/`` and the rank functions its spawned
processes import included.  Those processes start fresh: a dry run on two
gloo ranks reports from each that ``jax`` is not in its ``sys.modules``.
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "asvgp_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py",
    ROOT / "experiments" / "large_regression" / "synthetic_1m_torch.py",
    ROOT / "experiments" / "snelson" / "example_torch.py",
    ROOT / "experiments" / "spatial_2d" / "ocean_ssh_torch.py",
] + sorted((ROOT / "tools").glob("*_ab.py"))
FORBIDDEN = ("jax", "jaxlib", "asvgp_tpu")


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_sources_found():
    assert len(SOURCES) > 15 and (ROOT / "asvgp_tpu_torch" / "banded" / "core.py") in SOURCES
    assert all(path.is_file() for path in SOURCES)
    pkg = ROOT / "asvgp_tpu_torch"
    for rel in ("banded/tan.py", "banded/twist.py", "banded/twisted.py", "models/exact_gp.py",
                "train/lbfgs.py", "train/fused_lbfgs.py", "banded/single.py", "train/adam.py",
                "models/svgp.py", "banded/block.py", "banded/dense_block.py", "stats/kron.py",
                "models/kron.py", "banded/solve.py", "stats/additive.py",
                "models/additive.py", "models/per_dimension.py", "features/fourier.py",
                "models/vff.py", "banded/chunk_rule.py", "stats/kron_nd.py",
                "train/logging.py", "parallel/dp.py", "parallel/dryrun.py",
                "parallel/launch.py"):
        assert pkg / rel in SOURCES, rel


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = [name for name in _imported_modules(path) if _forbidden(name)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_checker_catches_jax_imports():
    assert _forbidden("jax") and _forbidden("jax.numpy") and _forbidden("asvgp_tpu.banded")
    assert not _forbidden("asvgp_tpu_torch") and not _forbidden("asvgp_tpu_torch.banded")
    tree = ast.parse("import jax.numpy as jnp\nfrom asvgp_tpu.models import GPR1D\n")
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert all(_forbidden(n) for n in names)


def test_spawned_ranks_import_no_jax():
    from asvgp_tpu_torch.parallel import dryrun_multirank

    out = dryrun_multirank(2, backend="gloo", timeout=240)
    assert out["ok"] and out["jax_imported"] == [False, False]
