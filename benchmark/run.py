"""Run one cell of the benchmark of asvgp_tpu_torch on the card.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``
(and ``breakdown`` with ``--trace 1``), then ``checks``, each number the
check compared with its limit.  Without a CUDA device it prints no result
and exits with 2.  benchmark/README.md describes the files it reads; the
run writes only under ``build/`` in the checkout (the port's kernels, the
interpreter's bytecode).
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    root = Path.cwd()
    # Bytecode of every module the run imports, torch's included, cached at
    # a fixed path inside the checkout: where the environment forbids
    # writing it beside the sources (PYTHONDONTWRITEBYTECODE), each start
    # would compile torch from source again, seconds of set-up that vary.
    sys.pycache_prefix = str(root / "build" / "pycache")
    sys.dont_write_bytecode = False
    # the checkout's root, not this file's directory, heads the import path
    sys.path[0] = str(root)
    from benchmark.core import main

    sys.exit(main(root=root, t_start=T_START))
