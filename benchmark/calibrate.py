"""Readings that set a cell's limits: the numbers its check compares, for
many seeds in one process, on one side:

  program   the program as the cell runs it (the lower reading)
  control   the plain reference in float32 in the program's place
  half, alter   the program with that fault planted (faults.py)

    python benchmark/calibrate.py --workload <cell> --side <side> \\
        --seeds 11,12,13 [--seconds 1]

from the root of a checkout, on the card.  One JSON line per seed; a side
that raises reads as the error it raised.  The benchmark's own runs never
run this.
"""

import json
import sys
import time
import traceback
from contextlib import nullcontext
from pathlib import Path

if __name__ == "__main__":
    sys.path[0] = str(Path.cwd())

import torch  # noqa: E402

from benchmark.core import Bench, run_cell  # noqa: E402


def readings(bench, cell: str, side: str, seeds, seconds: float, device) -> list:
    from benchmark import faults

    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        planted = faults.plant(side) if side in faults.FAULTS else nullcontext()
        try:
            with planted:
                result, checks = run_cell(bench, cell, seed, seconds, False, device,
                                          control=side == "control")
            row = {"seed": seed, "side": side, "correct": result["correct"],
                   "checks": {k: v["value"] for k, v in checks.items()},
                   "metrics": {k: v["value"] for k, v in result["metrics"].items()}}
        except Exception as exc:  # a side that crashes has failed; its error is the reading
            row = {"seed": seed, "side": side, "error": f"{type(exc).__name__}: {exc}",
                   "trace": traceback.format_exc()[-1500:]}
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        out.append(row)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return out


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--side", default="program")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    readings(Bench(Path.cwd()), args.workload, args.side, seeds, args.seconds, "cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
