"""What bounds K16 (csrc/block_chol_inv.cu) on the card: its time at
B = 100 beside two variants built from the same source with parts of the
work switched off.

  full         the kernel as the port builds it;
  pivot_chain  the update warps skip their work: what is left is the load,
               the pivot warp's chain (the running pivots, one correctly
               rounded square root and divide per column) and the B
               barriers;
  barriers     as pivot_chain, with the reciprocal root replaced by a
               multiply: the load, the barriers and the pivot warp's
               running pivots.

The variants' outputs are wrong and are not read.  Each is compiled with
nvcc for sm_90a into build/k16_floor_probe/ and timed over 50 launches
back to back (CUDA events), one block and a batch of 100.  Needs an
NVIDIA GPU and nvcc; run from the repository root:

    python tools/k16_floor_probe.py

Prints one JSON object.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from asvgp_tpu_torch.banded import _build  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "asvgp_tpu_torch" / "csrc" / "block_chol_inv.cu"
OUT = ROOT / "build" / "k16_floor_probe"
B, REPS = 100, 50
SKIP_UPDATES = ("    } else if (c + 1 + warp < B) {", "    } else if (false) {")
CHEAP_RECIP = ("  return __ddiv_rn(1.0, __dsqrt_rn(d));", "  return d * 0.5;")
VARIANTS = {"full": (), "pivot_chain": (SKIP_UPDATES,), "barriers": (SKIP_UPDATES, CHEAP_RECIP)}


def build(name: str, edits) -> Path:
    src = SOURCE.read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: the line to switch off is not in {SOURCE.name}: {old!r}")
        src = src.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    cu, lib = OUT / f"{name}.cu", OUT / f"{name}.so"
    cu.write_text(src)
    subprocess.run([_build.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(lib), str(cu)], check=True)
    return lib


def spd_blocks(n: int) -> torch.Tensor:
    rng = np.random.RandomState(0)
    out = []
    for _ in range(n):
        q, _ = np.linalg.qr(rng.randn(B, B))
        out.append(q @ np.diag(np.logspace(0.0, -4.0, B)) @ q.T)
    return torch.as_tensor(np.stack(out))


def ms_per_launch(fn, m: torch.Tensor) -> float:
    nb = m.shape[0]
    l, t = torch.empty_like(m), torch.empty_like(m)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        rc = fn(B, nb, m.data_ptr(), l.data_ptr(), t.data_ptr(), None, stream)
        if rc != 0:
            raise RuntimeError(f"CUDA error {rc}")

    for _ in range(3):
        call()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS


def main():
    if not torch.cuda.is_available():
        raise SystemExit("k16_floor_probe: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    libs = {name: build(name, edits) for name, edits in VARIANTS.items()}
    blocks = spd_blocks(100).cuda()
    out = {"card": smi, "B": B, "reps": REPS, "ms": {}}
    for name, path in libs.items():
        fn = ctypes.CDLL(str(path)).asvgp_chol_inv_dense
        fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5
        fn.restype = ctypes.c_int
        out["ms"][name] = {"one_block": ms_per_launch(fn, blocks[:1].contiguous()),
                           "batch_100": ms_per_launch(fn, blocks)}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
