"""Build and load the hand-written CUDA kernels of the port.

At first use, ``load()`` compiles ``asvgp_tpu_torch/csrc/*.cu`` with
``nvcc`` for Hopper (``sm_90a``), one ``nvcc`` per source, all started
together, and links the objects into one shared library with a plain C
interface, under ``build/asvgp_tpu_torch/`` beside the package, named by a
hash of the sources, the headers they include and the flags, so that an
edited source or header is rebuilt.  The
library is loaded with ctypes; every pointer and the stream are passed as
``ctypes.c_void_p``.  Nothing here runs at import time: a machine without
``nvcc`` or a GPU can import the port and run its CPU paths.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SOURCES = tuple(_PKG / "csrc" / name for name in
                ("banded_core.cu", "banded_tan.cu", "banded_adjoint.cu",
                 "banded_solve.cu", "block_chol_inv.cu"))
# included by the sources: part of the library's hash
HEADERS = tuple(_PKG / "csrc" / name
                for name in ("chunk_scan.cuh", "schur_walk.cuh", "forward_sweeps.cuh"))
BUILD_DIR = _PKG.parent / "build" / "asvgp_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# (name, argument types) of every C entry point; each returns an int error
_VP = ctypes.c_void_p
_I = ctypes.c_int
ENTRY_POINTS = {
    "asvgp_chol_pair_solve": (_I, _I) + (_VP,) * 9,
    "asvgp_tak_pair_solve": (_I, _I) + (_VP,) * 9,
    "asvgp_chol_pair_solve_tan": (_I, _I) + (_VP,) * 12,
    "asvgp_tak_pair_solve_tan": (_I, _I) + (_VP,) * 12,
    "asvgp_chol_quad_solve_tan": (_I, _I, _I) + (_VP,) * 11,
    "asvgp_tak_quad_solve_tan": (_I, _I, _I) + (_VP,) * 13,
    "asvgp_chol_fwd": (_I, _I, _I) + (_VP,) * 4,
    "asvgp_chol_bwd": (_I, _I, _I) + (_VP,) * 5,
    "asvgp_tak_fwd": (_I, _I, _I) + (_VP,) * 4,
    "asvgp_tak_bwd": (_I, _I, _I) + (_VP,) * 7,
    "asvgp_chol_fwd_f32": (_I, _I, _I) + (_VP,) * 4,
    "asvgp_chol_bwd_f32": (_I, _I, _I) + (_VP,) * 5,
    "asvgp_tak_fwd_f32": (_I, _I, _I) + (_VP,) * 4,
    "asvgp_tak_bwd_f32": (_I, _I, _I) + (_VP,) * 7,
    "asvgp_solve_lower": (_I, _I, _I) + (_VP,) * 5,
    "asvgp_solve_upper_t": (_I, _I, _I) + (_VP,) * 5,
    "asvgp_solve_lower_f32": (_I, _I, _I) + (_VP,) * 5,
    "asvgp_solve_upper_t_f32": (_I, _I, _I) + (_VP,) * 5,
    "asvgp_chol_inv_dense": (_I, _I) + (_VP,) * 5,
    # not launches either: the chunk length a linear sweep's rule chooses
    # (the adjoints and K11 / K19; K2; K4; K6), read back for reporting
    "asvgp_linear_chunk_cols": (_I, _I, _I, _VP, _I, _VP, _VP),
    "asvgp_core_tak_chunk_cols": (_I, _I) + (_VP,) * 4,
    "asvgp_tan_tak_chunk_cols": (_I, _I) + (_VP,) * 4,
    "asvgp_twist_tak_chunk_cols": (_I, _I, _I) + (_VP,) * 3,
    # not launches: the doubles of global workspace per block of K16, the
    # elements of workspace of K13 / K14 / K21 / K22, of the linear sweeps
    # K11 / K19 and the adjoints K7 / K8 / K10 / K12 / K18 / K20 / K23, and
    # of the Cholesky sweep K9 / K15 / K17, of the twisted sweeps K5 / K6, of
    # the serving sweeps K1 / K2 and of the single-ended tangent sweeps K3 / K4
    "asvgp_chol_inv_dense_workspace": (_I,),
    "asvgp_solve_workspace": (_I, _I, _I),
    "asvgp_carry_workspace": (_I, _I, _I),
    "asvgp_schur_workspace": (_I, _I, _I),
    "asvgp_twist_workspace": (_I, _I),
    "asvgp_core_workspace": (_I, _I),
    "asvgp_tan_workspace": (_I, _I),
}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under $CUDA_HOME or
    /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME/bin and /usr/local/cuda/bin); "
        "the port's CUDA kernels are built from source at first use"
    )


def library_path() -> Path:
    h = hashlib.sha256()
    for src in SOURCES + HEADERS:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libbanded_core-{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile the kernels unless the library for these sources exists.

    Returns {"path", "seconds", "log"}: ``seconds`` is 0.0 and ``log`` empty
    when the library was already built; ``log`` holds nvcc's output
    (``-Xptxas -v``: registers, spills and shared memory of each kernel)."""
    out = library_path()
    if out.is_file():
        return {"path": str(out), "seconds": 0.0, "log": ""}
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [out.with_name(f"{tag}.{src.stem}.o") for src in SOURCES]
    tmp = out.with_name(f"{tag}.so.tmp")
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = []
    try:
        for src, obj in zip(SOURCES, objs):
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs = []
        for cmd, proc in procs:
            log, _ = proc.communicate()
            logs.append(log)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n{logs[-1]}")
        os.replace(tmp, out)
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for path in (*objs, tmp):
            path.unlink(missing_ok=True)
    return {"path": str(out), "seconds": time.perf_counter() - t0, "log": "".join(logs)}


@functools.cache
def load() -> ctypes.CDLL:
    """The kernels' library, built at first use, with every entry point's
    argument and result types declared."""
    lib = ctypes.CDLL(build()["path"])
    for name, argtypes in ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.asvgp_error_string.argtypes = [ctypes.c_int]
    lib.asvgp_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        msg = lib.asvgp_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
