"""One process per rank: start a ``torch.distributed`` group, run a function
on every rank, gather what each returns.

``run_ranks(fn, world)`` spawns ``world`` processes (the ``spawn`` start
method, so each child imports ``fn``'s module afresh: ``fn`` must be a
module-level function).  Rank r joins the group through a ``FileStore`` in
a fresh temporary directory (no network: gloo and NCCL exchange their
addresses over the loopback device) and calls ``fn(rank, world, group,
device, *args)``; the group is passed to it explicitly.  By default
(``backend="nccl"``) rank r runs on ``cuda:r`` (one card per rank: NCCL
refuses two ranks on one device); only ``backend="gloo"`` puts the ranks
on the CPU, with one thread each.  A rank that raises, or a group that has not finished within
``timeout`` seconds, fails the call, and every child still running is
terminated.
"""

from __future__ import annotations

import os
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.multiprocessing as mp


def _rank_main(rank, fn, world, store_path, backend, args, results):
    import torch.distributed as dist

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    if backend == "nccl":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(1)
    dist.init_process_group(backend, store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world)
    try:
        results.put((rank, fn(rank, world, dist.group.WORLD, device, *args)))
    except BaseException:
        results.put((rank, {"error": traceback.format_exc()}))
        raise
    finally:
        dist.destroy_process_group()


def file_function_rank(rank, world, group, device, path, name, *args):
    """A rank function for a function of a script: loads the file at
    ``path`` (its ``__main__`` block does not run) and calls its ``name``
    with (rank, world, group, device, *args).  Lets a script that is not
    an importable module run its own function on each rank."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"_rank_script_{rank}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return getattr(module, name)(rank, world, group, device, *args)


def run_ranks(fn, world: int, args=(), *, backend: str = "nccl", timeout: float = 600.0) -> list:
    """``fn(rank, world, group, device, *args)`` on each of ``world`` ranks;
    returns what each rank returned, in rank order."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
    if backend == "nccl" and torch.cuda.device_count() < world:
        raise RuntimeError(f"{world} NCCL ranks need {world} CUDA devices, "
                           f"found {torch.cuda.device_count()}")
    tmp = tempfile.mkdtemp(prefix="asvgp_ranks_")
    results = mp.get_context("spawn").Queue()
    got: dict = {}
    procs = mp.start_processes(
        _rank_main, args=(fn, world, os.path.join(tmp, "store"), backend, tuple(args), results),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        done = False
        while len(got) < world or not done:
            try:
                rank, out = results.get(timeout=0.2)
                got[rank] = out
            except queue.Empty:
                pass
            # raises with the child's traceback when a rank failed
            done = done or procs.join(timeout=0)
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks did not finish within {timeout} s "
                                   f"({sorted(got)} reported)")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.terminate()
        for p in procs.processes:
            p.join(5)
        shutil.rmtree(tmp, ignore_errors=True)
    return [got[r] for r in range(world)]
