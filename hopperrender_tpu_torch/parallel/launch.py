"""Start the ranks of a dp x sp mesh as processes on one host.

`run_ranks(fn, dp, sp, device=..., workdir=...)` spawns dp * sp processes
(the `spawn` start method), joins them into one torch.distributed group
through a FileStore under `workdir` (no TCP port, so several runs can share a
host), builds each rank's `mesh.Mesh`, calls `fn(mesh, *args)` there, and
returns the ranks' results in rank order.

Backend and device:
  * device "cpu": gloo; each rank runs on one thread;
  * device "cuda" with a card for every rank: NCCL, rank r on card r;
  * device "cuda" with fewer cards: gloo, every rank on card 0 (NCCL refuses
    two ranks on one card).

`fn` must be importable by its module path (the ranks unpickle it): a
function of this package. A rank that raises makes `run_ranks` raise with
that rank's traceback; a run that outlasts `timeout` raises too. Either way
every rank still running is killed: a rank blocked in a collective on a dead
peer never leaves the caller waiting.
"""

from __future__ import annotations

import itertools
import multiprocessing
import os
import queue as queue_mod
import time
import traceback

import torch
import torch.distributed as dist

from hopperrender_tpu_torch import _build
from hopperrender_tpu_torch.parallel.mesh import Mesh

_run_ids = itertools.count()


def _backend(device: torch.device, world: int) -> str:
    if device.type == "cpu":
        return "gloo"
    if device.type != "cuda":
        raise ValueError(f"run_ranks: unsupported device {device}")
    if not torch.cuda.is_available():
        raise RuntimeError("run_ranks: device 'cuda' requested but no CUDA device is "
                           "available (pass device='cpu' to run the plain versions)")
    return "nccl" if torch.cuda.device_count() >= world else "gloo"


def _rank_main(rank, dp, sp, backend, device, store_path, fn, args, results):
    """One rank: join the group, build the mesh, run fn, report."""
    world = dp * sp
    try:
        dev = torch.device(device)
        if dev.type == "cpu":
            torch.set_num_threads(1)
        else:
            dev = torch.device("cuda", rank if backend == "nccl" else 0)
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, store=dist.FileStore(store_path, world), rank=rank,
                                world_size=world)
        try:
            result = fn(Mesh(dp, sp, dev), *args)
        finally:
            dist.destroy_process_group()
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, result))


def run_ranks(fn, dp: int, sp: int, *, device: str | torch.device, workdir: str,
              args: tuple = (), timeout: float = 600.0) -> list:
    """Run fn(mesh, *args) on every rank of a dp x sp mesh; the results in
    rank order. Raises RuntimeError with the traceback of the first rank that
    failed, and TimeoutError when the ranks are not done within timeout
    seconds."""
    world = dp * sp
    if world < 1:
        raise ValueError(f"mesh {dp}x{sp}")
    device = torch.device(device)
    backend = _backend(device, world)
    if device.type == "cuda":
        _build.load()   # build the kernels once, before the ranks load them
    store_path = os.path.join(workdir, f"rank_store.{os.getpid()}.{next(_run_ids)}")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, name=f"rank{rank}", daemon=True,
                         args=(rank, dp, sp, backend, str(device), store_path, fn, args,
                               results))
             for rank in range(world)]
    out: dict[int, object] = {}
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while len(out) < world:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(f"run_ranks: {world - len(out)} of {world} ranks not done "
                                   f"after {timeout} s")
            try:
                rank, ok, payload = results.get(timeout=min(remaining, 1.0))
            except queue_mod.Empty:
                # A rank that died without a report (killed, crashed).
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if dead:
                    raise RuntimeError(f"run_ranks: rank {dead[0][0]} exited with code "
                                       f"{dead[0][1]} and no result") from None
                continue
            if not ok:
                raise RuntimeError(f"run_ranks: rank {rank} of {dp}x{sp} failed:\n{payload}")
            out[rank] = payload
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        results.close()
        if os.path.exists(store_path):
            os.unlink(store_path)
    return [out[r] for r in range(world)]
