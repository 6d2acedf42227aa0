"""Process groups for the sharded pipeline: one process per card, the
collectives through `torch.distributed` (NCCL on CUDA, gloo on the CPU).
The port of iridium_tpu/parallel/distributed.py.

The JAX package drives every device of a mesh from one process; here each
rank is a process with one device, and the mesh axis of n devices is the
group's n ranks. A rank joins the group in one of three ways:

  - under torchrun (or any launcher that sets RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR and MASTER_PORT): `initialize()` reads them;
  - in processes this module starts: `spawn(fn, n, device, *args)` runs
    fn(*args) in n new local processes, one card each, joined over a file
    store;
  - alone: `initialize()` with no such environment makes a group of one
    rank on an in-process store, so that one card runs the same
    collectives a larger group does.

    from iridium_tpu_torch.parallel import distributed
    distributed.initialize()              # torchrun's environment, or alone
    mesh = distributed.make_mesh()
    sp = ShardedPipeline(cfg, mesh=mesh)
    for f in sp.run_file(path):           # frames on rank 0 only
        print(printer.format(f))

Every rank must be fed the same blocks (each reads the same capture file).
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from .. import device as device_mod


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The group as the sharded pipeline sees it: `n` ranks, this process's
    `rank` and its `device` (cuda:LOCAL_RANK over NCCL, the CPU over
    gloo)."""
    n: int
    rank: int
    device: torch.device
    group: object


def in_group() -> bool:
    """Whether this process is a rank: a group is initialized, or a
    launcher's environment names one to join."""
    return dist.is_initialized() or "WORLD_SIZE" in os.environ


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None,
               device: str | torch.device | None = None) -> bool:
    """Join the process group, once (a second call does nothing). Explicit
    arguments override torchrun's environment (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT); with neither, the group is this
    process alone. `device` picks the backend as `device.resolve` picks the
    device: None is CUDA (NCCL, rank on cuda:LOCAL_RANK) and raises
    without a card; "cpu" is gloo. Returns whether this call made the
    group."""
    if dist.is_initialized():
        return False
    env = os.environ
    dev = device_mod.resolve(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None \
        else world_size
    rank = int(env.get("RANK", 0)) if rank is None else rank
    kw = {}
    if backend == "nccl":
        local = int(env.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local)
        kw["device_id"] = torch.device("cuda", local)
    if init_method is None and "MASTER_ADDR" in env:
        init_method = "env://"
    if init_method is None:
        if world_size != 1:
            raise ValueError(f"a group of {world_size} ranks needs an "
                             "init_method or torchrun's environment")
        kw["store"] = dist.HashStore()
    else:
        kw["init_method"] = init_method
    dist.init_process_group(backend, world_size=world_size, rank=rank, **kw)
    return True


def shutdown() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def make_mesh() -> Mesh:
    """The initialized group as a Mesh (iridium_tpu/parallel/
    distributed.py:68-74: one axis over every rank, in rank order)."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize() first")
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    return Mesh(dist.get_world_size(), dist.get_rank(), dev,
                dist.group.WORLD)


def is_host0() -> bool:
    """Whether this process emits output: rank 0, or not in a group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _rank_main(fn, args, rank: int, n: int, device, init_method: str,
               results) -> None:
    os.environ["LOCAL_RANK"] = str(rank)
    try:
        initialize(init_method, n, rank, device=device)
        results.put((rank, None, fn(*args)))
    except BaseException:
        results.put((rank, traceback.format_exc(), None))
        raise
    finally:
        shutdown()


def spawn(fn, n: int, device: str | torch.device | None, *args,
          timeout: float | None = None) -> list:
    """Run fn(*args) in n new local processes (the spawn start method),
    rank r on cuda:r (`device` None or CUDA) or on the CPU ("cpu"), joined
    in one group over a file store (a TCP store's port can be taken by
    another run). `fn` must be importable by name from a module that
    imports no JAX. Returns the ranks' return values in rank order. If a
    rank raises or dies, or `timeout` seconds pass, every rank is killed
    and RuntimeError says why; every process has ended when this
    returns."""
    ctx = multiprocessing.get_context("spawn")
    dev = None if device is None else str(device)
    deadline = None if timeout is None else time.monotonic() + timeout
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "store")
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, args, r, n, dev, init, results))
                 for r in range(n)]
        got, err = {}, None
        try:
            for p in procs:
                p.start()
            while len(got) < n and err is None:
                try:
                    r, tb, val = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [(r, p.exitcode) for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and r not in got]
                    if dead:
                        err = f"rank {dead[0][0]} exited with code " \
                              f"{dead[0][1]}"
                    elif deadline is not None and \
                            time.monotonic() > deadline:
                        err = f"the ranks did not finish in {timeout} s"
                    continue
                if tb is not None:
                    err = f"rank {r} failed:\n{tb}"
                else:
                    got[r] = val
        finally:
            for p in procs:
                if p.pid is None:       # never started
                    continue
                if len(got) < n:
                    p.kill()
                p.join()
            results.close()
    if err is not None:
        raise RuntimeError(err)
    return [got[r] for r in range(n)]
