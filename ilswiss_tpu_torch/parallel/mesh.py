"""Process groups and axis names (counterpart: ilswiss_tpu/parallel/mesh.py;
`ENV_AXIS`, `DATA_AXIS`, `MODEL_AXIS`; `make_mesh` becomes `init_group`).

The JAX package drives every device from one process, over a named
`Mesh` whose ``env`` axis shards the envs and replay and whose `pmean`
is the learner's all-reduce.  The port runs one process per rank over
`torch.distributed`: the ranks of a process group play the ``env`` axis,
each rank holds its env slice and its replay ring on its own device, and
`parallel/distributed.py::all_reduce_mean` is the `pmean`.

`init_group` joins this process to a group and names its device:
`cuda:<rank>` unless the caller passes `device` ("cpu" for the CPU, or
one card for several ranks).  The backend is `nccl` for a CUDA
device and `gloo` for the CPU unless the caller names one; `gloo` over
CUDA tensors is taken only when named (several ranks on one card, which
nccl cannot serve).  `nccl` with two ranks on one device raises, and no
path switches backend or device because one failed.

`spawn_ranks` runs a function on `world_size` fresh processes
(`torch.multiprocessing`, spawn) and joins them with a deadline: a rank
that fails or outlives it fails the call, and every rank still running
is ended.
"""

from __future__ import annotations

import multiprocessing.connection
import socket
import time
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Callable

import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from ilswiss_tpu_torch.utils.device import resolve_device

ENV_AXIS = "env"
DATA_AXIS = "data"
MODEL_AXIS = "model"

BACKENDS = ("nccl", "gloo")


@dataclass(frozen=True)
class RankGroup:
    """This process's place in a process group: its rank and the world's
    size within the group, the backend, its device, and the group handle
    that the collectives take."""
    rank: int
    world_size: int
    backend: str
    device: torch.device
    process_group: Any

    def barrier(self) -> None:
        dist.barrier(group=self.process_group)


def _check_devices(store, rank: int, world_size: int,
                   device: torch.device, timeout: timedelta) -> None:
    """Every rank publishes its host and card through the store and reads
    the others': two ranks on one card raise ValueError on every rank."""
    me = f"{socket.gethostname()}:{device.index}"
    store.set(f"ilswiss_nccl_device/{rank}", me)
    keys = [f"ilswiss_nccl_device/{r}" for r in range(world_size)]
    store.wait(keys, timeout)
    where = [store.get(k).decode() for k in keys]
    shared = sorted({w for w in where if where.count(w) > 1})
    if shared:
        raise ValueError(
            f"nccl needs one card per rank; ranks share {shared} "
            f"(ranks' cards: {where}); pass backend='gloo' to run several "
            f"ranks on one card")


def init_group(rank: int, world_size: int, *, backend: str | None = None,
               init_method: str | None = None, store=None,
               device=None, timeout: float = 300.0) -> RankGroup:
    """Join the default process group as `rank` of `world_size`, through
    `store` (a `torch.distributed.Store`) or `init_method` (e.g.
    "tcp://localhost:29500", "file:///path"); exactly one of them.

    The device is `device` if given, else `cuda:<rank>` (one host; on
    several, pass each rank's card).  The backend defaults to nccl on a
    CUDA device and gloo on the CPU; nccl on the CPU, or with two ranks on
    one card, raises ValueError.  `timeout` (seconds) bounds the rendezvous and each
    collective."""
    if (store is None) == (init_method is None):
        raise ValueError("pass exactly one of store and init_method")
    if device is None:
        device = f"cuda:{rank}"
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"nccl needs a CUDA device, not {device}")
    span = timedelta(seconds=timeout)
    if store is None:
        store, _, _ = next(dist.rendezvous(init_method, rank, world_size,
                                           timeout=span))
    kw = {}
    if backend == "nccl":
        _check_devices(store, rank, world_size, device, span)
        torch.cuda.set_device(device)
        kw["device_id"] = device
    elif device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size, timeout=span, **kw)
    return RankGroup(rank=rank, world_size=world_size, backend=backend,
                     device=device, process_group=dist.group.WORLD)


def _run_rank(fn: Callable, rank: int, world_size: int, args: tuple
              ) -> None:
    fn(rank, world_size, *args)


def spawn_ranks(fn: Callable, world_size: int, args: tuple = (),
                timeout: float = 120.0) -> None:
    """Run `fn(rank, world_size, *args)` on `world_size` spawned processes
    and wait for all of them at most `timeout` seconds.  `fn` must be
    importable by name (a module-level function).  Raises RuntimeError
    naming the ranks that exited non-zero (their tracebacks are on stderr)
    and TimeoutError naming those still running at the deadline; either
    way every rank still running is ended first."""
    ctx = tmp.get_context("spawn")
    procs = [ctx.Process(target=_run_rank, args=(fn, r, world_size, args),
                         daemon=True)
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    while True:
        running = [p for p in procs if p.exitcode is None]
        failed = [(r, p.exitcode) for r, p in enumerate(procs)
                  if p.exitcode not in (None, 0)]
        left = deadline - time.monotonic()
        if not running or failed or left <= 0:
            break
        multiprocessing.connection.wait([p.sentinel for p in running],
                                        timeout=left)
    hung = [r for r, p in enumerate(procs) if p.exitcode is None]
    for p in procs:
        if p.exitcode is None:
            p.terminate()
    for p in procs:
        p.join(5.0)
        if p.exitcode is None:
            p.kill()
            p.join()
    if failed:
        raise RuntimeError(
            f"ranks {[r for r, _ in failed]} of {world_size} failed (exit "
            f"codes {[c for _, c in failed]}; tracebacks on stderr)")
    if hung:
        raise TimeoutError(f"ranks {hung} of {world_size} still ran after "
                           f"{timeout:.0f} s")
