"""Start a gang of ranks on this host: ``torch.multiprocessing`` with the
``spawn`` method, a free localhost port for the rendezvous, and a time
limit of the gang's own (a hung rendezvous or collective fails this gang,
not whatever waits on it)."""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

import torch.distributed as dist
import torch.multiprocessing as mp

from nlbac_tpu_torch.parallel.mesh import free_port


def _entry(rank: int, fn: Callable, coordinator: str, world: int,
           args: Sequence) -> None:
    try:
        fn(rank, world, coordinator, *args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_gang(fn: Callable, world: int, args: Sequence = (),
             timeout: Optional[float] = None) -> None:
    """Run ``fn(rank, world, "localhost:<port>", *args)`` in ``world``
    spawned processes (``fn`` must be importable by name: a module-level
    function) and wait for all of them. A rank that raises fails the gang
    with its traceback; past ``timeout`` seconds every rank is killed and
    ``TimeoutError`` raised."""
    coordinator = f"localhost:{free_port()}"
    ctx = mp.start_processes(_entry, args=(fn, coordinator, world,
                                           tuple(args)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"gang of {world} ranks still running "
                                   f"after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
