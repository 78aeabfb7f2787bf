"""The process-group layer (port of ``nlbac_tpu/parallel/mesh.py:49-88``).

The JAX package lays a ``(dp, tp)`` mesh over devices and lets GSPMD put
the collectives in. Here every rank is one process with one device, and
the collectives are written out:

- ``make_mesh`` builds a ``ProcessGrid``: rank r of a ``(dp, tp)`` grid
  sits at dp index ``r // tp`` and tp index ``r % tp`` (the Megatron
  order), with a dp group (the ranks of one tp index) and a tp group (the
  ranks of one dp index);
- ``init_distributed`` joins a gang at ``tcp://<coordinator>``: NCCL when
  every rank owns its own GPU, gloo on the CPU or when the caller asks
  for it (ranks that share one card); NCCL on a shared card is refused;
- ``Comm`` holds one group's collectives and the four autograd operators
  the update needs: ``sum_fwd`` (the sum over the group forward, the
  identity backward: Megatron's g, and the data-parallel constraint
  means), ``sum_bwd`` (the identity forward, the sum backward: Megatron's
  f), ``psum`` (the sum both ways: the adaptive solver's error norm over
  a data-parallel batch) and ``gather`` (the columns of every rank side
  by side, written as a sum of zero-filled full buffers so that gloo,
  which takes only ``broadcast`` and ``all_reduce`` on CUDA tensors, runs
  it too).
"""

from __future__ import annotations

import socket
from datetime import timedelta
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from nlbac_tpu_torch import resolve_device

# How long a gang's rendezvous and each collective may wait for a peer.
DEFAULT_TIMEOUT = timedelta(minutes=30)


class Comm:
    """The collectives of one process group: ``size`` ranks, this one at
    ``index`` (its place in ``ranks``, the group's global ranks)."""

    def __init__(self, ranks: Sequence[int], index: int, group=None):
        self.ranks = tuple(ranks)
        self.size = len(self.ranks)
        self.index = index
        self.group = group

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the group, in place; returns it."""
        if self.size > 1:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def broadcast(self, t: torch.Tensor, index: int = 0) -> torch.Tensor:
        """``t`` of the group's rank ``index`` on every rank, in place."""
        if self.size > 1:
            dist.broadcast(t, src=self.ranks[index], group=self.group)
        return t

    def sum_flat(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """Every tensor summed over the group through one collective on a
        flat bucket; returns new tensors of the same shapes."""
        if self.size == 1 or not tensors:
            return list(tensors)
        flat = torch.cat([t.reshape(-1) for t in tensors])
        self.all_reduce(flat)
        out, at = [], 0
        for t in tensors:
            out.append(flat[at:at + t.numel()].view_as(t))
            at += t.numel()
        return out

    def sum_fwd(self, x: torch.Tensor) -> torch.Tensor:
        """The group's sum of ``x``; the gradient passes unchanged."""
        return _SumForward.apply(x, self) if self.size > 1 else x

    def sum_bwd(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` itself; its gradient is summed over the group."""
        return _SumBackward.apply(x, self) if self.size > 1 else x

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The group's sum of ``x``, and of its gradient (a sum whose
        result every rank's loss reads: the adaptive solver's error norm
        over a data-parallel batch)."""
        return _SumBoth.apply(x, self) if self.size > 1 else x

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The last dimension of every rank's ``x``, side by side in rank
        order; the gradient keeps this rank's columns (what follows is
        the same on every rank)."""
        return _Gather.apply(x, self) if self.size > 1 else x


class _SumForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        return comm.all_reduce(x.clone())

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SumBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.comm.all_reduce(grad.clone()), None


class _SumBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return comm.all_reduce(x.clone())

    @staticmethod
    def backward(ctx, grad):
        return ctx.comm.all_reduce(grad.clone()), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        k = x.shape[-1]
        full = x.new_zeros(x.shape[:-1] + (k * comm.size,))
        full[..., comm.index * k:(comm.index + 1) * k] = x
        ctx.cols = (comm.index * k, (comm.index + 1) * k)
        return comm.all_reduce(full)

    @staticmethod
    def backward(ctx, grad):
        lo, hi = ctx.cols
        return grad[..., lo:hi].contiguous(), None


class ProcessGrid:
    """This rank's place in a ``(dp, tp)`` grid of ranks ``ranks`` (in
    rank order): ``dp_index = r // tp`` and ``tp_index = r % tp`` of its
    position r, with the collectives of its dp group (``dp_comm``), its tp
    group (``tp_comm``) and the whole grid (``comm``)."""

    def __init__(self, dp: int, tp: int, ranks: Sequence[int], position: int,
                 comm: Comm, dp_comm: Comm, tp_comm: Comm):
        self.dp, self.tp = dp, tp
        self.ranks = tuple(ranks)
        self.position = position
        self.dp_index, self.tp_index = divmod(position, tp)
        self.comm, self.dp_comm, self.tp_comm = comm, dp_comm, tp_comm

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "tp": self.tp}

    @property
    def is_root(self) -> bool:
        """Whether this rank is the grid's first (it writes the files)."""
        return self.position == 0

    @classmethod
    def local(cls, dp: int = 1, tp: int = 1,
              position: int = 0) -> "ProcessGrid":
        """A grid position with no process group: enough to cut a state
        into rank ``position``'s shards, not to run collectives (unless
        the grid is 1 x 1)."""
        dpi, tpi = divmod(position, tp)
        return cls(dp, tp, range(dp * tp), position,
                   Comm(range(dp * tp), position),
                   Comm(range(dp), dpi), Comm(range(tp), tpi))


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def proc_id() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_rank0() -> bool:
    return proc_id() == 0


def _new_group(ranks):
    """A process group over ``ranks`` (every rank of the world must make
    every group, in the same order); None stands for a one-rank group."""
    if len(ranks) == 1:
        dist.new_group(list(ranks))
        return None
    return dist.new_group(list(ranks))


def make_mesh(shape: Sequence[int], base: int = 0) -> ProcessGrid:
    """The ``(dp, tp)`` grid of world ranks ``base .. base + dp*tp - 1``
    that this rank belongs to. Raises when the world is too small, as
    ``make_mesh`` does for too few devices. Without a process group, a
    1 x 1 grid is the only one there is."""
    dp, tp = (tuple(shape) + (1,))[:2]
    n = int(np.prod(shape))
    world = world_size()
    if base + n > world:
        raise ValueError(f"mesh {tuple(shape)} needs {n} devices, have "
                         f"{world - base}")
    if not dist.is_initialized():
        return ProcessGrid.local(dp, tp)
    return make_grids(1, dp, tp, base)[0]


def make_grids(n_groups: int, dp: int, tp: int,
               base: int = 0) -> List[Optional[ProcessGrid]]:
    """``n_groups`` disjoint ``(dp, tp)`` grids over world ranks from
    ``base`` on, group g holding ranks ``base + g*dp*tp ...``. Every rank
    of the world calls this (the groups are made collectively); entry g
    is this rank's grid when it belongs to group g, else None."""
    size = dp * tp
    if base + n_groups * size > world_size():
        raise ValueError(f"{n_groups} groups of dp={dp} x tp={tp} need "
                         f"{n_groups * size} ranks, have "
                         f"{world_size() - base}")
    me = proc_id()
    grids: List[Optional[ProcessGrid]] = []
    for g in range(n_groups):
        ranks = [base + g * size + i for i in range(size)]
        whole = _new_group(ranks)
        dp_groups = [[ranks[d * tp + t] for d in range(dp)]
                     for t in range(tp)]
        tp_groups = [[ranks[d * tp + t] for t in range(tp)]
                     for d in range(dp)]
        made_dp = [_new_group(r) for r in dp_groups]
        made_tp = [_new_group(r) for r in tp_groups]
        if me not in ranks:
            grids.append(None)
            continue
        pos = ranks.index(me)
        d, t = divmod(pos, tp)
        grids.append(ProcessGrid(
            dp, tp, ranks, pos, Comm(ranks, pos, whole),
            Comm(dp_groups[t], d, made_dp[t]),
            Comm(tp_groups[d], t, made_tp[d])))
    return grids


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _check_cards(backend: str, device, rank: int, world: int) -> None:
    """Refuse NCCL when two ranks of the gang hold one card: each rank
    posts its host and card to the gang's store and reads the others'
    (before any collective, so NCCL never starts on a shared card)."""
    if backend != "nccl":
        return
    store = dist.distributed_c10d._get_default_store()
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    store.set(f"nlbac_card/{rank}", f"{socket.gethostname()}:{index}")
    cards = [store.get(f"nlbac_card/{r}").decode() for r in range(world)]
    if len(set(cards)) != world:
        dist.destroy_process_group()
        raise ValueError(
            f"NCCL needs one GPU per rank, but ranks share cards ({cards}); "
            "pass backend='gloo' for ranks that share a card")


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None, device=None,
                     timeout: timedelta = DEFAULT_TIMEOUT) -> None:
    """Join the gang of ``num_processes`` ranks at ``tcp://<coordinator>``
    (``host:port``) as rank ``process_id`` (a no-op for one process).
    ``device`` defaults to the card (raising without one); the CPU is
    taken only when named. ``backend`` defaults to NCCL for a CUDA
    ``device`` and gloo for the CPU; ranks that share a card must pass
    ``backend='gloo'``."""
    if not num_processes or num_processes <= 1:
        return
    if coordinator is None or process_id is None:
        raise ValueError("a gang of more than one process needs the "
                         "coordinator's host:port and this process's id")
    device = resolve_device("cuda" if device is None else device)
    backend = backend or default_backend(device)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r} (nccl | gloo)")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"backend 'nccl' needs a CUDA device, got {device}")
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=timeout)
    _check_cards(backend, device, process_id, num_processes)


def free_port() -> int:
    """A free TCP port on localhost for a gang's rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def statistics_scalar(x, with_min_and_max: bool = False):
    """Mean and population std (ddof=0), optionally min and max, of
    per-seed scalars (the reference's ``mpi_statistics_scalar`` over the
    seed axis)."""
    x = np.asarray(x, np.float64)
    mean, std = float(x.mean()), float(x.std())
    if with_min_and_max:
        return mean, std, float(x.min()), float(x.max())
    return mean, std


def device_for_rank(cpu: bool, local_rank: int) -> torch.device:
    """A rank's device: the CPU, or card ``local_rank`` modulo the cards
    this host has."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --cpu to run "
                           "the gang on the CPU")
    return torch.device("cuda", local_rank % torch.cuda.device_count())
