"""Data- and tensor-parallel training (port of
``nlbac_tpu/parallel/mesh.py:280-438``; the seed runner is in
``parallel/seeds.py``).

- ``make_dp_episode_runner`` (``--dp``) and ``make_tp_episode_runner``
  (``--tp``, and dp x tp on one grid): ``(place, run_fn)``, where
  ``place`` gives every rank of the grid rank 0's state (and under tp
  this rank's shards of it) and ``run_fn`` has the plain episode
  runner's signature. Every rank steps the same env with the same
  actions; the update splits the batch over dp and the networks over tp.
  Under ``--node_solver dopri5`` the adaptive solves' error norms span the
  gang (``ode.solvers.rows_reduce``, ``ode.adjoint``), so every rank takes
  the steps one device takes over the whole batch.
- ``make_dp_update``: ``(place, dp_update)``, the data-parallel
  ``update_from_batch``.
"""

from __future__ import annotations

from typing import Optional

import torch

from nlbac_tpu_torch import resolve_device
from nlbac_tpu_torch.agent import TrainState, make_agent
from nlbac_tpu_torch.config import NLBACConfig
from nlbac_tpu_torch.nn import DEFAULT_SQUASH
from nlbac_tpu_torch.parallel.mesh import ProcessGrid, make_mesh
from nlbac_tpu_torch.parallel.tp import shard_state_tp
from nlbac_tpu_torch.replay import Replay
from nlbac_tpu_torch.train.driver import make_episode_runner
from nlbac_tpu_torch.tree import tree_leaves


def _validate_batches_divisible(cfg: NLBACConfig, dp: int) -> None:
    """Batch axes must split evenly over dp (uneven shards would change
    the batch-mean normalization)."""
    for name, val in (("sac.batch_size", cfg.sac.batch_size),
                      ("node.max_batch", cfg.node.max_batch)):
        if val % dp != 0:
            raise ValueError(
                f"--dp {dp} requires cfg.{name} ({val}) to be "
                f"divisible by the dp width (uneven shards would "
                f"change the batch-mean normalization)")


def _validate_tp(cfg: NLBACConfig, tp: int) -> None:
    """A tp width that divides no hidden dim would leave every layer whole
    (N ranks of redundant work)."""
    if cfg.sac.hidden_dim % tp != 0:
        raise ValueError(
            f"--tp {tp} requires cfg.sac.hidden_dim "
            f"({cfg.sac.hidden_dim}) to be divisible by the tp width — "
            f"otherwise no layer shards and the run is fully-replicated "
            f"redundant work")


# ---------------------------------------------------------------------------
# Giving every rank the same state
# ---------------------------------------------------------------------------

def _broadcast_int(value: int, comm, device) -> int:
    t = torch.tensor([value], dtype=torch.int64, device=device)
    return int(comm.broadcast(t)[0])


def _broadcast_state(ts: TrainState, comm, device) -> TrainState:
    """``ts`` as the grid's rank 0 holds it, in place (the same structure
    on every rank: made from one config, or restored from one file)."""
    with torch.no_grad():
        for name in ("policy", "backup_policy", "critic", "critic_target",
                     "lyap", "lyap_target", "barrier", "barrier_target",
                     "node", "log_alpha", "backup_log_alpha"):
            for t in tree_leaves(getattr(ts, name)):
                comm.broadcast(t.detach())
        for t in ts.lag:
            comm.broadcast(t)
        for opt in ts.opt.values():
            for state in opt.state.values():
                for k in ("exp_avg", "exp_avg_sq"):
                    comm.broadcast(state[k])
                step = state["step"]
                moved = comm.broadcast(step.to(device, torch.float64))
                step.copy_(moved.to(step.device, step.dtype))
    ts.updates = _broadcast_int(ts.updates, comm, device)
    return ts


def _broadcast_replay(rep: Replay, comm, device) -> Replay:
    rep.position = _broadcast_int(rep.position, comm, device)
    rep.size = _broadcast_int(rep.size, comm, device)
    rep.total = _broadcast_int(rep.total, comm, device)
    if rep.size:
        comm.broadcast(rep.data[:rep.size])
    return rep


def _broadcast_generator(gen: torch.Generator, comm, device):
    state = gen.get_state()
    gen.set_state(comm.broadcast(state.to(device)).cpu())
    return gen


def broadcast(tree, comm, device):
    """Rank 0's copy of every item of a tuple of training objects (a
    ``TrainState``, replays, a generator, host ints), in place where the
    item allows; returns the tuple."""
    out = []
    for item in tree:
        if isinstance(item, TrainState):
            out.append(_broadcast_state(item, comm, device))
        elif isinstance(item, Replay):
            out.append(_broadcast_replay(item, comm, device))
        elif isinstance(item, torch.Generator):
            out.append(_broadcast_generator(item, comm, device))
        elif isinstance(item, int):
            out.append(_broadcast_int(item, comm, device))
        else:
            raise TypeError(f"cannot broadcast a {type(item).__name__}")
    return tuple(out)


def _place_fn(grid: ProcessGrid, device, shard: bool):
    def place(tree):
        """Every rank of the grid takes rank 0's copy of ``tree`` (a plain
        tuple whose first item is the TrainState, then replays, the
        generator, host ints); under tp the TrainState comes back as this
        rank's shards."""
        if type(tree) is not tuple or not tree:
            raise TypeError(
                "place() takes a plain tuple (train_state, ...); got "
                f"{type(tree).__name__}")
        tree = broadcast(tree, grid.comm, device)
        if shard and isinstance(tree[0], TrainState):
            tree = (shard_state_tp(tree[0], grid),) + tree[1:]
        return tree

    return place


# ---------------------------------------------------------------------------
# Data- and tensor-parallel training
# ---------------------------------------------------------------------------

def make_dp_episode_runner(cfg: NLBACConfig, n_devices: int,
                           grid: Optional[ProcessGrid] = None,
                           device="cuda", squash: str = DEFAULT_SQUASH):
    """The episode runner data-parallel over the ``n_devices`` ranks of
    ``grid`` (by default the world's first ``n_devices``): each update
    runs on this rank's rows of the batch and the group sums the
    gradients, while the env, the replays and the supervisor are the same
    on every rank. ``cfg.sac.batch_size`` and ``cfg.node.max_batch`` must
    divide by ``n_devices``. Returns ``(place, run_fn)``."""
    _validate_batches_divisible(cfg, n_devices)
    grid = grid if grid is not None else make_mesh((n_devices, 1))
    if grid.dp != n_devices or grid.tp != 1:
        raise ValueError(f"grid {grid.shape} is not a dp={n_devices} grid")
    device = resolve_device(device)
    agent = make_agent(cfg, device, dp_group=grid.dp_comm, squash=squash)
    return (_place_fn(grid, device, shard=False),
            make_episode_runner(cfg, device, agent=agent, squash=squash))


def make_tp_episode_runner(cfg: NLBACConfig, tp: int, dp: int = 1,
                           grid: Optional[ProcessGrid] = None,
                           device="cuda", squash: str = DEFAULT_SQUASH):
    """The episode runner tensor-parallel over ``tp`` ranks (and, with
    ``dp`` > 1, data-parallel over the grid's other axis): every network,
    its target and its Adam moments cut Megatron-style over the tp group
    (``parallel.tp``), batches over the dp group. The NODE's field runs
    through the tp-aware plain layers, so K1 is not launched on this path.
    Returns ``(place, run_fn)`` as ``make_dp_episode_runner`` does."""
    if dp > 1:
        _validate_batches_divisible(cfg, dp)
    _validate_tp(cfg, tp)
    grid = grid if grid is not None else make_mesh((dp, tp))
    if grid.dp != dp or grid.tp != tp:
        raise ValueError(f"grid {grid.shape} is not a dp={dp} x tp={tp} "
                         "grid")
    device = resolve_device(device)
    agent = make_agent(cfg, device,
                       dp_group=grid.dp_comm if dp > 1 else None,
                       squash=squash)
    return (_place_fn(grid, device, shard=True),
            make_episode_runner(cfg, device, agent=agent, squash=squash))


def make_dp_update(cfg: NLBACConfig, grid: ProcessGrid, device="cuda",
                   squash: str = DEFAULT_SQUASH):
    """``(place, dp_update)``: ``place`` as the runners', ``dp_update(ts,
    batch, node_batch, gen, i_episode, noise=None)`` the update over whole
    batches with this rank's rows taken (``Agent.update_from_batch``)."""
    _validate_batches_divisible(cfg, grid.dp)
    device = resolve_device(device)
    agent = make_agent(cfg, device, dp_group=grid.dp_comm, squash=squash)
    return _place_fn(grid, device, shard=False), agent.update_from_batch


def make_parallel_runner(cfg: NLBACConfig, grid: ProcessGrid, device,
                         squash: str = DEFAULT_SQUASH):
    """The runner of ``grid``'s layout: tp (with or without dp), dp, or
    the plain runner for a 1 x 1 grid; ``squash`` the policy's tanh."""
    if grid.tp > 1:
        return make_tp_episode_runner(cfg, grid.tp, grid.dp, grid, device,
                                      squash)
    if grid.dp > 1:
        return make_dp_episode_runner(cfg, grid.dp, grid, device, squash)
    return (lambda tree: tree), make_episode_runner(cfg, device,
                                                    squash=squash)
