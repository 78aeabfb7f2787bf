"""Rank functions of the port's gang tests (``test_torch_port_parallel.py``),
spawned by ``nlbac_tpu_torch.parallel.run_gang``. A spawned rank imports
its function by module name, so this module imports torch and the port
only (the test module imports JAX). Each rank joins a gloo gang on the
CPU and writes what it computed to ``<out>/rank<r>.pkl``."""

import os
import pickle

import torch

from nlbac_tpu_torch import parallel
from nlbac_tpu_torch.agent import create_train_state, make_agent
from nlbac_tpu_torch.interop import TARGETS, TRAINED
from nlbac_tpu_torch.parallel import state_arrays
from nlbac_tpu_torch.train.checkpoint import save_model_weights
from nlbac_tpu_torch.train.driver import (
    create_replays,
    episode_to_host,
    make_episode_runner,
)
from nlbac_tpu_torch.tree import tree_leaves


def load_state(cfg, arrays: dict):
    """A fresh state of ``cfg`` on the CPU with ``arrays``' parameters,
    targets and Lagrangian state (its Adam moments empty, as a reference
    state's first update has them)."""
    ts = create_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad():
        for name in TRAINED + TARGETS:
            for p, a in zip(tree_leaves(getattr(ts, name)), arrays[name]):
                p.copy_(torch.from_numpy(a))
    ts.lag = type(ts.lag)(*(torch.tensor(a) for a in arrays["lag"]))
    return ts


def _join(rank, world, coordinator):
    torch.set_num_threads(1)
    parallel.init_distributed(coordinator, world, rank, backend="gloo",
                              device="cpu")


def _write(out, rank, result):
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def dp_updates(rank, world, coordinator, inputs, out):
    """``update_from_batch`` over a dp grid of ``world`` ranks for each
    case of ``inputs`` (a pickle: preset, config, initial arrays, and per
    update the whole batches, the injected draws and the episode)."""
    _join(rank, world, coordinator)
    with open(inputs, "rb") as f:
        cases = pickle.load(f)
    grid = parallel.make_mesh((world, 1))
    result = {}
    for case in cases:
        cfg = case["cfg"]
        ts = load_state(cfg, case["init"])
        place, dp_update = parallel.make_dp_update(cfg, grid, "cpu")
        (ts,) = place((ts,))
        metrics = []
        for batch, node_batch, noise, episode in case["updates"]:
            ts, m = dp_update(ts, batch, node_batch, None, episode,
                              noise=noise)
            metrics.append({k: float(v) for k, v in m.items()})
        result[case["preset"]] = {"state": state_arrays(ts),
                                  "metrics": metrics}
    _write(out, rank, result)


def train_episodes(rank, world, coordinator, cfg, dp, tp, episodes, out):
    """``episodes`` episodes of a (dp, tp) grid from the state and
    generator of seed 0; writes the rewards, the update counts, the whole
    state after them (put together under tp), the whole state put
    together right after the first shard (tp), and rank 0's weight
    files (under tp from the whole state)."""
    _join(rank, world, coordinator)
    grid = parallel.make_mesh((dp, tp))
    place, run = parallel.make_parallel_runner(cfg, grid, "cpu")
    gen = torch.Generator().manual_seed(0)
    ts = create_train_state(cfg, gen, "cpu")
    rl, node = create_replays(cfg, "cpu")
    ts, rl, node, gen, total = place((ts, rl, node, gen, 0))
    result = {"shard_bytes": parallel.shard_bytes(ts)}
    if tp > 1:
        result["first"] = state_arrays(parallel.gather_state_tp(ts))
    rewards, updates = [], []
    for ep in range(episodes):
        ts, rl, node, m, total = run(ts, rl, node, gen, ep, total)
        host = episode_to_host(m)
        rewards.append(host["reward"])
        updates.append(ts.updates)
    whole = parallel.gather_state_tp(ts) if tp > 1 else ts
    result.update(rewards=rewards, updates=updates,
                  state=state_arrays(whole), replay=rl.data.numpy().copy())
    if rank == 0:
        save_model_weights(os.path.join(out, "weights"), whole)
    _write(out, rank, result)


def one_rank_run(cfg, episodes):
    """The same run in this process, on one rank: (rewards, state)."""
    gen = torch.Generator().manual_seed(0)
    ts = create_train_state(cfg, gen, "cpu")
    rl, node = create_replays(cfg, "cpu")
    run = make_episode_runner(cfg, "cpu", agent=make_agent(cfg, "cpu"))
    total, rewards = 0, []
    for ep in range(episodes):
        ts, rl, node, m, total = run(ts, rl, node, gen, ep, total)
        rewards.append(episode_to_host(m)["reward"])
    return rewards, ts, rl


def nccl_on_one_card(rank, world, coordinator):
    """Join a gang with NCCL on card 0, as every rank of it does."""
    parallel.init_distributed(coordinator, world, rank, backend="nccl",
                              device="cuda:0")
