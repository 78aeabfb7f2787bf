"""Rank functions of the port's gang tests (``test_torch_port_parallel.py``),
spawned by ``nlbac_tpu_torch.parallel.run_gang``. A spawned rank imports
its function by module name, so this module imports torch and the port
only (the test module imports JAX). Each rank joins a gloo gang on the
CPU and writes what it computed to ``<out>/rank<r>.pkl``. The sharded
lockstep tests (``test_torch_port_lockstep_cards.py``) take their
workers' ``prepare`` and ``setup`` hooks from here for the same reason."""

import dataclasses

import os
import pickle

import torch

from nlbac_tpu_torch import parallel
from nlbac_tpu_torch.agent import create_train_state, make_agent
from nlbac_tpu_torch.interop import TARGETS, TRAINED
from nlbac_tpu_torch.nn import make_field
from nlbac_tpu_torch.ode import odeint_adjoint, solvers
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


def count_trials():
    """Count this process's adaptive trial steps (every form, the
    adjoint's backward solves included; not the scan form's frozen trials,
    whose step is 0): a one-item list that each trial adds one to."""
    n = [0]
    inner = solvers._trial

    def counted(field, params, t, y, dt, *rest):
        n[0] += bool(dt != 0)
        return inner(field, params, t, y, dt, *rest)

    solvers._trial = counted
    return n


def _write(out, rank, result):
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def dp_updates(rank, world, coordinator, inputs, out):
    """``update_from_batch`` over a dp grid of ``world`` ranks for each
    case of ``inputs`` (a pickle: name, config, initial arrays, and per
    update the whole batches, the injected draws and the episode); the
    adaptive solver's trial steps are counted per update."""
    _join(rank, world, coordinator)
    with open(inputs, "rb") as f:
        cases = pickle.load(f)
    grid = parallel.make_mesh((world, 1))
    trials = count_trials()
    result = {}
    for case in cases:
        cfg = case["cfg"]
        ts = load_state(cfg, case["init"])
        place, dp_update = parallel.make_dp_update(cfg, grid, "cpu")
        (ts,) = place((ts,))
        metrics, counts = [], []
        for batch, node_batch, noise, episode in case["updates"]:
            trials[0] = 0
            ts, m = dp_update(ts, batch, node_batch, None, episode,
                              noise=noise)
            metrics.append({k: float(v) for k, v in m.items()})
            counts.append(trials[0])
        result[case["name"]] = {"state": state_arrays(ts),
                                "metrics": metrics, "trials": counts}
    _write(out, rank, result)


def train_episodes(rank, world, coordinator, cfg, dp, tp, episodes, out):
    """``episodes`` episodes of a (dp, tp) grid from the state and
    generator of seed 0; writes the rewards, the update counts, the whole
    state after them (put together under tp), the whole state put
    together right after the first shard (tp), and rank 0's weight
    files (under tp from the whole state)."""
    _join(rank, world, coordinator)
    trials = count_trials()
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
    result.update(rewards=rewards, updates=updates, trials=trials[0],
                  state=state_arrays(whole), replay=rl.data.numpy().copy())
    if rank == 0:
        save_model_weights(os.path.join(out, "weights"), whole)
    _write(out, rank, result)


def dopri5_halves(rank, world, coordinator, inputs, out):
    """Each dp rank's half of the rows of ``inputs`` (a pickle: the
    control-affine NODE config, its parameters, x, u, dt, and a trial's
    y5, y4 and y): the trial's error norm over the group
    (``rows_reduce``); the scan form's trial errors on the rank's rows;
    and the adjoint's loss (the rank's share of the mean over all rows),
    parameter gradients and trial count with the group's norms."""
    _join(rank, world, coordinator)
    with open(inputs, "rb") as f:
        case = pickle.load(f)
    comm = parallel.make_mesh((world, 1)).dp_comm
    k = case["x"].shape[0] // world
    mine = slice(rank * k, (rank + 1) * k)
    y5, y4, y = (case[n][mine] for n in ("y5", "y4", "y"))
    err = solvers._err_norm(y5, y4, y, 1e-5, 1e-7,
                            solvers.rows_reduce(comm))
    cfg = case["cfg"]
    field = make_field(cfg)
    params = {net: {k_: [t.clone().requires_grad_(True) for t in v]
                    for k_, v in layers.items()}
              for net, layers in case["params"].items()}
    s0 = torch.cat([case["x"][mine], case["u"][mine]], dim=-1)
    trace = []
    solvers.solve_adaptive(field, params, s0, 0.0, case["dt"], impl="scan",
                           max_steps=16, trace=trace,
                           reduce=solvers.rows_reduce(comm))
    trials = count_trials()
    s1 = odeint_adjoint(field, params, s0, 0.0, case["dt"],
                        method="dopri5", dp_group=comm)
    # the local share of the mean over all rows, as the update's loss is
    loss = torch.sum(torch.square(s1[:, :cfg.state_dim])) / \
        (case["x"].shape[0] * cfg.state_dim)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    _write(out, rank, {"err": float(err), "loss": loss.item(),
                       "grads": [g.numpy() for g in grads],
                       "trials": trials[0],
                       "scan_errs": [float(e) for e, _, active in trace
                                     if active]})


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


def drop_a_seed(cfg, ts):
    """A sharded lockstep runner's ``prepare`` hook that leaves its shard's
    state one seed short, so that the shard's first episode raises in its
    worker."""
    return dataclasses.replace(ts, updates=ts.updates[:-1])


def register_unicycle_alias():
    """A sharded lockstep runner's ``setup`` hook: the unicycle env
    registered at run time under another name, in the worker."""
    from nlbac_tpu_torch.envs import register_env, unicycle

    register_env("unicycle_alias", unicycle)
