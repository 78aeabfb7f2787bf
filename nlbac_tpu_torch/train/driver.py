"""Episode driver (port of ``nlbac_tpu/train/driver.py``) as a Python loop
over env steps, with the reference's step order:

1. ``updates_per_step`` updates, gated by ``len(rl_replay) > batch_size``;
2. the supervisor's pre-action bump and ``select_action`` (random actions
   while ``total_steps < start_steps``);
3. the env step;
4. the replay pushes: the RL push is skipped while the backup controller
   acts, the NODE push always happens; the mask is 1 at the time limit,
   else ``not done``; transition times t = (step-1)*dt, next_t = step*dt
   (the NODE record one dt later under ``reference_time_labels``);
5. the supervisor's trigger machine.

The step reads the device once, for ``done`` and the backup flag together;
everything else stays queued on the device. Capturing the step body in a
CUDA graph is queued in ROADMAP.md.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from nlbac_tpu_torch import replay as replay_lib
from nlbac_tpu_torch import resolve_device
from nlbac_tpu_torch.agent import TrainState, make_agent
from nlbac_tpu_torch.agent.update import METRIC_NAMES
from nlbac_tpu_torch.config import NLBACConfig
from nlbac_tpu_torch.envs import get_env
from nlbac_tpu_torch.train.supervisor import (
    init_supervisor,
    post_step,
    pre_action,
)


class EpisodeMetrics(NamedTuple):
    reward: torch.Tensor
    steps: int
    num_violations: torch.Tensor
    safety_cost: torch.Tensor
    reached: torch.Tensor
    goal_met: torch.Tensor
    viol_breakdown: torch.Tensor  # (4,)
    cost_breakdown: torch.Tensor  # (4,)
    backup_steps: torch.Tensor
    updates_done: int
    train: Dict[str, torch.Tensor]  # last update's metrics


def _f32(x: float) -> float:
    return float(np.float32(x))


def make_episode_runner(cfg: NLBACConfig, device="cuda", agent=None):
    """Build ``run_episode(ts, rl_replay, node_replay, gen, i_episode,
    total_steps) -> (ts, rl_replay, node_replay, EpisodeMetrics,
    total_steps)``. State, replays and ``gen`` live on ``device``."""
    device = resolve_device(device)
    env = get_env(cfg.env.name)
    agent = agent if agent is not None else make_agent(cfg, device)
    scfg = cfg.sac
    dt = cfg.env.dt
    max_steps = cfg.env.max_episode_steps
    barrier_B = cfg.env.barrier_B if cfg.env.barrier_signals else 0.0
    barrier_b = cfg.env.barrier_b if cfg.env.barrier_signals else 0.0
    if cfg.env.spawn_curriculum_episodes or cfg.env.kill_penalty or \
            cfg.env.kill_attitude:
        raise NotImplementedError("spawn curricula and kill terms are not "
                                  "ported (quadrotor only)")
    if cfg.supervisor.kind != "none" and not cfg.constraint.use_backup:
        raise ValueError(
            f"supervisor.kind={cfg.supervisor.kind!r} requires "
            "constraint.use_backup=True: the backup controller it would "
            "engage is never trained or sampled")

    def run_episode(ts: TrainState, rl_replay, node_replay, gen,
                    i_episode: int, total_steps: int):
        env_state, obs = env.reset(device, max_episode_steps=max_steps)
        start_backup = i_episode >= cfg.supervisor.enable_after_episodes
        sup = init_supervisor(cfg.supervisor, device)
        zero = torch.zeros((), device=device)
        acc = {k: zero for k in ("reward", "num_violations", "safety_cost",
                                 "reached")}
        viol = torch.zeros(4, device=device)
        cost = torch.zeros(4, device=device)
        goal_met = torch.zeros((), dtype=torch.bool, device=device)
        backup_steps = torch.zeros((), dtype=torch.int32, device=device)
        train_m = {k: zero for k in METRIC_NAMES}
        episode_steps = updates_done = 0
        done = False
        while not done:
            # --- 1. gradient updates ------------------------------------
            if rl_replay.size > scfg.batch_size:
                for _ in range(scfg.updates_per_step):
                    ts, train_m = agent.update(ts, rl_replay, node_replay,
                                               gen, i_episode)
                updates_done += scfg.updates_per_step

            # --- 2. action selection (+ supervisor timer bumps) -----------
            use_backup, sup = pre_action(cfg.supervisor, sup, start_backup)
            warmup = total_steps < scfg.start_steps
            action = agent.select_action(ts, obs, gen, warmup, use_backup)

            # --- 3. env step ----------------------------------------------
            env_state, out = env.step(env_state, action, barrier_B=barrier_B,
                                      barrier_b=barrier_b,
                                      max_episode_steps=max_steps)
            episode_steps += 1
            total_steps += 1
            if episode_steps == max_steps:
                mask = 1.0
            else:
                mask = 1.0 - out.done.to(torch.float32)

            # --- 4. the supervisor and the accumulators ---------------------
            sup = post_step(cfg.supervisor, sup, obs, out, episode_steps,
                            start_backup)
            acc = {k: acc[k] + getattr(out, k) for k in acc}
            viol = viol + out.viol_breakdown
            cost = cost + out.cost_breakdown
            goal_met = goal_met | out.goal_met
            backup_steps = backup_steps + use_backup.to(torch.int32)

            # --- 5. replay pushes (after the step's one device read) --------
            done, backup_on = torch.stack(
                [out.done, use_backup]).tolist()
            t = _f32(np.float32(episode_steps - 1) * np.float32(dt))
            next_t = _f32(np.float32(t) + np.float32(dt))
            rec = replay_lib.record_from_step(obs, action, out, mask, t,
                                              next_t)
            replay_lib.push(rl_replay, rec, do_push=not backup_on)
            if cfg.node.reference_time_labels:
                node_rec = replay_lib.record_from_step(
                    obs, action, out, mask, next_t,
                    _f32(np.float32(t) + np.float32(2.0 * dt)))
            else:
                node_rec = rec
            replay_lib.push(node_replay, node_rec)
            obs = out.obs

        metrics = EpisodeMetrics(
            reward=acc["reward"], steps=episode_steps,
            num_violations=acc["num_violations"],
            safety_cost=acc["safety_cost"], reached=acc["reached"],
            goal_met=goal_met, viol_breakdown=viol, cost_breakdown=cost,
            backup_steps=backup_steps, updates_done=updates_done,
            train=train_m)
        return ts, rl_replay, node_replay, metrics, total_steps

    return run_episode


def create_replays(cfg: NLBACConfig, device="cuda"):
    device = resolve_device(device)
    spec = get_env(cfg.env.name).SPEC
    rl = replay_lib.create(cfg.replay.capacity, spec.obs_dim,
                           spec.action_dim, spec.lyap_dim, device)
    node = replay_lib.create(cfg.replay.node_capacity, spec.obs_dim,
                             spec.action_dim, spec.lyap_dim, device)
    return rl, node
