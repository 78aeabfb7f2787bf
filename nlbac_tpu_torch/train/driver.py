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

An env with a spawn curriculum (the quadrotor) resets through
``reset_curriculum`` when ``spawn_curriculum_episodes`` > 0, and its kill
terms reach ``env.step`` only when set.

The step reads the device once, for ``done`` and the backup flag together;
everything else stays queued on the device (the dopri5 solver's ``while``
form adds its own reads, one per trial step). Capturing the step body in a
CUDA graph is queued in ROADMAP.md.
"""

from __future__ import annotations

import inspect
from typing import Dict, NamedTuple

import numpy as np
import torch

from nlbac_tpu_torch import replay as replay_lib
from nlbac_tpu_torch import resolve_device
from nlbac_tpu_torch.agent import TrainState, make_agent
from nlbac_tpu_torch.agent.update import METRIC_NAMES
from nlbac_tpu_torch.config import NLBACConfig
from nlbac_tpu_torch.envs import get_env
from nlbac_tpu_torch.nn import DEFAULT_SQUASH
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
    # adaptive NODE integrations that ended short of their span (dopri5)
    short_integrations: torch.Tensor


def _f32(x: float) -> float:
    return float(np.float32(x))


def build_step_kwargs(cfg: NLBACConfig, env) -> dict:
    """The opt-in extra ``env.step`` kwargs (``kill_penalty``,
    ``kill_attitude``), passed only when nonzero so that envs whose step
    lacks them are untouched."""
    step_kwargs = {}
    for name in ("kill_penalty", "kill_attitude"):
        value = getattr(cfg.env, name)
        if value:
            if name not in inspect.signature(env.step).parameters:
                raise ValueError(
                    f"{name}={value} but env {cfg.env.name!r} step() does "
                    "not accept it (quadrotor only)")
            step_kwargs[name] = value
    return step_kwargs


def curriculum_kwargs(cfg: NLBACConfig, env) -> dict | None:
    """The ``reset_curriculum`` kwargs, or None when the run has no spawn
    curriculum; checks the curriculum flags as the JAX driver does."""
    eps = cfg.env.spawn_curriculum_episodes
    mode = cfg.env.spawn_curriculum_mode
    if eps > 0 and not hasattr(env, "reset_curriculum"):
        raise ValueError(
            f"spawn_curriculum_episodes={eps} but env {cfg.env.name!r} has "
            "no reset_curriculum (quadrotor only)")
    if mode not in ("anneal", "mix", "mix_early"):
        raise ValueError(f"spawn_curriculum_mode={mode!r} "
                         "(anneal | mix | mix_early)")
    if mode != "anneal" and eps <= 0:
        raise ValueError(
            f"spawn_curriculum_mode={mode!r} requires "
            "spawn_curriculum_episodes > 0 (the mode only changes what "
            "happens after the anneal window)")
    if mode == "anneal" and cfg.env.spawn_mix_alpha_min != 0.15:
        raise ValueError(
            "spawn_mix_alpha_min is only read when "
            "spawn_curriculum_mode='mix' (set the mode or drop the flag: "
            "a silently ignored mixture bound would mislabel a sweep)")
    if eps <= 0:
        return None
    return {"curriculum_episodes": eps, "mode": mode,
            "mix_alpha_min": cfg.env.spawn_mix_alpha_min}


class UpdateCarry(NamedTuple):
    """What an ``_update_step`` hook sees at an env step's update block:
    the state, both replays and the last update's metrics."""

    ts: TrainState
    rl_replay: replay_lib.Replay
    node_replay: replay_lib.Replay
    train: Dict[str, torch.Tensor]


def make_episode_runner(cfg: NLBACConfig, device="cuda", agent=None,
                        env_override=None, _update_step=None,
                        squash: str = DEFAULT_SQUASH):
    """Build ``run_episode(ts, rl_replay, node_replay, gen, i_episode,
    total_steps) -> (ts, rl_replay, node_replay, EpisodeMetrics,
    total_steps)``. State, replays and ``gen`` live on ``device``.
    ``env_override`` runs an env that is not in the registry (any object
    with the ``envs/base.py`` contract) in place of ``cfg.env.name``'s.

    ``_update_step(agent, carry, gen, i_episode) -> (ts, train_metrics)``
    replaces an env step's block of ``updates_per_step`` sequential
    ``agent.update`` calls (experimental variants and measurements only,
    see ``nlbac_tpu_torch.experimental``); ``carry`` is an ``UpdateCarry``,
    and the metrics' ``short_integrations`` count the whole block's.
    ``squash`` is the policy's tanh (``make_agent``'s); a given ``agent``
    must have been made with it."""
    device = resolve_device(device)
    env = env_override if env_override is not None else \
        get_env(cfg.env.name)
    if agent is None:
        agent = make_agent(cfg, device, env_override=env_override,
                           squash=squash)
    elif agent.squash != squash:
        raise ValueError(f"the agent's squash is {agent.squash!r}, the "
                         f"runner's {squash!r}")
    scfg = cfg.sac
    dt = cfg.env.dt
    max_steps = cfg.env.max_episode_steps
    barrier_B = cfg.env.barrier_B if cfg.env.barrier_signals else 0.0
    barrier_b = cfg.env.barrier_b if cfg.env.barrier_signals else 0.0
    curriculum = curriculum_kwargs(cfg, env)
    step_kwargs = build_step_kwargs(cfg, env)
    if cfg.supervisor.kind != "none" and not cfg.constraint.use_backup:
        raise ValueError(
            f"supervisor.kind={cfg.supervisor.kind!r} requires "
            "constraint.use_backup=True: the backup controller it would "
            "engage is never trained or sampled")

    def run_episode(ts: TrainState, rl_replay, node_replay, gen,
                    i_episode: int, total_steps: int):
        if curriculum is None:
            env_state, obs = env.reset(device, gen=gen,
                                       max_episode_steps=max_steps)
        else:
            env_state, obs = env.reset_curriculum(
                device, i_episode, gen=gen, max_episode_steps=max_steps,
                **curriculum)
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
        shorts = torch.zeros((), dtype=torch.int64, device=device)
        episode_steps = updates_done = 0
        done = False
        while not done:
            # --- 1. gradient updates ------------------------------------
            if rl_replay.size > scfg.batch_size:
                if _update_step is None:
                    for _ in range(scfg.updates_per_step):
                        ts, train_m = agent.update(ts, rl_replay,
                                                   node_replay, gen,
                                                   i_episode)
                        shorts = shorts + train_m["short_integrations"]
                else:
                    ts, train_m = _update_step(
                        agent, UpdateCarry(ts, rl_replay, node_replay,
                                           train_m), gen, i_episode)
                    shorts = shorts + train_m["short_integrations"]
                updates_done += scfg.updates_per_step

            # --- 2. action selection (+ supervisor timer bumps) -----------
            use_backup, sup = pre_action(cfg.supervisor, sup, start_backup)
            warmup = total_steps < scfg.start_steps
            action = agent.select_action(ts, obs, gen, warmup, use_backup)

            # --- 3. env step ----------------------------------------------
            env_state, out = env.step(env_state, action, barrier_B=barrier_B,
                                      barrier_b=barrier_b,
                                      max_episode_steps=max_steps,
                                      **step_kwargs)
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
            train=train_m,
            short_integrations=shorts)
        return ts, rl_replay, node_replay, metrics, total_steps

    return run_episode


def create_replays(cfg: NLBACConfig, device="cuda", env_override=None):
    device = resolve_device(device)
    env = env_override if env_override is not None else \
        get_env(cfg.env.name)
    spec = env.SPEC
    rl = replay_lib.create(cfg.replay.capacity, spec.obs_dim,
                           spec.action_dim, spec.lyap_dim, device)
    node = replay_lib.create(cfg.replay.node_capacity, spec.obs_dim,
                             spec.action_dim, spec.lyap_dim, device)
    return rl, node


def episode_to_host(m: EpisodeMetrics) -> dict:
    """The episode's metrics as Python numbers, in one device read."""
    scalars = ("reward", "num_violations", "safety_cost", "reached",
               "goal_met", "backup_steps", "short_integrations")
    flat = torch.cat(
        [torch.stack([getattr(m, k).to(torch.float32) for k in scalars]),
         m.viol_breakdown, m.cost_breakdown,
         torch.stack([m.train[k].to(torch.float32) for k in METRIC_NAMES])]
    ).tolist()
    host = dict(zip(scalars, flat))
    host["viol_breakdown"] = flat[len(scalars):len(scalars) + 4]
    host["cost_breakdown"] = flat[len(scalars) + 4:len(scalars) + 8]
    host["train"] = dict(zip(METRIC_NAMES, flat[len(scalars) + 8:]))
    host["steps"] = m.steps
    return host
