"""Unicycle navigation env on tensors (port of
``nlbac_tpu/envs/unicycle.py``; physics and reward as there).

- state [x, y, theta], action [v, omega], dt=0.02, 1200 steps
- Euler step x += dt*g(x) u, then the disturbance
  x -= dt*0.1*g(x_new) @ [cos th_new, 0]
- lookahead point p(x) = [x + l_p cos th, y + l_p sin th], l_p=0.03
- reward = -0.1 (v - 2.5)^2 + 30 (last_dist - dist) (+500 on goal)
- 7 hazards of radius 0.5; obs = [x, y, cos th, sin th, compass(2),
  exp(-dist)]

The step counter is a host integer, so the time limit needs no device
read.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from nlbac_tpu_torch.envs.base import EnvSpec, StepOut

L_P = 0.03
DES_V = 2.5
GOAL = np.array([2.5, 2.5], np.float32)
GOAL_SIZE = 0.3
REWARD_GOAL = 500.0
HAZARDS = 1.5 * np.array(
    [[0.0, 0.0], [0.0, 1.0], [0.0, -1.0], [-1.0, 1.0], [-1.0, -1.0],
     [1.0, -1.0], [1.0, 1.0]], np.float32)
HAZARD_RADIUS = 0.5
INIT_STATE = np.array([-2.5, -2.5, 0.0], np.float32)
INIT_CENTER = np.array([-2.47, -2.5], np.float32)

SPEC = EnvSpec(
    name="unicycle", obs_dim=7, action_dim=2, state_dim=3, lyap_dim=2,
    dt=0.02, max_episode_steps=1200,
    action_low=(-3.5, -12.0), action_high=(3.5, 12.0),
)


class UnicycleState(NamedTuple):
    x: torch.Tensor  # (3,) [px, py, theta]
    step: int
    last_goal_dist: torch.Tensor  # f32 scalar


@functools.lru_cache(maxsize=None)
def constants(device: torch.device) -> dict:
    """GOAL, HAZARDS and the reset state as tensors on ``device`` (copied
    once, so the per-step code makes no host-to-device copy)."""
    return {name: torch.as_tensor(v, device=device) for name, v in
            (("goal", GOAL), ("hazards", HAZARDS), ("init_state", INIT_STATE),
             ("init_center", INIT_CENTER))}


def _lookahead(x):
    th = x[2]
    return x[:2] + L_P * torch.stack([torch.cos(th), torch.sin(th)])


def get_obs(x):
    th = x[2]
    rel = constants(x.device)["goal"] - x[:2]
    dist = torch.linalg.vector_norm(rel)
    c, s = torch.cos(th), torch.sin(th)
    vec = torch.stack([rel[0] * c + rel[1] * s, -rel[0] * s + rel[1] * c])
    vec = vec / (torch.linalg.vector_norm(vec) + 0.001)
    return torch.cat([x[:2], torch.stack([c, s]), vec,
                      torch.exp(-dist)[None]])


def reset(device, gen: Optional[torch.Generator] = None,
          max_episode_steps: int = SPEC.max_episode_steps
          ) -> Tuple[UnicycleState, torch.Tensor]:
    """The deterministic start state (``gen`` is not drawn from)."""
    del gen
    k = constants(torch.device(device))
    st = UnicycleState(
        x=k["init_state"].clone(), step=0,
        last_goal_dist=torch.linalg.vector_norm(k["goal"] - k["init_center"]))
    return st, get_obs(st.x)


def step(state: UnicycleState, action, *, barrier_B: float = 0.0,
         barrier_b: float = 0.0,
         max_episode_steps: int = SPEC.max_episode_steps
         ) -> Tuple[UnicycleState, StepOut]:
    x = state.x
    k = constants(x.device)
    center = _lookahead(x)

    th = x[2]
    gu = torch.stack([torch.cos(th) * action[0], torch.sin(th) * action[0],
                      action[1]])
    x_new = x + SPEC.dt * gu
    th_new = x_new[2]
    x_new = x_new - SPEC.dt * 0.1 * torch.stack(
        [torch.cos(th_new) * torch.cos(th_new),
         torch.sin(th_new) * torch.cos(th_new), torch.zeros_like(th_new)])

    next_center = _lookahead(x_new)
    step_count = state.step + 1

    dist_goal = torch.linalg.vector_norm(k["goal"] - next_center)
    reward = (-torch.square(action[0] - DES_V) * 0.1
              + (state.last_goal_dist - dist_goal) * 30.0)
    goal_met = dist_goal <= GOAL_SIZE
    reward = reward + torch.where(goal_met, REWARD_GOAL, 0.0)
    done = goal_met | (step_count >= max_episode_steps)

    d2 = torch.sum(torch.square(next_center[None, :] - k["hazards"]), dim=1)
    violated = d2 < HAZARD_RADIUS ** 2
    n_viol = torch.sum(violated.to(torch.float32))
    dists = torch.sqrt(d2)
    cost = torch.sum(torch.where(violated,
                                 (HAZARD_RADIUS - dists) / HAZARD_RADIUS,
                                 0.0))
    barrier = torch.where(n_viol > 0, n_viol * barrier_B,
                          torch.full_like(n_viol, barrier_b))
    zero = torch.zeros_like(n_viol)
    out = StepOut(
        obs=get_obs(x_new), reward=reward, constraint=dist_goal,
        lyap_t=center, lyap_t1=next_center, barrier_signal=barrier,
        done=done, goal_met=goal_met, reached=zero,
        num_violations=n_viol, safety_cost=cost,
        viol_breakdown=torch.stack([n_viol, zero, zero, zero]),
        cost_breakdown=torch.stack([cost, zero, zero, zero]),
    )
    return UnicycleState(x=x_new, step=step_count,
                         last_goal_dist=dist_goal), out


def obs_to_state(obs):
    """Observation -> NODE state [x, y, arctan2(sin, cos)]."""
    theta = torch.atan2(obs[..., 3], obs[..., 2])
    return torch.stack([obs[..., 0], obs[..., 1], theta], dim=-1)


def state_to_obs(state):
    """Predicted NODE state -> full 7-d observation (batched)."""
    th = state[..., 2]
    c, s = torch.cos(th), torch.sin(th)
    rel = constants(state.device)["goal"] - state[..., :2]
    dist = torch.linalg.vector_norm(rel, dim=-1)
    vec = torch.stack([rel[..., 0] * c + rel[..., 1] * s,
                       -rel[..., 0] * s + rel[..., 1] * c], dim=-1)
    vec = vec / (torch.linalg.vector_norm(vec, dim=-1, keepdim=True) + 0.001)
    return torch.cat(
        [state[..., :2], torch.stack([c, s], dim=-1), vec,
         torch.exp(-dist)[..., None]], dim=-1)
