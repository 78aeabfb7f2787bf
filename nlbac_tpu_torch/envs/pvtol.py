"""PVTOL (planar VTOL with a ground safety operator) on tensors (port of
``nlbac_tpu/envs/pvtol.py``; physics and reward as there).

- 7-d full state [x, y, theta, vx, vy, thrust, operator_x]; the first 6
  are the NODE dynamics state
- dynamics f = [vx, vy, 0, -sin th * thrust, cos th * thrust - 1, 0],
  g = [[0,0],[0,0],[0,1],[0,0],[0,0],[1,0]], Euler dt=0.02
- the operator follows: op += 0.7 (x_new - op)
- reward = -1e-3 * dist(pos, goal); goal [4.5, 4.5] radius 3.5 -> +1500,
  done; constraint = dist
- violations: 5 obstacles r=0.25 (cost (r-d)/r), operator |x-op| >= 1.0
  (cost |diff|-1), y > 100 / y < -100 (cost linear excess)
- obs (11,) = [x, y, cos th, sin th, vx, vy, thrust, op_x, compass(2),
  exp(-dist)]; the Lyapunov inputs are the full obs before/after

The reset is deterministic; the step counter is a host integer.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from nlbac_tpu_torch.envs.base import EnvSpec, StepOut

GOAL = np.array([4.5, 4.5], np.float32)
GOAL_SIZE = 3.5
REWARD_GOAL = 1500.0
HAZARDS = np.array([[-2.5, -2.5], [-2.5, 2.5], [0.0, -3.5], [0.0, 3.5],
                    [-4.5, 0.0]], np.float32)
HAZARD_RADIUS = 0.25
OPERATOR_FOLLOW = 0.7
OPERATOR_DIST = 1.0
Y_MIN = -100.0
Y_MAX = 100.0
INIT_STATE = np.array([-4.5, -4.5, 0.0, 0.0, 0.0, 1.0, -4.5], np.float32)

SPEC = EnvSpec(
    name="pvtol", obs_dim=11, action_dim=2, state_dim=6, lyap_dim=11,
    dt=0.02, max_episode_steps=2000,
    action_low=(-3.5, -15.0), action_high=(3.5, 15.0),
)


class PvtolState(NamedTuple):
    x: torch.Tensor  # (7,) [x, y, th, vx, vy, thrust, op_x]
    step: int
    last_goal_dist: torch.Tensor  # f32


@functools.lru_cache(maxsize=None)
def constants(device: torch.device) -> dict:
    """GOAL, HAZARDS and the reset state as tensors on ``device`` (copied
    once, so the per-step code makes no host-to-device copy)."""
    return {name: torch.as_tensor(v, device=device) for name, v in
            (("goal", GOAL), ("hazards", HAZARDS),
             ("init_state", INIT_STATE))}


def get_obs(x):
    th = x[2]
    c, s = torch.cos(th), torch.sin(th)
    rel = constants(x.device)["goal"] - x[:2]
    dist = torch.linalg.vector_norm(rel)
    vec = torch.stack([rel[0] * c + rel[1] * s, -rel[0] * s + rel[1] * c])
    vec = vec / (torch.linalg.vector_norm(vec) + 0.001)
    return torch.cat([x[:2], torch.stack([c, s]), x[3:7], vec,
                      torch.exp(-dist)[None]])


def reset(device, gen: Optional[torch.Generator] = None,
          max_episode_steps: int = SPEC.max_episode_steps
          ) -> Tuple[PvtolState, torch.Tensor]:
    """The deterministic start state (``gen`` is not drawn from)."""
    del gen
    k = constants(torch.device(device))
    x = k["init_state"].clone()
    st = PvtolState(x=x, step=0, last_goal_dist=torch.linalg.vector_norm(
        k["goal"] - x[:2]))
    return st, get_obs(st.x)


def dynamics_f(dyn):
    """f(x) for the 6-d dynamics state."""
    th, thrust = dyn[2], dyn[5]
    zero = torch.zeros_like(th)
    return torch.stack([dyn[3], dyn[4], zero, -torch.sin(th) * thrust,
                        torch.cos(th) * thrust - 1.0, zero])


def step(state: PvtolState, action, *, barrier_B: float = 0.0,
         barrier_b: float = 0.0,
         max_episode_steps: int = SPEC.max_episode_steps
         ) -> Tuple[PvtolState, StepOut]:
    x = state.x
    k = constants(x.device)
    lyap_t = get_obs(x)  # obs before the step

    dyn = x[:6]
    zero = torch.zeros_like(action[0])
    gu = torch.stack([zero, zero, action[1], zero, zero, action[0]])
    dyn_new = dyn + SPEC.dt * (dynamics_f(dyn) + gu)
    op_new = x[6] + OPERATOR_FOLLOW * (dyn_new[0] - x[6])
    x_new = torch.cat([dyn_new, op_new[None]])
    step_count = state.step + 1

    dist_goal = torch.linalg.vector_norm(x_new[:2] - k["goal"])
    goal_met = dist_goal <= GOAL_SIZE
    reward = -1e-3 * dist_goal + torch.where(goal_met, REWARD_GOAL, 0.0)
    done = goal_met | (step_count >= max_episode_steps)

    # obstacles
    d2 = torch.sum(torch.square(x_new[None, :2] - k["hazards"]), dim=1)
    violated = d2 < HAZARD_RADIUS ** 2
    n_obs = torch.sum(violated.to(torch.float32))
    dists = torch.sqrt(d2)
    c_obs = torch.sum(torch.where(violated,
                                  (HAZARD_RADIUS - dists) / HAZARD_RADIUS,
                                  0.0))
    # operator
    diff = x_new[0] - x_new[6]
    op_viol = (torch.abs(diff) >= OPERATOR_DIST).to(torch.float32)
    c_op = op_viol * (torch.abs(diff) - OPERATOR_DIST)
    # y box
    ymax_viol = (x_new[1] > Y_MAX).to(torch.float32)
    c_ymax = ymax_viol * (x_new[1] - Y_MAX)
    ymin_viol = (x_new[1] < Y_MIN).to(torch.float32)
    c_ymin = ymin_viol * (Y_MIN - x_new[1])

    n_viol = n_obs + op_viol + ymin_viol + ymax_viol
    cost = c_obs + c_op + c_ymin + c_ymax
    barrier = torch.where(n_viol > 0, n_viol * barrier_B,
                          torch.full_like(n_viol, barrier_b))

    lyap_t1 = get_obs(x_new)
    out = StepOut(
        obs=lyap_t1, reward=reward, constraint=dist_goal, lyap_t=lyap_t,
        lyap_t1=lyap_t1, barrier_signal=barrier, done=done,
        goal_met=goal_met, reached=torch.zeros_like(reward),
        num_violations=n_viol, safety_cost=cost,
        viol_breakdown=torch.stack([n_obs, op_viol, ymin_viol, ymax_viol]),
        cost_breakdown=torch.stack([c_obs, c_op, c_ymin, c_ymax]),
    )
    return PvtolState(x=x_new, step=step_count,
                      last_goal_dist=dist_goal), out


def obs_to_state(obs):
    """obs (..., 11) -> full state (..., 7) [x, y, arctan2, vx, vy, thrust,
    op_x]."""
    theta = torch.atan2(obs[..., 3], obs[..., 2])
    return torch.cat([obs[..., :2], theta[..., None], obs[..., 4:8]], dim=-1)


def obs_to_dynamics_state(obs):
    """obs -> 6-d NODE dynamics state (drops operator_x)."""
    return obs_to_state(obs)[..., :6]


def state_to_obs(state):
    """Full 7-d state (batched) -> 11-d obs, differentiably (used on NODE
    predictions)."""
    th = state[..., 2]
    c, s = torch.cos(th), torch.sin(th)
    rel = constants(state.device)["goal"] - state[..., :2]
    dist = torch.linalg.vector_norm(rel, dim=-1)
    vec = torch.stack([rel[..., 0] * c + rel[..., 1] * s,
                       -rel[..., 0] * s + rel[..., 1] * c], dim=-1)
    vec = vec / (torch.linalg.vector_norm(vec, dim=-1, keepdim=True) + 0.001)
    return torch.cat([state[..., :2], torch.stack([c, s], dim=-1),
                      state[..., 3:7], vec, torch.exp(-dist)[..., None]],
                     dim=-1)


def propagate_operator(op_x, next_x):
    """The operator's follow law, applied when chaining NODE
    predictions."""
    return op_x + OPERATOR_FOLLOW * (next_x - op_x)
