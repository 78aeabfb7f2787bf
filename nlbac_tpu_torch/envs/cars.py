"""Simulated car-following chain on tensors (port of
``nlbac_tpu/envs/cars.py``; physics and reward as there).

- 5 cars, state [x1 v1 ... x5 v5] (10,), control = car 4's acceleration
  (1,), bounds +/-3.0, dt=0.02, 300 steps
- desired velocities 3.0, car 1's modulated by -4 sin(t); accelerations
  kp (v_des - v) with brake terms for cars 2, 3, 5 and car 4's zeroed,
  all scaled by 1.1
- reward = -0.5 |a|^2 / max_steps, +2.0 when |gap34 - 9.5| < 0.5;
  constraint = |gap34 - 9.5|
- violations when gap34 < 2.5 or gap45 < 2.5; cost |gap - 2.5|
- Lyapunov input = [x3, v3, x4, v4] before/after the step
- obs = state with positions/100, velocities/30
- reset velocities: 3.0 + ONE shared N(0, 0.5) draw; car 4 back to 3.0

The step counter is a host integer; the sim time is a device scalar.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from nlbac_tpu_torch.envs.base import EnvSpec, StepOut

KP = 4.0
K_BRAKE = 20.0
SHOULD_KEEP = 9.5
KEEP_THRESHOLD = 0.5
REWARD_GOAL = 2.0
GAP_MIN = 2.5
INIT_POS = np.array([42.0, 34.0, 26.0, 18.0, 10.0], np.float32)
OBS_SCALE = np.tile(np.array([1 / 100.0, 1 / 30.0], np.float32), 5)
STATE_SCALE = np.tile(np.array([100.0, 30.0], np.float32), 5)

SPEC = EnvSpec(
    name="cars", obs_dim=10, action_dim=1, state_dim=10, lyap_dim=4,
    dt=0.02, max_episode_steps=300,
    action_low=(-3.0,), action_high=(3.0,),
)


class CarsState(NamedTuple):
    x: torch.Tensor  # (10,) [x1 v1 ... x5 v5]
    t: torch.Tensor  # f32 sim time
    step: int


@functools.lru_cache(maxsize=None)
def constants(device: torch.device) -> dict:
    """The scales and start positions as tensors on ``device`` (copied
    once, so the per-step code makes no host-to-device copy)."""
    return {name: torch.as_tensor(v, device=device) for name, v in
            (("obs_scale", OBS_SCALE), ("state_scale", STATE_SCALE),
             ("init_pos", INIT_POS))}


def get_obs(x):
    return x * constants(x.device)["obs_scale"]


def reset(device, gen: Optional[torch.Generator] = None,
          max_episode_steps: int = SPEC.max_episode_steps,
          noise: Optional[torch.Tensor] = None
          ) -> Tuple[CarsState, torch.Tensor]:
    """The start state; the shared velocity offset is ``0.5 * noise``, with
    the standard-normal ``noise`` drawn from ``gen`` unless given."""
    device = torch.device(device)
    if noise is None:
        noise = torch.randn((), generator=gen, device=device)
    v0 = 3.0 + 0.5 * noise.to(device=device, dtype=torch.float32)
    x = torch.zeros((10,), dtype=torch.float32, device=device)
    x[0::2] = constants(device)["init_pos"]
    x[1::2] = v0
    x[7] = 3.0  # car 4
    st = CarsState(x=x, t=torch.zeros((), device=device), step=0)
    return st, get_obs(st.x)


def accelerations(x, t):
    """The four uncontrolled cars' hand-coded accelerations (+ car 4's
    zeroed slot), including the 1.1 'unknown part' scaling."""
    pos = x[0::2]
    vels = x[1::2]
    vels_des = torch.full_like(vels, 3.0)
    vels_des[0] = vels_des[0] - 4.0 * torch.sin(t)
    accels = KP * (vels_des - vels)
    d01, d12, d24 = pos[0] - pos[1], pos[1] - pos[2], pos[2] - pos[4]
    accels[1] = accels[1] - K_BRAKE * d01 * (d01 < 6.5)
    accels[2] = accels[2] - K_BRAKE * d12 * (d12 < 6.5)
    accels[3] = 0.0
    accels[4] = accels[4] - K_BRAKE * d24 * (d24 < 13.0)
    return accels * 1.1


def step(state: CarsState, action, *, barrier_B: float = 0.0,
         barrier_b: float = 0.0,
         max_episode_steps: int = SPEC.max_episode_steps
         ) -> Tuple[CarsState, StepOut]:
    x = state.x
    accels = accelerations(x, state.t)
    lyap_t = x[4:8]  # [x3, v3, x4, v4] before

    f_x = torch.zeros_like(x)
    f_x[0::2] = x[1::2]
    f_x[1::2] = accels
    f_x[7] = 0.0
    g_x = torch.zeros_like(x)
    g_x[7] = 1.0

    x_new = x + SPEC.dt * (f_x + g_x * action[0])
    t_new = state.t + SPEC.dt
    step_count = state.step + 1

    gap34 = x_new[4] - x_new[6]
    gap45 = x_new[6] - x_new[8]
    reward = -0.5 * torch.abs(action[0] ** 2) / max_episode_steps
    reached = (torch.abs(gap34 - SHOULD_KEEP) < KEEP_THRESHOLD).to(
        torch.float32)
    reward = reward + reached * REWARD_GOAL
    done = torch.full((), step_count >= max_episode_steps, dtype=torch.bool,
                      device=x.device)

    v34 = (gap34 < GAP_MIN).to(torch.float32)
    v45 = (gap45 < GAP_MIN).to(torch.float32)
    n_viol = v34 + v45
    cost = v34 * torch.abs(gap34 - GAP_MIN) + v45 * torch.abs(gap45 - GAP_MIN)
    barrier = torch.where(n_viol > 0, n_viol * barrier_B,
                          torch.full_like(n_viol, barrier_b))
    zero = torch.zeros_like(n_viol)
    out = StepOut(
        obs=get_obs(x_new), reward=reward,
        constraint=torch.abs(gap34 - SHOULD_KEEP), lyap_t=lyap_t,
        lyap_t1=x_new[4:8], barrier_signal=barrier, done=done,
        goal_met=torch.zeros((), dtype=torch.bool, device=x.device),
        reached=reached, num_violations=n_viol, safety_cost=cost,
        viol_breakdown=torch.stack([n_viol, zero, zero, zero]),
        cost_breakdown=torch.stack([cost, zero, zero, zero]),
    )
    return CarsState(x=x_new, t=t_new, step=step_count), out


def obs_to_state(obs):
    """obs -> NODE state: positions x100, velocities x30."""
    return obs * constants(obs.device)["state_scale"]


def state_to_obs(state):
    """NODE state -> obs (batched): positions /100, velocities /30."""
    return state * constants(state.device)["obs_scale"]
