"""The environment contract (port of ``nlbac_tpu/envs/base.py``).

Each env module exposes::

    SPEC: EnvSpec
    reset(device, gen=None, max_episode_steps=...) -> (EnvState, obs)
    obs_to_state(obs) / state_to_obs(state)  # NODE-space adapters
    step(state, action, ...) -> (EnvState, StepOut)

with tensors on the env's device; ``gen`` feeds a reset that draws
(cars).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class StepOut(NamedTuple):
    """One transition's outputs; the union of all variants' fields."""

    obs: torch.Tensor
    reward: torch.Tensor  # f32 scalar
    constraint: torch.Tensor  # f32 scalar (Lyapunov TD target)
    lyap_t: torch.Tensor  # Lyapunov-network input before the step
    lyap_t1: torch.Tensor  # Lyapunov-network input after the step
    barrier_signal: torch.Tensor  # f32 scalar (NBC variants; else 0)
    done: torch.Tensor  # bool scalar
    goal_met: torch.Tensor  # bool scalar
    reached: torch.Tensor  # f32 scalar (cars in-range indicator; else 0)
    num_violations: torch.Tensor  # f32 scalar, total this step
    safety_cost: torch.Tensor  # f32 scalar, total this step
    viol_breakdown: torch.Tensor  # (4,) f32
    cost_breakdown: torch.Tensor  # (4,) f32


class EnvSpec(NamedTuple):
    """Static env description the agent needs."""

    name: str
    obs_dim: int
    action_dim: int
    state_dim: int  # physical state dim fed to the NODE
    lyap_dim: int
    dt: float
    max_episode_steps: int
    action_low: tuple
    action_high: tuple
