"""2-D quadrotor on tensors (port of ``nlbac_tpu/envs/quadrotor.py``;
physics, reward, kill box and barrier signals as there).

- state [x, vx, z, vz, theta, omega] (6,), obs == state; action [T1, T2]
  (motor thrusts), hover +/- 30% per motor; Euler dt=0.02, 1000 steps
- ax = sin(theta) (T1+T2)/m, az = cos(theta) (T1+T2)/m - g,
  alpha = L (T2-T1) / Iyy
- reward = -dist((x, z), goal), +250 inside the goal ring (done); the
  constraint (Lyapunov TD target) is the same distance, the Lyapunov input
  the (x, z) position
- done also when the vehicle leaves the kill box (|x| > 3, z outside
  (-0.5, 3)), or with ``kill_attitude`` when |theta| exceeds it;
  ``kill_penalty`` is taken off the reward of a killed step
- barrier signals: -1 out of the x/z range, -10 inside the obstacle;
  costs the range excess and (r - d)/r
- the reverse spawn curriculum (``reset_curriculum``, modes anneal, mix,
  mix_early) spawns on an arc from the goal back to the ground start; its
  jitter and mixture draws are standard uniforms taken from the caller's
  ``torch.Generator`` unless given

The step counter is a host integer.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from nlbac_tpu_torch.envs.base import EnvSpec, StepOut

MASS = 0.5
ARM = 0.2
IYY = 0.01
GRAVITY = 9.8
HOVER_T = MASS * GRAVITY / 2.0  # per motor
KILL_X = 3.0
KILL_Z = (-0.5, 3.0)

GOAL = np.array([1.0, 1.0], np.float32)  # (x, z)
GOAL_SIZE = 0.2
REWARD_GOAL = 250.0
X_RANGE = (-2.0, 2.0)
Z_RANGE = (0.05, 2.0)
OBSTACLE = np.array([0.0, 0.75], np.float32)
OBSTACLE_RADIUS = 0.2
INIT_STATE = np.array([-1.0, 0.0, 0.5, 0.0, 0.0, 0.0], np.float32)

BARRIER_OUT_OF_RANGE = -1.0
BARRIER_COLLISION = -10.0

SPEC = EnvSpec(
    name="quadrotor", obs_dim=6, action_dim=2, state_dim=6, lyap_dim=2,
    dt=0.02, max_episode_steps=1000,
    action_low=(0.7 * HOVER_T, 0.7 * HOVER_T),
    action_high=(1.3 * HOVER_T, 1.3 * HOVER_T),
)

# the NODE's input normalization (NodeConfig.state_scale/action_scale)
STATE_SCALE = (2.0, 2.0, 2.0, 2.0, 1.0, 5.0)
ACTION_SCALE = (2.0 * HOVER_T, 2.0 * HOVER_T)

# reverse spawn curriculum: the least goal->spawn fraction (outside the
# goal ring), the jitter's half-width, and the mix modes' cadence of exact
# ground starts
CURRICULUM_ALPHA_MIN = 0.15
CURRICULUM_JITTER = 0.05
MIX_GROUND_INTERVAL = 3
CURRICULUM_MODES = ("anneal", "mix", "mix_early")

# the ground-probe batch: the spawn state and single-coordinate offsets
# (index, delta) around it
PROBE_OFFSETS = ((0, -0.05), (0, 0.05), (2, 0.05), (2, 0.15), (1, -0.2),
                 (1, 0.2), (3, 0.2), (3, 0.4), (4, -0.2), (4, 0.2),
                 (5, -0.5), (5, 0.5))


class QuadrotorState(NamedTuple):
    x: torch.Tensor  # (6,)
    step: int


def _probe_rows() -> np.ndarray:
    rows = [INIT_STATE]
    for idx, dv in PROBE_OFFSETS:
        row = INIT_STATE.copy()
        row[idx] += np.float32(dv)
        rows.append(row)
    return np.stack(rows)


@functools.lru_cache(maxsize=None)
def constants(device: torch.device) -> dict:
    """The goal, obstacle, spawn state and probe batch as tensors on
    ``device`` (copied once, so the per-step code makes no host-to-device
    copy)."""
    return {name: torch.as_tensor(v, device=device) for name, v in
            (("goal", GOAL), ("obstacle", OBSTACLE),
             ("init_state", INIT_STATE), ("probe", _probe_rows()))}


def get_obs(x):
    return x


def _pos(x):
    return torch.stack([x[0], x[2]])


def ground_probe_obs(device) -> torch.Tensor:
    """The fixed 13-row probe batch around the ground spawn state (the
    spawn state, then x, z, vx, vz, theta and omega offsets), on which
    ``SacConfig.probe_pretanh_reg`` pulls the policy's pre-tanh mean."""
    return constants(torch.device(device))["probe"]


def reset(device, gen: Optional[torch.Generator] = None,
          max_episode_steps: int = SPEC.max_episode_steps
          ) -> Tuple[QuadrotorState, torch.Tensor]:
    """The ground start (``gen`` is not drawn from)."""
    del gen
    x = constants(torch.device(device))["init_state"].clone()
    return QuadrotorState(x=x, step=0), get_obs(x)


def _arc_pos(alpha):
    """The (x, z) spawn point at ``alpha`` (a 0-d tensor) on the curriculum
    arc: the goal->ground-start segment with a clearance bump over the
    obstacle, 0.45 high at alpha=0.5 and 0 at both ends."""
    k = constants(alpha.device)
    init_pos = k["init_state"][[0, 2]]
    pos = k["goal"] + alpha * (init_pos - k["goal"])
    bump = 0.45 * 4.0 * alpha * (1.0 - alpha)
    return torch.stack([pos[0], pos[1] + bump])


def _spawn(pos) -> Tuple[QuadrotorState, torch.Tensor]:
    zero = torch.zeros_like(pos[0])
    x = torch.stack([pos[0], zero, pos[1], zero, zero, zero])
    return QuadrotorState(x=x, step=0), get_obs(x)


def spawn_at_alpha(alpha, device) -> Tuple[QuadrotorState, torch.Tensor]:
    """A jitter-free reset at ``alpha`` on the curriculum arc (1 is the
    ground start, towards 0 the goal ring)."""
    a = torch.as_tensor(alpha, dtype=torch.float32, device=device)
    return _spawn(_arc_pos(a))


def reset_curriculum(device, i_episode: int, curriculum_episodes: int,
                     gen: Optional[torch.Generator] = None,
                     max_episode_steps: int = SPEC.max_episode_steps,
                     mode: str = "anneal",
                     mix_alpha_min: float = CURRICULUM_ALPHA_MIN,
                     jitter_u: Optional[torch.Tensor] = None,
                     mix_u: Optional[torch.Tensor] = None
                     ) -> Tuple[QuadrotorState, torch.Tensor]:
    """The curriculum reset: alpha = clip(i_episode / curriculum_episodes,
    0.15, 1) anneals the spawn from near the goal back to the ground start,
    with a jitter of (1 - alpha) * U(-0.05, 0.05) per coordinate.

    - "anneal": once the anneal ends, every spawn is the ground start;
    - "mix": after the anneal, every 3rd episode is an exact ground start
      and the others draw alpha ~ U(mix_alpha_min, 1);
    - "mix_early": the ground cadence runs from episode 0, the other
      episodes follow the anneal and then the mixture.

    ``jitter_u`` (2,) and ``mix_u`` () are the standard uniforms of the
    jitter and of the mixture's alpha; each is drawn from ``gen`` when not
    given (``mix_u`` in the mix modes only)."""
    if not (CURRICULUM_ALPHA_MIN <= mix_alpha_min < 1.0):
        raise ValueError(
            f"mix_alpha_min={mix_alpha_min} must lie in "
            f"[{CURRICULUM_ALPHA_MIN}, 1): below the floor the spawn "
            "lands inside the goal ring; at 1 the mixture degenerates "
            "to ground-only (use mode='anneal' for that)")
    if curriculum_episodes <= 0:
        raise ValueError(
            f"curriculum_episodes={curriculum_episodes} must be > 0 "
            "(use reset() for the plain ground spawn)")
    if mode not in CURRICULUM_MODES:
        raise ValueError(f"unknown spawn curriculum mode {mode!r} "
                         "(anneal | mix | mix_early)")
    device = torch.device(device)
    f32 = np.float32
    anneal = f32(np.clip(f32(i_episode) / f32(curriculum_episodes),
                         f32(CURRICULUM_ALPHA_MIN), f32(1.0)))
    alpha = torch.tensor(anneal, device=device)
    if mode != "anneal":
        if mix_u is None:
            mix_u = torch.rand((), generator=gen, device=device)
        mixed = mix_u.to(device) * (1.0 - mix_alpha_min) + mix_alpha_min
        ground = i_episode % MIX_GROUND_INTERVAL == 0
        post = i_episode >= curriculum_episodes
        if ground and (post or mode == "mix_early"):
            alpha = torch.tensor(1.0, device=device)
        elif post:
            alpha = mixed
    if jitter_u is None:
        jitter_u = torch.rand((2,), generator=gen, device=device)
    jitter = (1.0 - alpha) * (jitter_u.to(device) * (2 * CURRICULUM_JITTER)
                              - CURRICULUM_JITTER)
    return _spawn(_arc_pos(alpha) + jitter)


def dynamics(x, u):
    """Continuous-time planar-quadrotor derivative (batched over leading
    dimensions)."""
    t_tot = (u[..., 0] + u[..., 1]) / MASS
    th = x[..., 4]
    return torch.stack([
        x[..., 1], torch.sin(th) * t_tot,
        x[..., 3], torch.cos(th) * t_tot - GRAVITY,
        x[..., 5], ARM * (u[..., 1] - u[..., 0]) / IYY,
    ], dim=-1)


def step(state: QuadrotorState, action, *, barrier_B: float = 0.0,
         barrier_b: float = 0.0,
         max_episode_steps: int = SPEC.max_episode_steps,
         kill_penalty: float = 0.0, kill_attitude: float = 0.0
         ) -> Tuple[QuadrotorState, StepOut]:
    """One Euler step; this env sets its own barrier signals, so
    ``barrier_B``/``barrier_b`` are not read."""
    del barrier_B, barrier_b
    f32 = torch.float32
    x = state.x
    k = constants(x.device)
    lyap_t = _pos(x)

    x_new = x + SPEC.dt * dynamics(x, action)
    step_count = state.step + 1
    pos = _pos(x_new)

    dist = torch.linalg.vector_norm(pos - k["goal"])
    goal_met = dist <= GOAL_SIZE
    reward = -dist + torch.where(goal_met, REWARD_GOAL, 0.0)
    killed = ((torch.abs(x_new[0]) > KILL_X) | (x_new[2] < KILL_Z[0])
              | (x_new[2] > KILL_Z[1]))
    if kill_attitude:
        killed = killed | (torch.abs(x_new[4]) > kill_attitude)
    reward = reward - torch.where(killed, kill_penalty, 0.0)
    done = goal_met | killed | (step_count >= max_episode_steps)

    out_of_range = ((x_new[0] < X_RANGE[0]) | (x_new[0] > X_RANGE[1])
                    | (x_new[2] < Z_RANGE[0]) | (x_new[2] > Z_RANGE[1]))
    out_of_range = out_of_range.to(f32)
    d_obs = torch.linalg.vector_norm(pos - k["obstacle"])
    collision = (d_obs < OBSTACLE_RADIUS).to(f32)

    barrier = (out_of_range * BARRIER_OUT_OF_RANGE
               + collision * BARRIER_COLLISION)
    n_viol = out_of_range + collision
    excess = (torch.clamp(X_RANGE[0] - x_new[0], min=0.0)
              + torch.clamp(x_new[0] - X_RANGE[1], min=0.0)
              + torch.clamp(Z_RANGE[0] - x_new[2], min=0.0)
              + torch.clamp(x_new[2] - Z_RANGE[1], min=0.0))
    cost = (out_of_range * excess
            + collision * (OBSTACLE_RADIUS - d_obs) / OBSTACLE_RADIUS)
    zero = torch.zeros_like(cost)
    out = StepOut(
        obs=get_obs(x_new), reward=reward, constraint=dist, lyap_t=lyap_t,
        lyap_t1=pos, barrier_signal=barrier, done=done, goal_met=goal_met,
        reached=zero, num_violations=n_viol, safety_cost=cost,
        # slot 0 the step's total, then collisions and out-of-range
        viol_breakdown=torch.stack([n_viol, collision, out_of_range, zero]),
        cost_breakdown=torch.stack([cost, zero, zero, zero]),
    )
    return QuadrotorState(x=x_new, step=step_count), out


def obs_to_state(obs):
    """obs == state for this env (6-d)."""
    return obs


def state_to_obs(state):
    return state
