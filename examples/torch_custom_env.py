#!/usr/bin/env python
"""Add a NEW environment and constraint builder to the PyTorch port
(``nlbac_tpu_torch``) at runtime, without touching the package: the torch
version of examples/custom_env.py.

Three small pieces:

1. an env: ``SPEC`` plus ``reset``/``step`` on tensors returning the
   :class:`nlbac_tpu_torch.envs.base.StepOut` contract, and the
   ``obs_to_state``/``state_to_obs`` NODE-space maps (``register_env``);
2. a CBF/CLF residual builder: ``terms`` plus ``NUM_PRIMARY``/
   ``NUM_BACKUP`` (``register_builder``);
3. an ``NLBACConfig`` wiring dims, gammas and budgets.

The task: a 2-d velocity-controlled point mass must reach a goal ring at
(2, 0) from the origin while a CBF keeps it out of one hazard disk on the
straight path. It trains through the port's episode loop (``train`` of
the CLI module: progress.txt, weights, checkpoints), on the GPU unless
``--cpu`` is given; the control-affine NODE's Euler step runs the CUDA
kernel there.

Run from the repo root:
    python examples/torch_custom_env.py [--cpu] [--seed N]

The last line reports the outcome: whether the last 3 episodes reach the
goal (mean reward above 100) with zero safety cost. Training must stay
finite; the outcome itself depends on the seed (see ``make_config``).
"""
import functools
import os
import sys
import tempfile
from typing import NamedTuple, Tuple

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # the repo root

from nlbac_tpu_torch.constraints import register_builder  # noqa: E402
from nlbac_tpu_torch.envs import register_env  # noqa: E402
from nlbac_tpu_torch.envs.base import EnvSpec, StepOut  # noqa: E402

# --------------------------------------------------------------------
# 1. The env (a class with staticmethods; any object with the contract
#    works, a real project would use a module)
# --------------------------------------------------------------------

DT = 0.05
GOAL = np.array([2.0, 0.0], np.float32)
GOAL_SIZE = 0.2
HAZARD = np.array([1.0, 0.15], np.float32)
HAZARD_RADIUS = 0.35


@functools.lru_cache(maxsize=None)
def constants(device: torch.device) -> dict:
    """GOAL and HAZARD on ``device``, copied once."""
    return {"goal": torch.as_tensor(GOAL, device=device),
            "hazard": torch.as_tensor(HAZARD, device=device)}


class PointState(NamedTuple):
    x: torch.Tensor  # (2,) position
    step: int
    last_goal_dist: torch.Tensor  # f32 scalar


class PointMassEnv:
    """2-d single integrator: x' = x + dt * u, |u_i| <= 1."""

    SPEC = EnvSpec(name="pointmass", obs_dim=2, action_dim=2,
                   state_dim=2, lyap_dim=2, dt=DT, max_episode_steps=150,
                   action_low=(-1.0, -1.0), action_high=(1.0, 1.0))

    @staticmethod
    def reset(device, gen=None, max_episode_steps: int = 150
              ) -> Tuple[PointState, torch.Tensor]:
        del gen  # deterministic spawn at the origin
        k = constants(torch.device(device))
        x = torch.zeros(2, device=device)
        st = PointState(x=x, step=0,
                        last_goal_dist=torch.linalg.vector_norm(k["goal"]))
        return st, x

    @staticmethod
    def step(state: PointState, action, *, barrier_B: float = 0.0,
             barrier_b: float = 0.0, max_episode_steps: int = 150
             ) -> Tuple[PointState, StepOut]:
        del barrier_B, barrier_b  # no learned-barrier signal in this env
        k = constants(state.x.device)
        x_new = state.x + DT * action
        step_count = state.step + 1

        dist_goal = torch.linalg.vector_norm(k["goal"] - x_new)
        reward = ((state.last_goal_dist - dist_goal) * 10.0
                  - 0.01 * torch.sum(torch.square(action)))
        goal_met = dist_goal <= GOAL_SIZE
        reward = reward + torch.where(goal_met, 100.0, 0.0)
        done = goal_met | (step_count >= max_episode_steps)

        d = torch.linalg.vector_norm(x_new - k["hazard"])
        violated = (d < HAZARD_RADIUS).to(torch.float32)
        cost = violated * (HAZARD_RADIUS - d) / HAZARD_RADIUS
        zero = torch.zeros((), device=x_new.device)
        out = StepOut(
            obs=x_new, reward=reward, constraint=dist_goal,
            lyap_t=state.x, lyap_t1=x_new, barrier_signal=zero,
            done=done, goal_met=goal_met, reached=zero,
            num_violations=violated, safety_cost=cost,
            viol_breakdown=torch.stack([violated, zero, zero, zero]),
            cost_breakdown=torch.stack([cost, zero, zero, zero]))
        return PointState(x=x_new, step=step_count,
                          last_goal_dist=dist_goal), out

    @staticmethod
    def obs_to_state(obs):
        return obs  # the obs IS the NODE state

    @staticmethod
    def state_to_obs(state):
        return state


# --------------------------------------------------------------------
# 2. The constraint builder: 1 distance CBF + 1 CLF on the NODE's
#    one-step predicted position
# --------------------------------------------------------------------

class PointMassConstraints:
    NUM_PRIMARY = 2  # 1 CBF + 1 CLF
    NUM_BACKUP = 1  # unused (use_backup=False); sizes the lambda vector

    @staticmethod
    def terms(ccfg, ncfg, node_params, field, lyap_params, obs, action,
              lyap_t, dt, include_clf: bool = True, shorts=None,
              dp_group=None, **_):
        from nlbac_tpu_torch.nn import lyapunov_apply, predict_next_state

        hazard = constants(obs.device)["hazard"]
        pred = predict_next_state(ncfg, node_params, obs, action, dt,
                                  field=field, shorts=shorts,
                                  dp_group=dp_group)  # (B, 2)
        r = ccfg.collision_buffer * HAZARD_RADIUS

        def h(q):
            return 0.5 * (torch.sum(torch.square(q - hazard), dim=-1,
                                    keepdim=True) - r ** 2)

        cbf = -((h(pred) - h(obs)) / dt) - ccfg.gamma_b * h(obs)  # (B, 1)
        if not include_clf:
            return cbf
        l_t = lyapunov_apply(lyap_params, lyap_t).detach()
        l_t1 = lyapunov_apply(lyap_params, pred)
        denom = dt if ccfg.clf_time_scaled else 1.0
        clf = (l_t1 - l_t) / denom + ccfg.gamma_l * l_t  # (B, 1)
        return torch.cat([cbf, clf], dim=1)


# --------------------------------------------------------------------
# 3. Register, configure, train
# --------------------------------------------------------------------

def make_config(max_episodes: int = 25, env_name: str = "pointmass",
                kind: str = "pointmass", seed: int = 2):
    """The point-mass config. The outcome that main() reports (goal
    reached, zero late violations) is seed-sensitive, and the CPU and the
    GPU draw different streams from one seed. Measured with main() at
    seeds 0-7: solved at 2, 3, 4 and 5 on the CPU (OMP_NUM_THREADS=2) and
    at 2, 4 and 6 on an NVIDIA H100 80GB HBM3 at 700 W; the JAX example's
    checks held at its 0, 1 and 2 of 0-4."""
    from nlbac_tpu_torch.config import (ConstraintConfig, EnvConfig,
                                        NLBACConfig, NodeConfig,
                                        ReplayConfig, RunConfig, SacConfig,
                                        SupervisorConfig)
    return NLBACConfig(
        env=EnvConfig(name=env_name, dt=DT, max_episode_steps=150),
        sac=SacConfig(hidden_dim=64, batch_size=64, start_steps=300,
                      updates_per_step=1),
        node=NodeConfig(form="control_affine", state_dim=2, action_dim=2,
                        hidden_dim=32, f_hidden_layers=1,
                        g_hidden_layers=1, update_interval=10,
                        max_batch=4096),
        constraint=ConstraintConfig(kind=kind, gamma_b=5.0, gamma_l=1.0,
                                    clf_time_scaled=True, use_ratio=True,
                                    use_backup=False,
                                    # enforce at 1.4x the hazard radius
                                    collision_buffer=1.4, rho_init=5.0),
        supervisor=SupervisorConfig(kind="none"),
        replay=ReplayConfig(capacity=8192, node_capacity=8192),
        run=RunConfig(seed=seed, max_episodes=max_episodes,
                      exp_name="PointMass"),
        obs_dim=2, action_dim=2, lyap_dim=2,
    )


def register() -> None:
    register_env("pointmass", PointMassEnv)
    register_builder("pointmass", PointMassConstraints)



def main(argv=None):
    import argparse

    from nlbac_tpu_torch.train.cli import train
    from nlbac_tpu_torch.utils.plot import load_progress

    p = argparse.ArgumentParser(
        description="train the registered point-mass env, hand-written CBF")
    p.add_argument("--cpu", action="store_true",
                   help="train on the CPU (default: the GPU)")
    p.add_argument("--seed", type=int, default=2)
    args = p.parse_args(argv)
    register()
    device = "cpu" if args.cpu else "cuda"
    out = tempfile.mkdtemp(prefix="nlbac_torch_pointmass_")
    print(f"training the registered custom env on {device} at seed "
          f"{args.seed} -> {out}")
    train(make_config(seed=args.seed), output_dir=out, quiet=True,
          device=device)

    cols = load_progress(os.path.join(out, "progress.txt"))
    r = np.asarray(cols["reward_train"])
    v = np.asarray(cols["safety_cost_train"])
    print(f"episode rewards: first 3 {r[:3].round(1).tolist()} "
          f"-> last 3 {r[-3:].round(1).tolist()}")
    print(f"safety cost:     first 3 {v[:3].round(2).tolist()} "
          f"-> last 3 {v[-3:].round(2).tolist()}")
    assert np.all(np.isfinite(r)), "training diverged"
    # the task's outcome depends on the seed (make_config): reported,
    # not asserted
    goal = bool(r[-3:].mean() > 100)
    late_cost = float(v[-3:].sum())
    print(f"outcome: seed={args.seed} device={device} goal_reached={goal} "
          f"late_safety_cost={late_cost:.2f} solved="
          f"{goal and late_cost == 0}")

if __name__ == "__main__":
    main()
