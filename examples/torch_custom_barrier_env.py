#!/usr/bin/env python
"""Add a NEW env with a LEARNED neural barrier certificate (the NBC
family) to the PyTorch port at runtime: the torch version of
examples/custom_barrier_env.py, and the companion of
examples/torch_custom_env.py (the hand-written-CBF path).

What is different from torch_custom_env.py:

1. the env emits the barrier-signal channel: ``barrier_b`` (0) while
   safe, ``barrier_B`` (negative) on a violation, the TD target the
   barrier critic learns from (the episode loop passes the config's
   values to ``step()``);
2. the constraint builder declares ``USES_BARRIER = True``: the agent
   then TD-trains the barrier critic and its target net and passes the
   live ``barrier_params`` and a ``resample`` closure over the current
   policy into ``terms``, whose residual is ``-(B_{t+1} - B_t) -
   gamma_b * B_t`` with B_t detached and B_{t+1} taken at the
   NODE-predicted next obs (the gradient reaches the action through the
   prediction).

The task and dynamics are torch_custom_env.py's (a 2-d point mass, one
hazard disk on the straight path to the goal).

Run from the repo root:
    python examples/torch_custom_barrier_env.py [--cpu] [--seed N]

Training must stay finite and the barrier critic must train (its TD loss
moves off zero); the last line reports the outcome, which depends on the
seed (see ``make_barrier_config``): whether the last 3 episodes reach the
goal (mean reward above 100) and the last 5 carry zero safety cost.
"""
import dataclasses
import os
import sys
import tempfile

import numpy as np
import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_HERE))  # the repo root
sys.path.insert(0, _HERE)  # the sibling example module

from torch_custom_env import PointMassEnv, make_config  # noqa: E402

from nlbac_tpu_torch.constraints import register_builder  # noqa: E402
from nlbac_tpu_torch.envs import register_env  # noqa: E402

# --------------------------------------------------------------------
# 1. The env: the point mass plus the barrier-signal channel
# --------------------------------------------------------------------


class PointMassBarrierEnv:
    """PointMassEnv with barrier signals: b=0 safe, B<0 violated."""

    SPEC = PointMassEnv.SPEC._replace(name="pointmass_nbc")
    reset = PointMassEnv.reset
    obs_to_state = PointMassEnv.obs_to_state
    state_to_obs = PointMassEnv.state_to_obs

    @staticmethod
    def step(state, action, *, barrier_B: float = 0.0,
             barrier_b: float = 0.0, max_episode_steps: int = 150):
        new_state, out = PointMassEnv.step(
            state, action, max_episode_steps=max_episode_steps)
        sig = torch.where(out.num_violations > 0, barrier_B, barrier_b)
        return new_state, out._replace(barrier_signal=sig)


# --------------------------------------------------------------------
# 2. The learned-barrier constraint builder (USES_BARRIER: the agent
#    TD-trains barrier_params on barrier_signal)
# --------------------------------------------------------------------


class PointMassBarrierConstraints:
    NUM_PRIMARY = 2  # 1 learned barrier + 1 CLF
    NUM_BACKUP = 1  # unused (use_backup=False); sizes the lambda vector
    USES_BARRIER = True

    @staticmethod
    def terms(ccfg, ncfg, node_params, field, lyap_params, obs, action,
              lyap_t, dt, barrier_params=None, resample=None,
              include_clf: bool = True, shorts=None, dp_group=None,
              **_):
        from nlbac_tpu_torch.nn import (barrier_apply, lyapunov_apply,
                                        predict_next_state)

        # the obs IS the NODE state here, so predict in obs space
        pred = predict_next_state(ncfg, node_params, obs, action, dt,
                                  field=field, shorts=shorts,
                                  dp_group=dp_group)  # live
        with torch.no_grad():
            b_t = barrier_apply(barrier_params, obs, action)
        # u_{t+1}: the current policy resampled at the prediction; only
        # u_t carries gradient into the residual
        u1 = resample(pred, 0).detach()
        b_t1 = barrier_apply(barrier_params, pred, u1)
        barrier = -(b_t1 - b_t) - ccfg.gamma_b * b_t  # (B, 1)
        if not include_clf:
            return barrier
        l_t = lyapunov_apply(lyap_params, lyap_t).detach()
        l_t1 = lyapunov_apply(lyap_params, pred)
        denom = dt if ccfg.clf_time_scaled else 1.0
        clf = (l_t1 - l_t) / denom + ccfg.gamma_l * l_t  # (B, 1)
        return torch.cat([barrier, clf], dim=1)


# --------------------------------------------------------------------
# 3. Register, configure (the NBC-preset pattern), train
# --------------------------------------------------------------------

def make_barrier_config(max_episodes: int = 80, seed: int = 12):
    """The point-mass config with the learned barrier. The outcome that
    main() reports (goal reached, zero late safety cost) is
    seed-sensitive, and the CPU and the GPU draw different streams from
    one seed. Measured with main() at seeds 0-12: solved at 1 and 12 on
    the CPU (OMP_NUM_THREADS=2) and at 2, 3, 4 and 5 on an NVIDIA H100
    80GB HBM3 at 700 W (at 12 the card reached the goal with a late cost
    of 29.61); the others reached the goal through the hazard or stayed
    safe short of it. The JAX example's checks held at 1 of its seeds
    0-4 (its 0)."""
    cfg = make_config(max_episodes, env_name="pointmass_nbc",
                      kind="pointmass_nbc", seed=seed)
    return dataclasses.replace(
        cfg,
        # the barrier-signal scale: -1 with the contraction gamma_b below
        # (B_{t+1} >= (1 - gamma_b) B_t) and the ratio floor of the
        # nbc_pvtol preset, as in the JAX example
        env=dataclasses.replace(cfg.env, barrier_signals=True,
                                barrier_b=0.0, barrier_B=-1.0),
        constraint=dataclasses.replace(cfg.constraint, gamma_b=0.3,
                                       ratio_floor=0.002),
        run=dataclasses.replace(cfg.run, exp_name="PointMassNBC"))


def register() -> None:
    register_env("pointmass_nbc", PointMassBarrierEnv)
    register_builder("pointmass_nbc", PointMassBarrierConstraints)



def main(argv=None):
    import argparse

    from nlbac_tpu_torch.train.cli import train
    from nlbac_tpu_torch.utils.plot import load_progress

    p = argparse.ArgumentParser(
        description="train the registered point-mass env, learned barrier")
    p.add_argument("--cpu", action="store_true",
                   help="train on the CPU (default: the GPU)")
    p.add_argument("--seed", type=int, default=12)
    args = p.parse_args(argv)
    register()
    device = "cpu" if args.cpu else "cuda"
    out = tempfile.mkdtemp(prefix="nlbac_torch_pointmass_nbc_")
    print(f"training the registered NBC custom env on {device} at seed "
          f"{args.seed} -> {out}")
    train(make_barrier_config(seed=args.seed), output_dir=out, quiet=True,
          device=device)

    cols = load_progress(os.path.join(out, "progress.txt"))
    r = np.asarray(cols["reward_train"])
    v = np.asarray(cols["safety_cost_train"])
    btd = np.asarray(cols["barrier_td_loss"])  # the NBC-only column
    print(f"episode rewards: first 3 {r[:3].round(1).tolist()} "
          f"-> last 3 {r[-3:].round(1).tolist()}")
    print(f"safety cost:     first 10 sum {v[:10].sum():.2f} "
          f"-> last 5 sum {v[-5:].sum():.2f}")
    print(f"barrier TD loss: max {btd.max():.3g} -> final {btd[-1]:.3g}")
    assert np.all(np.isfinite(r)), "training diverged"
    # the barrier critic trained: its TD loss moved off zero
    assert btd.max() > 0, "barrier critic never updated"
    # the task's outcome depends on the seed (make_barrier_config):
    # reported, not asserted
    goal = bool(r[-3:].mean() > 100)
    late_cost = float(v[-5:].sum())
    print(f"outcome: seed={args.seed} device={device} goal_reached={goal} "
          f"late_safety_cost={late_cost:.2f} solved="
          f"{goal and late_cost == 0}")

if __name__ == "__main__":
    main()
