"""Learned neural-barrier-certificate residual builder, the NBC family
(port of ``nlbac_tpu/constraints/learned_barrier.py``). One learned
barrier B(obs, u) replaces the analytic CBFs::

  B_t     = B(obs_t, u_t)                    no gradient
  B_{t+1} = B(obs_hat_{t+1}, u_{t+1})        obs_hat live: the gradient
            reaches u_t through the one-step NODE prediction (the fused
            Euler kernel on the GPU for the control-affine field);
            u_{t+1} resampled at obs_hat, without gradient
  barrier residual = -(B_{t+1} - B_t) - gamma_b B_t

The CLF residual follows the env: the unicycle's predicted lookahead point,
PVTOL's reconstructed 11-d predicted obs (the operator propagated
analytically), the quadrotor's predicted (x, z), and for a host env whose
obs is the NODE state (``identity``) the predicted obs.

Stacked over seeds, obs and action carry a leading (S,) axis, the NODE's
one step is one seed-batched K1 launch for a control-affine field, and
the residuals are (S, B, K).
"""

from __future__ import annotations

import torch

from nlbac_tpu_torch.config import ConstraintConfig, NodeConfig
from nlbac_tpu_torch.constraints.unicycle import _lookahead
from nlbac_tpu_torch.envs import pvtol as pvtol_env
from nlbac_tpu_torch.envs import quadrotor as quad_env
from nlbac_tpu_torch.envs import unicycle as unicycle_env
from nlbac_tpu_torch.nn import barrier_apply, lyapunov_apply
from nlbac_tpu_torch.nn import predict_next_state


def _predict(ncfg, node_params, field, obs, action, dt, env_name, lookahead,
             shorts, dp_group):
    """The live predicted obs and the CLF's input at t+1."""
    if env_name == "unicycle":
        pred = predict_next_state(ncfg, node_params,
                                  unicycle_env.obs_to_state(obs), action, dt,
                                  field=field, shorts=shorts,
                                  dp_group=dp_group)  # (B, 3)
        return (unicycle_env.state_to_obs(pred),
                _lookahead(pred[..., :2], pred[..., 2], lookahead))
    if env_name == "quadrotor":
        pred = predict_next_state(ncfg, node_params,
                                  quad_env.obs_to_state(obs), action, dt,
                                  field=field, shorts=shorts,
                                  dp_group=dp_group)  # (B, 6)
        return quad_env.state_to_obs(pred), pred[..., [0, 2]]
    if env_name == "pvtol":
        state7 = pvtol_env.obs_to_state(obs)
        dyn1 = predict_next_state(ncfg, node_params, state7[..., :6], action,
                                  dt, field=field, shorts=shorts,
                                  dp_group=dp_group)
        op1 = pvtol_env.propagate_operator(state7[..., 6], dyn1[..., 0])
        obs1 = pvtol_env.state_to_obs(torch.cat([dyn1, op1[..., None]],
                                                dim=-1))
        return obs1, obs1
    if env_name == "identity":
        # a host env whose obs IS the NODE state: predict in obs space,
        # and the CLF reads the predicted obs
        pred = predict_next_state(ncfg, node_params, obs, action, dt,
                                  field=field, shorts=shorts,
                                  dp_group=dp_group)
        return pred, pred
    raise ValueError(f"learned_barrier: unsupported env {env_name!r}")


def terms(ccfg: ConstraintConfig, ncfg: NodeConfig, node_params, field,
          lyap_params, obs, action, lyap_t, dt, env_name: str = None,
          barrier_params=None, resample=None, include_clf: bool = True,
          shorts=None, dp_group=None, **_):
    obs1, clf_in_next = _predict(ncfg, node_params, field, obs, action, dt,
                                 env_name, ccfg.lookahead, shorts,
                                 dp_group)
    with torch.no_grad():
        b_t = barrier_apply(barrier_params, obs, action)
    u1 = resample(obs1, 0).detach()
    b_t1 = barrier_apply(barrier_params, obs1, u1)
    barrier = -(b_t1 - b_t) - ccfg.gamma_b * b_t  # (B, 1)
    if not include_clf:
        return barrier

    l_t = lyapunov_apply(lyap_params, lyap_t).detach()
    l_t1 = lyapunov_apply(lyap_params, clf_in_next)
    denom = dt if ccfg.clf_time_scaled else 1.0
    clf = (l_t1 - l_t) / denom + ccfg.gamma_l * l_t
    return torch.cat([barrier, clf], dim=-1)


NUM_PRIMARY = 2  # 1 learned barrier + 1 CLF
# the quadrotor preset trains a backup controller on the barrier column
# (nbc_unicycle and nbc_pvtol train none)
NUM_BACKUP = 1
USES_BARRIER = True  # the agent TD-trains the barrier critic
SEED_AXIS = True  # terms index the last axis: the lockstep runner takes it
