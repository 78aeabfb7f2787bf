"""Simulated-cars HOCBF/CLF residual builder, 2-step NODE horizon,
relative-degree-2 composition (port of ``nlbac_tpu/constraints/cars.py``).

The NODE is the non-affine time-input form; the chain is::

  x_{t+1} = NODE(x_t, u_t, t);  u_{t+1} = policy(obs(x_{t+1})) DETACHED
  x_{t+2} = NODE(x_{t+1}, u_{t+1}, t+dt)

Gap barriers h23 = x3 - x4 - 4.5, h34 = x4 - x5 - 4.5 at the three
horizons, composed as relative-degree-2 HOCBFs::

  l1 = h_{t+1} - h_t + gamma_b h_t
  l2 = h_{t+2} - h_{t+1} + gamma_b h_{t+1}
  cbf = -(l2 - l1) - gamma_b l1

CLF: L on [x3, v3, x4, v4] of the prediction, residual
(L_{t+1} - L_t) + gamma_l L_t (not dt-scaled in the preset).

Stacked over seeds, obs and action carry a leading (S,) axis and the
residuals are (S, B, K).
"""

from __future__ import annotations

import torch

from nlbac_tpu_torch.config import ConstraintConfig, NodeConfig
from nlbac_tpu_torch.envs import cars as env
from nlbac_tpu_torch.nn import lyapunov_apply, predict_next_state

COLLISION_RADIUS = 4.5


def _gaps(x):
    """(..., B, 10) states -> (h23, h34), each (..., B, 1)."""
    h23 = (x[..., 4] - x[..., 6] - COLLISION_RADIUS)[..., None]
    h34 = (x[..., 6] - x[..., 8] - COLLISION_RADIUS)[..., None]
    return h23, h34


def terms(ccfg: ConstraintConfig, ncfg: NodeConfig, node_params, field,
          lyap_params, obs, action, lyap_t, dt, t=None, next_t=None,
          resample=None, include_clf: bool = True, shorts=None,
          dp_group=None, **_):
    """``resample(obs_batch, k) -> action_batch`` draws the chain's k-th
    control from the controller being optimized (k = 0 here)."""
    if ccfg.horizon != 2:
        raise ValueError(
            f"cars HOCBF builder requires horizon=2 (rel-degree-2 "
            f"composition); got {ccfg.horizon}")
    x0 = env.obs_to_state(obs)  # (B, 10)
    x1 = predict_next_state(ncfg, node_params, x0, action, dt, t=t,
                            field=field, shorts=shorts,
                            dp_group=dp_group)
    # only u_t carries gradient: the detach on u1 prunes every path
    # through the resample, obs1 included
    u1 = resample(env.state_to_obs(x1), 0).detach()
    x2 = predict_next_state(ncfg, node_params, x1, u1, dt, t=next_t,
                            field=field, shorts=shorts,
                            dp_group=dp_group)

    h23_0, h34_0 = _gaps(x0)
    h23_1, h34_1 = _gaps(x1)
    h23_2, h34_2 = _gaps(x2)

    def hocbf(h0, h1, h2):
        l1 = h1 - h0 + ccfg.gamma_b * h0
        l2 = h2 - h1 + ccfg.gamma_b * h1
        return -(l2 - l1) - ccfg.gamma_b * l1

    cbf = torch.cat([hocbf(h23_0, h23_1, h23_2),
                     hocbf(h34_0, h34_1, h34_2)], dim=-1)
    if not include_clf:
        return cbf

    l_t = lyapunov_apply(lyap_params, lyap_t).detach()
    l_t1 = lyapunov_apply(lyap_params, x1[..., 4:8])  # [x3, v3, x4, v4]
    denom = dt if ccfg.clf_time_scaled else 1.0
    clf = (l_t1 - l_t) / denom + ccfg.gamma_l * l_t
    return torch.cat([cbf, clf], dim=-1)


NUM_PRIMARY = 3  # 2 HOCBFs + 1 CLF
NUM_BACKUP = 2
SEED_AXIS = True  # terms index the last axis: the lockstep runner takes it
