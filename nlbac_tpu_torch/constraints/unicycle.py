"""Unicycle CBF/CLF residual builder, 1-step NODE horizon (port of
``nlbac_tpu/constraints/unicycle.py``).

- CLF: (L(p_hat_{t+1}) - L(p_t)) / dt + gamma_l * L(p_t), L(p_t) detached
- CBF_i: -(h_i(p_hat_{t+1}) - h_i(p_t)) / dt - gamma_b * h_i(p_t) with
  h_i(p) = 1/2 (||p - o_i||^2 - (1.05 r)^2), 7 hazards

The gradient reaches the action through the one-step NODE prediction,
which runs the fused Euler kernel on the GPU.
"""

from __future__ import annotations

import torch

from nlbac_tpu_torch.config import ConstraintConfig, NodeConfig
from nlbac_tpu_torch.envs import unicycle as env
from nlbac_tpu_torch.nn import lyapunov_apply, predict_next_state


def _lookahead(xy, theta, l_p):
    return xy + l_p * torch.stack([torch.cos(theta), torch.sin(theta)],
                                  dim=-1)


def _h(ps, collision_radius):
    """(B,2) lookahead points -> (B, 7) barrier values."""
    hazards = env.constants(ps.device)["hazards"]
    d2 = torch.sum(torch.square(ps[:, None, :] - hazards[None, :, :]),
                   dim=2)
    return 0.5 * (d2 - collision_radius ** 2)


def terms(ccfg: ConstraintConfig, ncfg: NodeConfig, node_params, field,
          lyap_params, obs, action, lyap_t, gen, dt,
          include_clf: bool = True, **_):
    state = env.obs_to_state(obs)  # (B, 3)
    l_p = ccfg.lookahead
    collision_radius = ccfg.collision_buffer * env.HAZARD_RADIUS

    ps = _lookahead(state[:, :2], state[:, 2], l_p)
    pred = predict_next_state(ncfg, node_params, state, action, dt,
                              field=field)  # (B, 3)
    ps_next = _lookahead(pred[:, :2], pred[:, 2], l_p)

    hs = _h(ps, collision_radius)
    hs_next = _h(ps_next, collision_radius)
    cbf = -((hs_next - hs) / dt) - ccfg.gamma_b * hs  # (B, 7)

    if not include_clf:
        return cbf

    l_t = lyapunov_apply(lyap_params, lyap_t).detach()
    l_t1 = lyapunov_apply(lyap_params, ps_next)
    denom = dt if ccfg.clf_time_scaled else 1.0
    clf = (l_t1 - l_t) / denom + ccfg.gamma_l * l_t  # (B, 1)
    return torch.cat([cbf, clf], dim=1)


NUM_PRIMARY = 8  # 7 CBFs + 1 CLF
NUM_BACKUP = 7
