"""PVTOL HOCBF/CLF residual builder, 3-step NODE horizon,
relative-degree-3 composition with the operator propagated analytically
(port of ``nlbac_tpu/constraints/pvtol.py``).

The chain::

  x_{t+k+1} = NODE(x_{t+k}, u_{t+k});  op_{t+k+1} = op + 0.7 (x - op)
  u_{t+k} = controller(obs(x_{t+k}, op_{t+k})) DETACHED for k >= 1

Each NODE step is the control-affine Euler step, which runs the fused
kernel on the GPU; the gradient reaches u_t through all three steps
(with respect to x on the second and third). Nine CBFs at four horizons
composed as relative-degree-3 HOCBFs::

  term1 = h3 - h2 + g h2;  term2 = h2 - h1 + g h1;  term3 = h1 - h0 + g h0
  cbf = -(term1 - term2 + g term2 - (term2 - term3 + g term3)
          + g (term2 - term3 + g term3))

h families: 5 obstacle circles (1/2(||y-o||^2 - (1.2 r)^2)), two operator
distance half-planes with margin 0.9*operator_dist, and the y_max/y_min
box with delta 10. CLF: L on the 11-d obs of the 1-step prediction,
residual (L1 - L0) + gamma_l L0.

Stacked over seeds, obs and action carry a leading (S,) axis, each NODE
step is one seed-batched K1 launch and the residuals are (S, B, K).
"""

from __future__ import annotations

import torch

from nlbac_tpu_torch.config import ConstraintConfig, NodeConfig
from nlbac_tpu_torch.envs import pvtol as env
from nlbac_tpu_torch.nn import lyapunov_apply, predict_next_state


def _chain(ncfg, node_params, field, state7, action, dt, resample,
           horizon: int, shorts=None, dp_group=None):
    """Roll the NODE ``horizon`` steps, propagating the operator and
    resampling the controller (detached) at the predicted observations;
    ``resample(obs, k)`` draws the chain's k-th resampled control.

    Returns the full 7-d states [s_t, s_{t+1}, ..., s_{t+horizon}]."""
    states = [state7]
    dyn = state7[..., :6]  # obs_to_dynamics_state
    op = state7[..., 6]
    u = action
    for k in range(horizon):
        dyn = predict_next_state(ncfg, node_params, dyn, u, dt, field=field,
                                 shorts=shorts, dp_group=dp_group)
        op = env.propagate_operator(op, dyn[..., 0])
        s = torch.cat([dyn, op[..., None]], dim=-1)
        states.append(s)
        if k + 1 < horizon:
            # only u_t carries gradient: the detach prunes every path
            # through the resample
            u = resample(env.state_to_obs(s), k).detach()
    return states


def _hocbf3(hs, gamma_b):
    """hs: 4 tensors (B, m) at horizons t..t+3 -> (B, m)."""
    h0, h1, h2, h3 = hs
    term1 = h3 - h2 + gamma_b * h2
    term2 = h2 - h1 + gamma_b * h1
    term3 = h1 - h0 + gamma_b * h0
    inner = term2 - term3 + gamma_b * term3
    return -(term1 - term2 + gamma_b * term2 - inner + gamma_b * inner)


def terms(ccfg: ConstraintConfig, ncfg: NodeConfig, node_params, field,
          lyap_params, obs, action, lyap_t, dt, resample=None,
          include_clf: bool = True, shorts=None, dp_group=None, **_):
    if ccfg.horizon != 3:
        raise ValueError(
            f"pvtol HOCBF builder requires horizon=3 (rel-degree-3 "
            f"composition); got {ccfg.horizon}")
    states = _chain(ncfg, node_params, field, env.obs_to_state(obs), action,
                    dt, resample, horizon=ccfg.horizon, shorts=shorts,
                    dp_group=dp_group)

    collision_radius = ccfg.collision_buffer * env.HAZARD_RADIUS
    op_margin = ccfg.operator_margin * env.OPERATOR_DIST
    dy = ccfg.box_delta_y

    # one h-family pass over the 4 horizon states (4, B, 7); columns
    # [5 obstacles, op1, op2, ymax, ymin]
    s_all = torch.stack(states)
    hazards = env.constants(obs.device)["hazards"]
    d2 = torch.sum(torch.square(s_all[..., None, :2]
                                - hazards), dim=-1)
    h_obs = 0.5 * (d2 - collision_radius ** 2)  # (4, B, 5)
    h_op1 = (s_all[..., 0] - s_all[..., 6] + op_margin)[..., None]
    h_op2 = (s_all[..., 6] - s_all[..., 0] + op_margin)[..., None]
    h_ymax = (-s_all[..., 1] + env.Y_MAX - dy)[..., None]
    h_ymin = (s_all[..., 1] - env.Y_MIN - dy)[..., None]
    h = torch.cat([h_obs, h_op1, h_op2, h_ymax, h_ymin], dim=-1)
    cbf = _hocbf3([h[0], h[1], h[2], h[3]], ccfg.gamma_b)  # (B, 9)
    if not include_clf:
        return cbf

    l_t = lyapunov_apply(lyap_params, lyap_t).detach()
    l_t1 = lyapunov_apply(lyap_params, env.state_to_obs(states[1]))
    denom = dt if ccfg.clf_time_scaled else 1.0
    clf = (l_t1 - l_t) / denom + ccfg.gamma_l * l_t
    return torch.cat([cbf, clf], dim=-1)


NUM_PRIMARY = 10  # 5 obstacle + 2 operator + 2 box HOCBFs + 1 CLF
NUM_BACKUP = 9
SEED_AXIS = True  # terms index the last axis: the lockstep runner takes it
