"""The full training state (port of ``nlbac_tpu/agent/state.py``).

Network parameters are dicts of tensors in the JAX layout, each group
bound to its own ``torch.optim.Adam`` (the same bias-corrected update as
``optax.adam``). Temperatures, Lagrangian multipliers and rho are device
tensors. The update counter is a host integer that mirrors the reference's
``ts.updates``: the gates read it without a device round trip.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict

import torch

from nlbac_tpu_torch import resolve_device
from nlbac_tpu_torch.config import NLBACConfig
from nlbac_tpu_torch.constraints import get_builder, init_lagrangian
from nlbac_tpu_torch.constraints.common import LagrangianState
from nlbac_tpu_torch.nn import (
    barrier_init,
    deterministic_policy_init,
    gaussian_policy_init,
    lyapunov_init,
    node_init,
    twin_q_init,
)
from nlbac_tpu_torch.tree import tree_leaves, tree_map

# optimizer group -> the TrainState field it trains
OPT_GROUPS = {
    "policy": "policy", "backup_policy": "backup_policy",
    "critic": "critic", "lyap": "lyap", "barrier": "barrier",
    "node": "node", "alpha": "log_alpha",
    "backup_alpha": "backup_log_alpha",
}


@dataclass
class TrainState:
    policy: Any
    backup_policy: Any
    critic: Any
    critic_target: Any
    lyap: Any
    lyap_target: Any
    barrier: Any
    barrier_target: Any
    node: Any
    log_alpha: torch.Tensor  # (1,)
    backup_log_alpha: torch.Tensor  # (1,)
    opt: Dict[str, torch.optim.Adam]
    lag: LagrangianState
    updates: int


def learning_rates(cfg: NLBACConfig) -> dict:
    """Adam learning rate per group (policy 3e-4, critic/Lyapunov/barrier
    4e-4, NODE 1e-3, temperatures 3e-4 in every preset)."""
    return {
        "policy": cfg.sac.policy_lr, "backup_policy": cfg.sac.policy_lr,
        "critic": cfg.sac.critic_lr, "lyap": cfg.sac.critic_lr,
        "barrier": cfg.sac.critic_lr, "node": cfg.node.lr,
        "alpha": cfg.sac.policy_lr, "backup_alpha": cfg.sac.policy_lr,
    }


def make_optimizers(cfg: NLBACConfig, ts_fields: dict) -> dict:
    """One ``torch.optim.Adam`` per group over the group's parameter
    leaves; ``ts_fields`` maps each TrainState field name to its params."""
    lrs = learning_rates(cfg)
    return {name: torch.optim.Adam(tree_leaves(ts_fields[field]),
                                   lr=lrs[name])
            for name, field in OPT_GROUPS.items()}


def trainable(params):
    """The same tensors as leaves that track gradients."""
    return tree_map(lambda p: p.detach().clone().requires_grad_(True),
                    params)


def create_train_state(cfg: NLBACConfig, gen: torch.Generator,
                       device="cuda") -> TrainState:
    """Random initial state drawn from ``gen`` (on ``device``)."""
    device = resolve_device(device)
    hidden = cfg.sac.hidden_dim
    if cfg.sac.policy_type == "deterministic":
        policy = deterministic_policy_init(gen, cfg.obs_dim, cfg.action_dim,
                                           hidden, device)
        backup_policy = deterministic_policy_init(gen, cfg.obs_dim,
                                                  cfg.action_dim, hidden,
                                                  device)
    else:
        policy = gaussian_policy_init(gen, cfg.obs_dim, cfg.action_dim,
                                      hidden, device)
        backup_policy = gaussian_policy_init(gen, cfg.obs_dim,
                                             cfg.action_dim, hidden, device)
    critic = twin_q_init(gen, cfg.obs_dim, cfg.action_dim, hidden, device)
    lyap = lyapunov_init(gen, cfg.lyap_dim, hidden, device)
    barrier = barrier_init(gen, cfg.obs_dim, cfg.action_dim, hidden, device)
    node = node_init(gen, cfg.node, device)

    builder = get_builder(cfg.constraint.kind)
    lag = init_lagrangian(builder.NUM_PRIMARY, builder.NUM_BACKUP,
                          cfg.constraint.rho_init, device)
    if cfg.sac.policy_type != "deterministic" and cfg.sac.alpha_init <= 0:
        raise ValueError(f"SacConfig.alpha_init must be > 0 for Gaussian "
                         f"policies, got {cfg.sac.alpha_init}")
    if cfg.sac.automatic_entropy_tuning or \
            cfg.sac.policy_type == "deterministic":
        init_log_alpha = 0.0
    else:
        init_log_alpha = math.log(cfg.sac.alpha_init)
    fields = dict(
        policy=trainable(policy), backup_policy=trainable(backup_policy),
        critic=trainable(critic),
        critic_target=tree_map(torch.clone, critic),
        lyap=trainable(lyap), lyap_target=tree_map(torch.clone, lyap),
        barrier=trainable(barrier),
        barrier_target=tree_map(torch.clone, barrier),
        node=trainable(node),
        log_alpha=torch.full((1,), init_log_alpha, device=device,
                             requires_grad=True),
        backup_log_alpha=torch.full((1,), init_log_alpha, device=device,
                                    requires_grad=True),
    )
    return TrainState(**fields, opt=make_optimizers(cfg, fields), lag=lag,
                      updates=0)

