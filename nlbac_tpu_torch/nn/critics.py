"""Critics: twin Q-network, Lyapunov network, barrier network, value
network and Polyak averaging (port of ``nlbac_tpu/nn/critics.py``)."""

from __future__ import annotations

import torch

from nlbac_tpu_torch.nn.mlp import mlp_apply, mlp_init
from nlbac_tpu_torch.tree import tree_leaves


def twin_q_init(gen, obs_dim: int, action_dim: int, hidden: int,
                device=None):
    sizes = [obs_dim + action_dim, hidden, hidden, 1]
    return {"q1": mlp_init(gen, sizes, device=device),
            "q2": mlp_init(gen, sizes, device=device)}


def twin_q_apply(params, obs, action):
    xu = torch.cat([obs, action], dim=-1)
    return mlp_apply(params["q1"], xu), mlp_apply(params["q2"], xu)


def value_init(gen, obs_dim: int, hidden: int, device=None):
    return mlp_init(gen, [obs_dim, hidden, hidden, 1], device=device)


def value_apply(params, obs):
    return mlp_apply(params, obs)


def lyapunov_init(gen, in_dim: int, hidden: int, device=None):
    return mlp_init(gen, [in_dim, hidden, hidden, 1], device=device)


def lyapunov_apply(params, x):
    return mlp_apply(params, x)


def barrier_init(gen, obs_dim: int, action_dim: int, hidden: int,
                 device=None):
    return mlp_init(gen, [obs_dim + action_dim, hidden, hidden, 1],
                    device=device)


def barrier_apply(params, obs, action):
    return mlp_apply(params, torch.cat([obs, action], dim=-1))


@torch.no_grad()
def soft_update(target_params, online_params, tau: float):
    """Polyak averaging, target <- (1 - tau) * target + tau * online, in
    place on ``target_params`` (which is returned)."""
    targets = tree_leaves(target_params)
    torch._foreach_mul_(targets, 1.0 - tau)
    torch._foreach_add_(targets, tree_leaves(online_params), alpha=tau)
    return target_params
