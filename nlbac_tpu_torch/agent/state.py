"""The full training state (port of ``nlbac_tpu/agent/state.py``).

Network parameters are dicts of tensors in the JAX layout, each group
bound to its own ``torch.optim.Adam`` (the same bias-corrected update as
``optax.adam``). Temperatures, Lagrangian multipliers and rho are device
tensors. The update counter is a host integer that mirrors the reference's
``ts.updates``: the gates read it without a device round trip.

A state stacked over seeds (``stack_states``; the lockstep seed runner,
``parallel/lockstep.py``) is the same ``TrainState`` with a leading (S,)
axis on every tensor, a ``SeedAdam`` per optimizer group (per-seed step
counts and a mask) and ``updates`` a list of per-seed host integers;
``unstack_state`` gives one seed's ``TrainState`` back. The critic may be
in either twin-Q layout (``nn.critics``), the same for every seed.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Union

import torch

from nlbac_tpu_torch import resolve_device
from nlbac_tpu_torch.config import NLBACConfig
from nlbac_tpu_torch.constraints import get_builder, init_lagrangian
from nlbac_tpu_torch.constraints.common import LagrangianState
from nlbac_tpu_torch.nn.adam import SeedAdam
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
    opt: Dict[str, Union[torch.optim.Adam, SeedAdam]]
    lag: LagrangianState
    updates: Union[int, List[int]]  # a list: stacked over seeds

    @property
    def seeds(self):
        """The number of seeds of a stacked state; None for one seed."""
        return len(self.updates) if isinstance(self.updates, list) else None


def learning_rates(cfg: NLBACConfig) -> dict:
    """Adam learning rate per group (policy 3e-4, critic/Lyapunov/barrier
    4e-4, NODE 1e-3, temperatures 3e-4 in every preset)."""
    return {
        "policy": cfg.sac.policy_lr, "backup_policy": cfg.sac.policy_lr,
        "critic": cfg.sac.critic_lr, "lyap": cfg.sac.critic_lr,
        "barrier": cfg.sac.critic_lr, "node": cfg.node.lr,
        "alpha": cfg.sac.policy_lr, "backup_alpha": cfg.sac.policy_lr,
    }


def make_optimizer(cfg: NLBACConfig, group: str, params
                   ) -> torch.optim.Adam:
    """A fresh ``torch.optim.Adam`` of optimizer group ``group`` over
    ``params``' leaves (a group whose leaves are replaced, as the stacked
    twin-Q layout replaces the critic's, takes a new one)."""
    return torch.optim.Adam(tree_leaves(params),
                            lr=learning_rates(cfg)[group])


def make_optimizers(cfg: NLBACConfig, ts_fields: dict) -> dict:
    """One ``torch.optim.Adam`` per group over the group's parameter
    leaves; ``ts_fields`` maps each TrainState field name to its params."""
    return {name: make_optimizer(cfg, name, ts_fields[field])
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



# the TrainState fields that hold parameter trees, trained or targets
PARAM_FIELDS = ("policy", "backup_policy", "critic", "critic_target",
                "lyap", "lyap_target", "barrier", "barrier_target", "node",
                "log_alpha", "backup_log_alpha")


def stack_states(cfg: NLBACConfig, states: Sequence[TrainState]
                 ) -> TrainState:
    """One state stacked over seeds from one-seed states (copies), seed i
    from ``states[i]``: every tensor on a leading seed axis, each
    optimizer group a ``SeedAdam`` holding each seed's moments and step
    count. The critic may be in either twin-Q layout (``nn.critics``),
    the same for every seed: a stacked layout's leaves become (S, 2, in,
    out) and (S, 2, out)."""
    if any(ts.seeds is not None for ts in states):
        raise ValueError("stack_states takes one-seed states")
    if len({"q1" in ts.critic for ts in states}) > 1:
        raise ValueError(
            "the seeds' critics are in different twin-Q layouts (plain "
            "and stacked); stack_states takes one layout for every seed")
    fields = {}
    for name in PARAM_FIELDS:
        trained = any(name == f for f in OPT_GROUPS.values())
        fields[name] = tree_map(
            lambda *ps: torch.stack([p.detach() for p in ps]
                                    ).requires_grad_(trained),
            *[getattr(ts, name) for ts in states])
    lrs = learning_rates(cfg)
    opt = {}
    for group, field in OPT_GROUPS.items():
        adam = SeedAdam(tree_leaves(fields[field]), lrs[group])
        for i, ts in enumerate(states):
            state = ts.opt[group].state
            leaves = tree_leaves(getattr(ts, field))
            if leaves[0] not in state:
                continue  # a fresh optimizer: zero moments, step 0
            adam.load_seed(i, int(state[leaves[0]]["step"]),
                           [state[p]["exp_avg"] for p in leaves],
                           [state[p]["exp_avg_sq"] for p in leaves])
        opt[group] = adam
    lag = LagrangianState(*(torch.stack([getattr(ts.lag, f) for ts in states])
                            for f in LagrangianState._fields))
    return TrainState(**fields, opt=opt, lag=lag,
                      updates=[ts.updates for ts in states])


def unstack_state(cfg: NLBACConfig, ts: TrainState, i: int) -> TrainState:
    """Seed i of a stacked state as a plain one-seed ``TrainState``
    (copies), its critic in the twin-Q layout it was stacked in, with
    ``torch.optim.Adam`` groups (``make_optimizer`` over its leaves, as
    ``experimental.stack_twin_q_state`` makes the stacked layout's)
    holding its moments and step count: evaluation, export and
    ``save_model_weights`` take it as they take any state."""
    fields = {}
    for name in PARAM_FIELDS:
        trained = any(name == f for f in OPT_GROUPS.values())
        fields[name] = tree_map(
            lambda p: p[i].detach().clone().requires_grad_(trained),
            getattr(ts, name))
    opt = make_optimizers(cfg, fields)
    for group, field in OPT_GROUPS.items():
        adam = ts.opt[group]
        step = int(adam.step_count[i])
        if step == 0:
            continue  # as a fresh torch.optim.Adam holds no state
        mus, nus = adam.moments()
        for p, mu, nu in zip(tree_leaves(fields[field]), mus, nus):
            opt[group].state[p] = {
                "step": torch.tensor(float(step), dtype=torch.float32),
                "exp_avg": mu[i].clone(), "exp_avg_sq": nu[i].clone()}
    lag = LagrangianState(*(t[i].clone() for t in ts.lag))
    return TrainState(**fields, opt=opt, lag=lag, updates=ts.updates[i])
