"""Carry a training state across between the JAX package and the port.

``from_reference`` takes the reference's ``TrainState`` as a pytree of
numpy arrays (``jax.tree.map(np.asarray, ts)``) and returns the port's
``TrainState`` with the same weights, every Adam ``mu``/``nu``/``count``,
the Lagrangian state and the update counter. ``to_reference`` goes back,
filling a template of that pytree so that the result has the reference's
structure leaf for leaf. Neither imports JAX: the template's own
NamedTuple types rebuild the optimizer states.
"""

from __future__ import annotations

import numpy as np
import torch

from nlbac_tpu_torch import resolve_device
from nlbac_tpu_torch.agent.state import (
    OPT_GROUPS,
    TrainState,
    make_optimizers,
)
from nlbac_tpu_torch.config import NLBACConfig
from nlbac_tpu_torch.constraints.common import LagrangianState
from nlbac_tpu_torch.tree import tree_leaves

TRAINED = ("policy", "backup_policy", "critic", "lyap", "barrier", "node",
           "log_alpha", "backup_log_alpha")
TARGETS = ("critic_target", "lyap_target", "barrier_target")


def _tensor(a, device, requires_grad=False) -> torch.Tensor:
    t = torch.tensor(np.asarray(a, np.float32), device=device)
    return t.requires_grad_(requires_grad)


def _to_tree(tree, device, requires_grad=False):
    """Numpy pytree of dicts/lists -> the same structure of tensors."""
    if isinstance(tree, dict):
        return {k: _to_tree(v, device, requires_grad) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_tree(v, device, requires_grad) for v in tree]
    return _tensor(tree, device, requires_grad)


def _like(template, tree):
    """Tensor tree -> numpy arrays in ``template``'s structure."""
    if isinstance(template, dict):
        return {k: _like(template[k], tree[k]) for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_like(t, s) for t, s in zip(template, tree))
    return tree.detach().cpu().numpy().astype(np.asarray(template).dtype)


def _fill(template, leaves):
    """Numpy copies of the tensors ``leaves`` (in ``tree_leaves`` order) in
    ``template``'s structure."""
    if isinstance(template, dict):
        filled = {k: _fill(template[k], leaves) for k in sorted(template)}
        return {k: filled[k] for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_fill(t, leaves) for t in template)
    return next(leaves).detach().cpu().numpy().astype(
        np.asarray(template).dtype)


def from_reference(ref, cfg: NLBACConfig, device="cuda") -> TrainState:
    """The reference's numpy ``TrainState`` -> the port's, on ``device``."""
    device = resolve_device(device)
    fields = {name: _to_tree(getattr(ref, name), device, requires_grad=True)
              for name in TRAINED}
    fields.update({name: _to_tree(getattr(ref, name), device)
                   for name in TARGETS})
    opts = make_optimizers(cfg, fields)
    for group, field in OPT_GROUPS.items():
        adam = ref.opt[group][0]  # (ScaleByAdamState, EmptyState)
        count = float(np.asarray(adam.count))
        params = tree_leaves(fields[field])
        mus = tree_leaves(adam.mu)
        nus = tree_leaves(adam.nu)
        if not len(params) == len(mus) == len(nus):
            raise ValueError(f"optimizer state of {group!r} does not match "
                             f"its parameters")
        for p, mu, nu in zip(params, mus, nus):
            opts[group].state[p] = {
                "step": torch.tensor(count, dtype=torch.float32),
                "exp_avg": _tensor(mu, device),
                "exp_avg_sq": _tensor(nu, device),
            }
    lag = LagrangianState(*(_tensor(getattr(ref.lag, f), device)
                            for f in LagrangianState._fields))
    return TrainState(**fields, opt=opts, lag=lag,
                      updates=int(np.asarray(ref.updates)))


def to_reference(ts: TrainState, template):
    """The port's ``TrainState`` -> a numpy pytree with ``template``'s
    structure (a numpy copy of a reference ``TrainState``)."""
    out = {name: _like(getattr(template, name), getattr(ts, name))
           for name in TRAINED + TARGETS}
    opt = {}
    for group, field in OPT_GROUPS.items():
        adam, rest = template.opt[group][0], template.opt[group][1:]
        params = tree_leaves(getattr(ts, field))
        state = ts.opt[group].state

        def moment(key):
            return [state[p][key] if p in state else torch.zeros_like(p)
                    for p in params]

        steps = [int(state[p]["step"]) for p in params if p in state]
        count = steps[0] if steps else 0
        opt[group] = (adam._replace(
            count=np.asarray(count, np.asarray(adam.count).dtype),
            mu=_fill(adam.mu, iter(moment("exp_avg"))),
            nu=_fill(adam.nu, iter(moment("exp_avg_sq")))),) + tuple(rest)
    lag = template.lag._replace(**{
        f: getattr(ts.lag, f).detach().cpu().numpy().astype(np.float32)
        for f in LagrangianState._fields})
    return template._replace(
        **out, opt=opt, lag=lag,
        updates=np.asarray(ts.updates, np.asarray(template.updates).dtype))
