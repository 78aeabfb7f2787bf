"""Critics: twin Q-network, Lyapunov network, barrier network, value
network and Polyak averaging (port of ``nlbac_tpu/nn/critics.py``).

The twin Q-network has two layouts. The plain one, ``{"q1": mlp, "q2":
mlp}``, is the reference's. The stacked one (``twin_q_stack``; the
experimental lever ``experimental.stack_twin_q_state``) holds both nets
as one leaf per layer with a leading k=2 axis, ``{"w": [(2, in, out)],
"b": [(2, out)]}``, and ``twin_q_apply`` runs it as one batched product
per layer.

Stacked over S seeds (the lockstep seed runner, ``parallel/lockstep.py``)
the seed axis comes first in either layout: the plain layout's layers are
(S, in, out) and (S, out) (``nn.mlp``), the stacked layout's (S, 2, in,
out) and (S, 2, out), and ``twin_q_apply`` takes (S, B, .) inputs, as
``jax.vmap`` of the reference's ``twin_q_apply`` does. ``twin_q_stack``
and ``twin_q_unstack`` keep the seed axis in front."""

from __future__ import annotations

import torch

from nlbac_tpu_torch.nn.mlp import mlp_apply, mlp_init
from nlbac_tpu_torch.nn.xla_float import fma_f32
from nlbac_tpu_torch.tree import tree_leaves, where_seeds


def twin_q_init(gen, obs_dim: int, action_dim: int, hidden: int,
                device=None):
    sizes = [obs_dim + action_dim, hidden, hidden, 1]
    return {"q1": mlp_init(gen, sizes, device=device),
            "q2": mlp_init(gen, sizes, device=device)}


def twin_q_apply(params, obs, action):
    """(q1, q2) of either layout (the module's note)."""
    xu = torch.cat([obs, action], dim=-1)
    if "q1" in params:
        return mlp_apply(params["q1"], xu), mlp_apply(params["q2"], xu)
    ws, bs = params["w"], params["b"]
    if ws[0].dim() == 4:
        # stacked over seeds: each seed's (B, in) input shared across its
        # k=2 axis, then one batched product over the S * 2 nets a layer
        x = torch.einsum("sbi,skio->skbo", xu, ws[0]) + bs[0][:, :, None, :]
        seeds_k = x.shape[:2]
        x = x.flatten(0, 1)
        for w, b in zip(ws[1:], bs[1:]):
            x = torch.baddbmm(b.flatten(0, 1)[:, None, :], torch.relu(x),
                              w.flatten(0, 1))
        x = x.unflatten(0, seeds_k)
        return x[:, 0], x[:, 1]
    # the first layer shares the (B, in) input across the k=2 axis
    # without materialising a broadcast copy of it
    x = torch.einsum("bi,kio->kbo", xu, ws[0]) + bs[0][:, None, :]
    for w, b in zip(ws[1:], bs[1:]):
        x = torch.baddbmm(b[:, None, :], torch.relu(x), w)
    return x[0], x[1]


def twin_q_unstack(params):
    """Stacked -> plain ``{'q1','q2'}`` layout (views of the stacked
    leaves; the plain layout is returned as it is)."""
    if "q1" in params:
        return params
    # the k=2 axis is a weight's third axis from the end and a bias's
    # second, behind a seed axis where there is one
    return {f"q{k + 1}": {"w": [w.select(-3, k) for w in params["w"]],
                          "b": [b.select(-2, k) for b in params["b"]]}
            for k in range(2)}


def twin_q_stack(params):
    """Plain ``{'q1','q2'}`` -> stacked layout (new tensors; the stacked
    layout is returned as it is)."""
    if "q1" not in params:
        return params
    q1, q2 = params["q1"], params["q2"]
    return {"w": [torch.stack([w1, w2], dim=-3)
                  for w1, w2 in zip(q1["w"], q2["w"])],
            "b": [torch.stack([b1, b2], dim=-2)
                  for b1, b2 in zip(q1["b"], q2["b"])]}


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
def soft_update(target_params, online_params, tau: float, mask=None):
    """Polyak averaging, target <- (1 - tau) * target + tau * online, in
    place on ``target_params`` (which is returned), rounded as the JAX
    package's jitted update rounds it: ``f32(tau * online)``, then one
    fused multiply-add with ``f32(1 - tau)``. Stacked over seeds, a
    ``mask`` ((S,) bool) averages only its seeds; the others keep their
    targets bit for bit. Every leaf goes through one flat buffer (a seed
    axis kept in front), so that the average costs a few launches."""
    targets = tree_leaves(target_params)
    lead = () if mask is None else (targets[0].shape[0],)
    flat = [t.reshape(lead + (-1,)) for t in targets]
    t = torch.cat(flat, dim=-1)
    o = torch.cat([x.reshape(lead + (-1,))
                   for x in tree_leaves(online_params)], dim=-1)
    new = fma_f32(torch.full_like(t, 1.0 - tau), t, o * tau)
    if mask is not None:
        new = where_seeds(mask, new, t)
    pieces = torch.split(new, [f.shape[-1] for f in flat], dim=-1)
    torch._foreach_copy_(targets, [p.reshape(x.shape)
                                   for p, x in zip(pieces, targets)])
    return target_params
