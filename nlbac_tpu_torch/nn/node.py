"""Neural-ODE vector fields and the one-step dynamics fit (port of
``nlbac_tpu/nn/node.py``).

- ``control_affine``: dx/dt = f(x) + g(x) u with two MLPs of width 100.
- ``mlp``: non-affine dx/dt = F(x, u[, t]), one MLP over the packed input.

The integration state is ``concat(x, u[, t])`` and the field returns zeros
in the control (and time) slots (zero-order-hold control). For the
control-affine field under one float32 Euler step (``uses_euler_kernel``),
``predict_next_state`` goes through the fused kernel
``ops.node_kernel.node_euler_step``, except when the nets are cut across a
tensor-parallel group (``--tp``): the kernel computes all nine layers from
whole weight matrices in one launch, so a tp rank's field runs through
the plain layers of ``mlp_apply`` with their collectives between them. A
``compute_dtype='bfloat16'`` field takes one Euler step of the plain field
in bf16, as the JAX package's runs through XLA (the kernel computes
float32 only). Under ``solver='dopri5'`` it runs the adaptive solver on
the plain field (the ``scan`` form differentiated by autograd, the
``while`` form through the adjoint), with the error norm over the whole
batch of a data-parallel group (``dp_group``) and, given a ``shorts``
list, appends to it on the device whether each integration ended short
of its span.

Stacked over seeds (every leaf with a leading seed axis, x (S, B, n_s)),
the control-affine Euler step is one seed-batched K1 launch, chained
calls included; the plain fields (the ``mlp`` field with its time input
or normalization, a bf16 or multi-step control-affine field) run each
layer as one batched product; under dopri5 each seed takes its own
adaptive steps (``solve_adaptive``'s and ``odeint_adjoint``'s
``seed_axis``); the loss is a per-seed mean.
"""

from __future__ import annotations

import torch

from nlbac_tpu_torch.config import NodeConfig
from nlbac_tpu_torch.nn.mlp import mlp_apply, mlp_init, mlp_sizes
from nlbac_tpu_torch.ode import solvers
from nlbac_tpu_torch.ode.adjoint import odeint_adjoint
from nlbac_tpu_torch.ops.node_kernel import node_euler_step
from nlbac_tpu_torch.tree import tree_leaves


def node_init(gen, cfg: NodeConfig, device=None):
    if cfg.form == "control_affine":
        f_sizes = mlp_sizes(cfg.state_dim, cfg.hidden_dim,
                            cfg.f_hidden_layers, cfg.state_dim)
        g_sizes = mlp_sizes(cfg.state_dim, cfg.hidden_dim,
                            cfg.g_hidden_layers,
                            cfg.state_dim * cfg.action_dim)
        return {"f": mlp_init(gen, f_sizes, device=device),
                "g": mlp_init(gen, g_sizes, device=device)}
    if cfg.form == "mlp":
        sizes = mlp_sizes(cfg.input_dim, cfg.hidden_dim,
                          cfg.mlp_hidden_layers, cfg.state_dim)
        return {"net": mlp_init(gen, sizes, device=device)}
    raise ValueError(f"unknown NODE form {cfg.form!r}")


def make_field(cfg: NodeConfig):
    """Build ``field(params, t, s)`` over the packed state s = [x, u(, t)]."""
    n_s, n_u = cfg.state_dim, cfg.action_dim
    cdt = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None

    if cfg.form == "control_affine":
        if cfg.normalize:
            raise ValueError("normalize=True is only implemented for "
                             "form='mlp'")
        if cfg.time_input:
            raise ValueError("time_input=True is only implemented for "
                             "form='mlp'")

        def field(params, t, s):
            x = s[..., :n_s]
            u = s[..., n_s:n_s + n_u]
            f_x = mlp_apply(params["f"], x, compute_dtype=cdt)
            g_x = mlp_apply(params["g"], x, compute_dtype=cdt)
            g_x = g_x.reshape(g_x.shape[:-1] + (n_s, n_u))
            dx = f_x + torch.einsum("...ij,...j->...i", g_x, u)
            return torch.cat([dx, torch.zeros_like(u)], dim=-1)

        return field

    if cfg.form == "mlp":
        if cfg.normalize:
            if cfg.state_scale is None or cfg.action_scale is None:
                raise ValueError("normalize=True requires state_scale and "
                                 "action_scale")
            scale_in = list(cfg.state_scale) + list(cfg.action_scale) + \
                ([1.0] if cfg.time_input else [])
            sx_list = list(cfg.state_scale)

            def field(params, t, s):
                si = torch.as_tensor(scale_in, dtype=s.dtype, device=s.device)
                sx = torch.as_tensor(sx_list, dtype=s.dtype, device=s.device)
                dx = mlp_apply(params["net"], s / si, compute_dtype=cdt) * sx
                return torch.cat([dx, torch.zeros_like(s[..., n_s:])], dim=-1)

            return field

        def field(params, t, s):
            dx = mlp_apply(params["net"], s, compute_dtype=cdt)
            return torch.cat([dx, torch.zeros_like(s[..., n_s:])], dim=-1)

        return field

    raise ValueError(f"unknown NODE form {cfg.form!r}")


def pack_input(cfg: NodeConfig, x, u, t=None):
    """Pack (state, action[, time]) into the integration state."""
    parts = [x, u]
    if cfg.time_input:
        if t is None:
            raise ValueError("this NODE form requires a time input")
        parts.append(t if t.dim() == x.dim() else t[..., None])
    return torch.cat(parts, dim=-1)


def uses_euler_kernel(cfg: NodeConfig) -> bool:
    """Whether ``predict_next_state`` takes the fused Euler kernel (K1)
    for this config: the control-affine field, one Euler step, float32
    compute (a tensor-parallel rank's cut nets excepted)."""
    return (cfg.form == "control_affine" and cfg.solver == "euler"
            and cfg.solver_steps == 1 and cfg.compute_dtype is None)


def predict_next_state(cfg: NodeConfig, params, x, u, dt, t=None,
                       field=None, shorts=None, dp_group=None):
    """Integrate the packed state over [0, dt] and return the predicted next
    physical state (the first ``state_dim`` slots). Under dopri5, when
    ``shorts`` is a list, append to it a 0-d bool device tensor: whether
    the integration ended short of dt (``max_steps`` ran out; (S,), each
    seed with its own step control, for parameters stacked over seeds);
    with a
    ``dp_group`` (a ``parallel.mesh.Comm``), x and u are this rank's rows
    of the group's batch and the error norms span the whole batch."""
    if uses_euler_kernel(cfg) and not tp_sharded(params):
        return node_euler_step(params, x.contiguous(), u.contiguous(), dt)
    if field is None:
        field = make_field(cfg)
    s0 = pack_input(cfg, x, u, t)
    if cfg.solver == "dopri5":
        seeds = _stacked(params)
        if cfg.adaptive_impl == "scan":
            s1, t_reached = solvers.solve_adaptive(
                field, params, s0, 0.0, dt, impl="scan",
                max_steps=cfg.adaptive_scan_steps, return_final_t=True,
                reduce=(None if dp_group is None
                        else solvers.rows_reduce(dp_group)),
                seed_axis=seeds)
        else:
            s1, t_reached = odeint_adjoint(field, params, s0, 0.0, dt,
                                           method="dopri5",
                                           return_final_t=True,
                                           dp_group=dp_group,
                                           seed_axis=seeds)
        if shorts is not None:
            shorts.append(t_reached < dt)
    else:
        s1 = solvers.odeint(field, params, s0, 0.0, dt, method=cfg.solver,
                            num_steps=cfg.solver_steps)
    return s1[..., :cfg.state_dim]


def tp_sharded(params) -> bool:
    """Whether any layer of the NODE's nets is a tensor-parallel shard."""
    return any(getattr(w, "tp_shard", None) is not None
               for net in params.values() for w in net["w"])


def seed_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over every axis but the leading seed axis: (S,)."""
    return torch.mean(x, dim=tuple(range(1, x.dim())))


def _stacked(params) -> bool:
    """Whether a NODE's parameters carry a leading seed axis."""
    net = next(iter(params.values()))
    return net["b"][0].dim() == 2


def node_loss(cfg: NodeConfig, params, x, u, x_next, dt, t=None,
              field=None, shorts=None, mean=None, dp_group=None):
    """Mean-squared one-step prediction error (``mean`` takes the squared
    errors to the loss: a data-parallel rank passes its share of the
    global mean, and its ``dp_group``). By default the mean over the
    batch, per seed for stacked parameters."""
    if mean is None:
        mean = seed_mean if _stacked(params) else torch.mean
    pred = predict_next_state(cfg, params, x, u, dt, t, field, shorts,
                              dp_group)
    return mean(torch.square(pred - x_next))


def apply_grads(optimizer: torch.optim.Optimizer, params, grads) -> None:
    """One optimizer step with ``grads`` (aligned with
    ``tree_leaves(params)``) in place of accumulated ``.grad``s."""
    for p, g in zip(tree_leaves(params), grads):
        p.grad = g
    optimizer.step()


def node_train_step(cfg: NodeConfig, params, optimizer, x, u, x_next, dt,
                    t=None, field=None) -> torch.Tensor:
    """One Adam step on the one-step MSE, in place on ``params`` (bound to
    ``optimizer``); returns the loss before the step."""
    loss = node_loss(cfg, params, x, u, x_next, dt, t, field)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    apply_grads(optimizer, params, grads)
    return loss.detach()
