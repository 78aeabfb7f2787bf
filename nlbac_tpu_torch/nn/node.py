"""Neural-ODE vector fields and the one-step dynamics fit (port of
``nlbac_tpu/nn/node.py``).

- ``control_affine``: dx/dt = f(x) + g(x) u with two MLPs of width 100.
- ``mlp``: non-affine dx/dt = F(x, u[, t]), one MLP over the packed input.

The integration state is ``concat(x, u[, t])`` and the field returns zeros
in the control (and time) slots (zero-order-hold control). For the
control-affine field under one Euler step, ``predict_next_state`` goes
through the fused kernel ``ops.node_kernel.node_euler_step``.
"""

from __future__ import annotations

import torch

from nlbac_tpu_torch.config import NodeConfig
from nlbac_tpu_torch.nn.mlp import mlp_apply, mlp_init, mlp_sizes
from nlbac_tpu_torch.ode import solvers
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


def predict_next_state(cfg: NodeConfig, params, x, u, dt, t=None,
                       field=None):
    """Integrate the packed state over [0, dt] and return the predicted next
    physical state (the first ``state_dim`` slots)."""
    if cfg.form == "control_affine" and cfg.solver == "euler" and \
            cfg.solver_steps == 1:
        return node_euler_step(params, x.contiguous(), u.contiguous(), dt,
                               compute_dtype=cfg.compute_dtype)
    if cfg.solver == "dopri5":
        raise NotImplementedError("the adaptive dopri5 solver is not ported "
                                  "yet (ROADMAP.md)")
    if field is None:
        field = make_field(cfg)
    s0 = pack_input(cfg, x, u, t)
    s1 = solvers.odeint(field, params, s0, 0.0, dt, method=cfg.solver,
                        num_steps=cfg.solver_steps)
    return s1[..., :cfg.state_dim]


def node_loss(cfg: NodeConfig, params, x, u, x_next, dt, t=None,
              field=None):
    """Mean-squared one-step prediction error."""
    pred = predict_next_state(cfg, params, x, u, dt, t, field)
    return torch.mean(torch.square(pred - x_next))


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
