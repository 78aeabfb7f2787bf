"""Optimize-then-discretize (adjoint, backsolve) gradients (port of
``nlbac_tpu/ode/adjoint.py``).

For y' = f(theta, t, y) and a loss L(y(t1)), the adjoint a(t) = dL/dy(t)
follows da/dt = -a^T df/dy with a(t1) = dL/dy1, and dL/dtheta is the
integral of a^T df/dtheta over [t0, t1]. The backward pass integrates the
augmented state (y, a, g_theta) over s = t0 + t1 - t, forward in s from
(y1, dL/dy1, 0):

    d/ds (y, a, g) = (-f, +a^T df/dy, +a^T df/dtheta)

with the forward's method (Chen et al., Neural ODEs, 2018). Under dopri5
every leaf of the augmented state, g_theta included, enters the error
norm, so the backward solve's steps depend on g_theta, as in the JAX
package.

In a gang the norms are the gang's (``_gang_reduce``), so every rank takes
the same steps as one device over the whole state:

- data parallel (``dp_group``): each rank holds its rows of y and a, and
  its rows' share of g_theta. The rows' sums of squares and counts are
  summed over the group; so are the trial's g5, g4 and g_theta before
  their scaled error is taken (one all-reduce of three parameter-sized
  vectors a trial). g_theta itself stays local: the solve returns this
  rank's share, and the update sums the shares over the group with the
  other gradients (``agent.update``'s ``step``), so it is counted once.
- tensor parallel (read from the parameters' ``tp_shard`` marks): y and a
  are the same on every rank; g_theta holds this rank's shards of the cut
  leaves (their squares are summed over the tp group) and the whole
  replicated ones (counted once); the count is the global numel.

Stacked over seeds (``seed_axis=True``: every leaf of y0 and of the
parameters with a leading seed axis S), g_theta is (S, P), one row per
seed, and both solves take each seed's own steps (``solve_adaptive``'s
``seed_axis``): each seed's norm covers its own y, a and g_theta row, as
``jax.vmap`` of the adjoint computes it. A stacked state takes no gang.
"""

from __future__ import annotations

import torch

from nlbac_tpu_torch.ode import solvers
from nlbac_tpu_torch.tree import detach_leaf, tree_leaves, tree_unflatten


def _integrate(field, params, y, t0, t1, opts, reduce=None):
    if opts["method"] == "dopri5":
        return solvers.solve_adaptive(field, params, y, t0, t1,
                                      rtol=opts["rtol"], atol=opts["atol"],
                                      max_steps=opts["max_steps"],
                                      return_final_t=True, reduce=reduce,
                                      seed_axis=opts["seed_axis"])
    return solvers.solve_fixed(field, params, y, t0, t1,
                               method=opts["method"],
                               num_steps=opts["num_steps"]), None


def _gang_reduce(dp_group, p_leaves):
    """The backward solve's ``reduce`` in a gang (the module's note), or
    None for a run of one. The augmented state's leaves are y's, a's and
    the flat g_theta, in that order."""
    marks = [getattr(p, "tp_shard", None) for p in p_leaves]
    tp = next((m.comm for m in marks if m is not None), None)
    if dp_group is None and tp is None:
        return None
    sizes = [p.numel() for p in p_leaves]
    n_params = sum(sizes)
    if tp is not None:
        cut = torch.cat([torch.full((n,), m is not None,
                                    device=p_leaves[0].device)
                         for n, m in zip(sizes, marks)])
        n_params = sum(n * (tp.size if m is not None else 1)
                       for n, m in zip(sizes, marks))

    def reduce(triples, rtol, atol):
        *rows, (g5, g4, g) = triples
        total, n = solvers.local_sq(rows, rtol, atol)
        if dp_group is not None:
            k = g.numel()
            flat = dp_group.all_reduce(torch.cat(
                [g5, g4, g, torch.stack([total, g.new_tensor(float(n))])]))
            g5, g4, g = flat[:k], flat[k:2 * k], flat[2 * k:3 * k]
            total, n = flat[3 * k], flat[3 * k + 1]
        scale = atol + rtol * torch.maximum(torch.abs(g), torch.abs(g5))
        sq = torch.square((g5 - g4) / scale)
        if tp is None:
            return total + torch.sum(sq), n + n_params
        return (total + tp.all_reduce(torch.sum(torch.where(cut, sq, 0.0)))
                + torch.sum(torch.where(cut, 0.0, sq)), n + n_params)

    return reduce


class _Adjoint(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec, *leaves):
        field, params, y0, t0, t1, opts = spec
        n_y = len(tree_leaves(y0))
        y0_ = tree_unflatten(y0, leaves[:n_y])
        dp_group = opts["dp_group"]
        with torch.no_grad():
            y1, t_reached = _integrate(
                field, params, y0_, t0, t1, opts,
                None if dp_group is None else solvers.rows_reduce(dp_group))
        y1_leaves = tree_leaves(y1)
        ctx.spec, ctx.n_y = spec, n_y
        ctx.save_for_backward(*y1_leaves, *leaves[n_y:])
        # saved tensors come back without their tensor-parallel marks
        ctx.marks = [getattr(p, "tp_shard", None) for p in leaves[n_y:]]
        spec[-1]["t_reached"] = t_reached
        return tuple(y1_leaves)

    @staticmethod
    def backward(ctx, *grads):
        field, params, y0, t0, t1, opts = ctx.spec
        saved = ctx.saved_tensors
        y1 = tree_unflatten(y0, saved[:ctx.n_y])
        p_leaves = [p.detach() for p in saved[ctx.n_y:]]
        for p, mark in zip(p_leaves, ctx.marks):
            if mark is not None:
                p.tp_shard = mark
        g = tree_unflatten(y0, grads)

        def rev_field(_, s, aug):
            y, a, _gp = aug
            t = t0 + t1 - s
            with torch.enable_grad():
                y_in = tree_unflatten(y, [v.detach().requires_grad_(True)
                                          for v in tree_leaves(y)])
                p_in = [detach_leaf(p, True) for p in p_leaves]
                f = field(tree_unflatten(params, p_in), t, y_in)
                wrt = tree_leaves(y_in) + p_in
                vjp = torch.autograd.grad(tree_leaves(f), wrt,
                                          tree_leaves(a), allow_unused=True)
            vjp = [torch.zeros_like(w) if v is None else v
                   for w, v in zip(wrt, vjp)]
            n = len(tree_leaves(y))
            return (tree_unflatten(y, [-v.detach()
                                       for v in tree_leaves(f)]),
                    tree_unflatten(y, vjp[:n]),
                    torch.cat([v.reshape(lead + (-1,)) for v in vjp[n:]],
                              dim=-1))

        # g_theta as one flat tensor (a row per seed when stacked): the
        # same elements in the error norm, a few launches a stage instead
        # of a few per parameter leaf
        lead = (saved[0].shape[0],) if opts["seed_axis"] else ()
        sizes = [p[0].numel() if lead else p.numel() for p in p_leaves]
        aug0 = (y1, g, torch.zeros(lead + (sum(sizes),),
                                   dtype=saved[0].dtype,
                                   device=saved[0].device))
        with torch.no_grad():
            (_, a0, grad_p), _ = _integrate(
                rev_field, None, aug0, t0, t1, opts,
                _gang_reduce(opts["dp_group"], p_leaves))
        grad_p = [v.reshape(p.shape) for v, p in
                  zip(torch.split(grad_p, sizes, dim=-1), p_leaves)]
        return (None, *tree_leaves(a0), *grad_p)


def odeint_adjoint(field, params, y0, t0, t1, *, method: str = "euler",
                   num_steps: int = 1, rtol: float = 1e-5,
                   atol: float = 1e-7, max_steps: int = 512,
                   return_final_t: bool = False, dp_group=None,
                   seed_axis: bool = False):
    """Integration with adjoint (backsolve) gradients: the forward values
    of ``solvers.odeint`` (the forward integrates without a graph), and a
    backward that integrates the augmented system instead of storing the
    forward's stages. Fixed-step methods (``num_steps`` applies) and
    ``'dopri5'`` (``rtol``/``atol``/``max_steps`` govern the forward and
    the backward solves; the ``while`` form). ``params`` is a tree of
    tensors; gradients reach those of its leaves and of ``y0``'s that
    require them. ``return_final_t=True`` (dopri5) also returns the time
    the forward solve reached, on the device. ``dp_group`` (a
    ``parallel.mesh.Comm``) holds the ranks over which ``y0``'s rows are
    split; tensor-parallel shards among ``params`` are read from their
    marks (the module's note). ``seed_axis=True`` takes ``y0`` and
    ``params`` stacked over seeds, each seed with its own adaptive steps
    forward and backward; ``return_final_t`` then gives (S,) times."""
    if method != "dopri5" and method not in solvers.FIXED_STEPS:
        raise ValueError(f"unknown method {method!r}")
    opts = {"method": method, "num_steps": num_steps, "rtol": rtol,
            "atol": atol, "max_steps": max_steps, "dp_group": dp_group,
            "seed_axis": seed_axis}
    p_leaves = tree_leaves(params)
    if seed_axis and (dp_group is not None or any(
            getattr(p, "tp_shard", None) is not None for p in p_leaves)):
        raise ValueError("odeint_adjoint takes a seed axis or a gang, not "
                         "both")
    spec = (field, params, y0, t0, t1, opts)
    y1 = tree_unflatten(y0, _Adjoint.apply(spec, *tree_leaves(y0),
                                           *p_leaves))
    if return_final_t:
        return y1, opts["t_reached"]
    return y1
