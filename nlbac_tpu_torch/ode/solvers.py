"""ODE solvers (port of ``nlbac_tpu/ode/solvers.py``): the fixed-step
explicit Runge-Kutta family and the adaptive Dormand-Prince 5(4) solver
with a PI step controller.

``field(params, t, y) -> dy/dt``. The state ``y`` may be a tensor or a
tuple, list or dict of tensors (the adjoint's augmented state is a tuple);
the field returns the same structure. The reference's hot configuration is
one Euler step over [0, dt].

The fixed-step family and the ``scan`` form of the adaptive solver are
differentiable by autograd through their loops (discretize-then-optimize);
the ``while`` form is differentiated through ``ode.adjoint.odeint_adjoint``
(``nn.predict_next_state`` routes it there). When ``max_steps`` trial
steps run out before the span is covered, the adaptive solver returns the
partially integrated state; ``return_final_t=True`` also returns the time
reached, which stays on the device.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from nlbac_tpu_torch.tree import (
    detach_leaf,
    tree_leaves,
    tree_map,
    tree_unflatten,
)

Field = Callable  # field(params, t, y) -> dy/dt


def _per_seed(a, x):
    """``a`` shaped to scale the leaf ``x``: a (S,) tensor (one value per
    seed) as (S, 1, ..., 1) along x's leading seed axis; a scalar or a 0-d
    tensor as it is."""
    if isinstance(a, torch.Tensor) and a.dim() == 1 and x.dim() > 1:
        return a.reshape(a.shape + (1,) * (x.dim() - 1))
    return a


def _axpy(a, x, y):
    """Tree y + a * x (``a`` per seed where it is (S,))."""
    return tree_map(lambda xi, yi: yi + _per_seed(a, xi) * xi, x, y)


def _comb(y, dt, pairs):
    """Tree y + dt * sum(w * k for w, k in pairs), one term at a time."""
    out = y
    for w, k in pairs:
        out = _axpy(dt * w, k, out)
    return out


# ---------------------------------------------------------------------------
# Fixed-step explicit Runge-Kutta steps
# ---------------------------------------------------------------------------

def euler_step(field: Field, params, t, y, dt):
    """One explicit Euler step: y + dt * f(t, y)."""
    return _axpy(dt, field(params, t, y), y)


def midpoint_step(field: Field, params, t, y, dt):
    k1 = field(params, t, y)
    k2 = field(params, t + 0.5 * dt, _axpy(0.5 * dt, k1, y))
    return _axpy(dt, k2, y)


def heun_step(field: Field, params, t, y, dt):
    k1 = field(params, t, y)
    k2 = field(params, t + dt, _axpy(dt, k1, y))
    return _comb(y, dt, [(0.5, k1), (0.5, k2)])


def rk4_step(field: Field, params, t, y, dt):
    k1 = field(params, t, y)
    k2 = field(params, t + 0.5 * dt, _axpy(0.5 * dt, k1, y))
    k3 = field(params, t + 0.5 * dt, _axpy(0.5 * dt, k2, y))
    k4 = field(params, t + dt, _axpy(dt, k3, y))
    return _comb(y, dt, [(1 / 6, k1), (1 / 3, k2), (1 / 3, k3), (1 / 6, k4)])


FIXED_STEPS = {
    "euler": euler_step,
    "midpoint": midpoint_step,
    "heun": heun_step,
    "rk4": rk4_step,
}


def solve_fixed(field: Field, params, y0, t0, t1, *, method: str = "euler",
                num_steps: int = 1):
    """Integrate from t0 to t1 with ``num_steps`` equal fixed steps."""
    step_fn = FIXED_STEPS[method]
    dt = (float(t1) - float(t0)) / num_steps
    t, y = float(t0), y0
    for _ in range(num_steps):
        y = step_fn(field, params, t, y, dt)
        t = t + dt
    return y


def _device(y):
    return tree_leaves(y)[0].device


def odeint_grid(field: Field, params, y0, ts, *, method: str = "euler",
                steps_per_interval: int = 1):
    """Integrate through the time grid ``ts`` (T points) and return the
    states at every point stacked on a new axis 0 of each leaf:
    ``out[0] == y0`` and ``out[i]`` is the solution at ``ts[i]``. Times
    and steps are float32, as in the JAX package."""
    step_fn = FIXED_STEPS[method]
    ts = torch.as_tensor(ts, dtype=torch.float32, device=_device(y0))
    ys, y = [y0], y0
    for i in range(ts.shape[0] - 1):
        t, t_b = ts[i], ts[i + 1]
        dt = (t_b - t) / steps_per_interval
        for _ in range(steps_per_interval):
            y = step_fn(field, params, t, y, dt)
            t = t + dt
        ys.append(y)
    return tree_map(lambda *leaves: torch.stack(leaves), *ys)


# ---------------------------------------------------------------------------
# Adaptive Dormand-Prince 5(4)
# ---------------------------------------------------------------------------

_DP_C = [0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0]
_DP_A = [
    [],
    [1 / 5],
    [3 / 40, 9 / 40],
    [44 / 45, -56 / 15, 32 / 9],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
    [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
]
_DP_B5 = [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0]
_DP_B4 = [5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
          187 / 2100, 1 / 40]


def _dopri5_step(field: Field, params, t, y, dt):
    """One dopri5 trial step; returns (5th-order y, 4th-order y)."""
    ks = []
    for i in range(7):
        yi = y
        for j, a in enumerate(_DP_A[i]):
            yi = _axpy(dt * a, ks[j], yi)
        ks.append(field(params, t + _DP_C[i] * dt, yi))
    y5 = _comb(y, dt, list(zip(_DP_B5, ks)))
    y4 = _comb(y, dt, list(zip(_DP_B4, ks)))
    return y5, y4


def local_sq(triples, rtol, atol, seed_axis=False):
    """(sum of squares, element count) of the scaled error over the
    leaves' ``(y5, y4, y)`` triples held here; with ``seed_axis``, each
    seed's: (S,) sums over every axis but the leading one, and the count
    of one seed's elements."""
    total = 0
    for a5, a4, a in triples:
        scale = atol + rtol * torch.maximum(torch.abs(a), torch.abs(a5))
        sq = torch.square((a5 - a4) / scale)
        total = total + (sq.reshape(sq.shape[0], -1).sum(1) if seed_axis
                         else torch.sum(sq))
    n = sum(a.numel() for _, _, a in triples)
    return total, (n // triples[0][2].shape[0] if seed_axis else n)


def _err_norm(y5, y4, y, rtol, atol, reduce=None, seed_axis=False):
    """RMS over every leaf element of the scaled error (each seed's, (S,),
    with ``seed_axis``), floored so that its square root stays
    differentiable at 0. ``reduce(triples, rtol, atol) -> (sum of squares,
    count)`` takes the leaves' ``(y5, y4, y)`` triples in place of
    ``local_sq`` when the state is spread over a gang (``rows_reduce``,
    and the adjoint's): the sums are then the gang's, and the norm the one
    a single device computes over the whole state."""
    triples = list(zip(tree_leaves(y5), tree_leaves(y4), tree_leaves(y)))
    if reduce is None:
        total, n = local_sq(triples, rtol, atol, seed_axis)
    else:
        total, n = reduce(triples, rtol, atol)
    return torch.sqrt(torch.clamp(total / n, min=1e-24))


def rows_reduce(comm):
    """The ``reduce`` of a state whose rows are split over ``comm`` (a
    data-parallel group, ``parallel.mesh.Comm``): the local sum of squares
    and count summed over the group in one all-reduce, whose gradient is
    summed too (every rank's loss reads the norm through the step sizes).
    Every rank then holds the same norm, so the accept decisions, the
    trial counts and the collectives match across the group."""
    def reduce(triples, rtol, atol):
        total, n = local_sq(triples, rtol, atol)
        both = comm.psum(torch.stack([total, total.new_tensor(float(n))]))
        return both[0], both[1]

    return reduce


def _trial(field, params, t, y, dt, rtol, atol, reduce=None,
           seed_axis=False):
    y5, y4 = _dopri5_step(field, params, t, y, dt)
    return y5, _err_norm(y5, y4, y, rtol, atol, reduce, seed_axis)


class _GuardedTrial(torch.autograd.Function):
    """One trial step (y5 and its error) whose gradient is dropped when the
    error is not finite.

    A trial whose stages overflow is rejected, so its y5 reaches the
    result only through a select that sends it a zero cotangent; autograd
    would still multiply that zero by the trial's infinities (0 * inf =
    NaN) and the NaN would reach every gradient. Here the trial's graph is
    built inside ``forward`` and differentiated in ``backward``; a trial
    with a finite error passes its gradient through unchanged, one with a
    non-finite error contributes none. The values are the plain trial's.

    Stacked over seeds the error is (S,), and a seed whose error is not
    finite loses only its own slice (axis 0) of each input's gradient: a
    seed's stages read only its own slices of the time, the step, the
    state and the (stacked) parameters."""

    @staticmethod
    def forward(ctx, run, *inputs):
        inner = [detach_leaf(x, x.requires_grad) for x in inputs]
        with torch.enable_grad():
            y5, err = run(*inner)
        outs = tree_leaves(y5) + [err]
        ctx.graph = (inner, outs)
        ctx.ok = torch.isfinite(err)
        return tuple(o.detach() for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        inner, outs = ctx.graph
        live = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
        wanted = [x for x in inner if x.requires_grad]
        got = iter(torch.autograd.grad([o for o, _ in live], wanted,
                                       [g for _, g in live],
                                       allow_unused=True))
        result = []
        for x in inner:
            g = next(got) if x.requires_grad else None
            if g is not None:
                g = torch.where(_per_seed(ctx.ok, g), g, 0.0)
            result.append(g)
        ctx.graph = None
        return (None, *result)


def _guarded_trial(field, params, t, y, dt, rtol, atol, reduce=None,
                   seed_axis=False):
    """``_trial``, through ``_GuardedTrial`` when a gradient is taken."""
    y_leaves = tree_leaves(y)
    all_p = tree_leaves(params)
    slots = [i for i, p in enumerate(all_p)
             if isinstance(p, torch.Tensor) and p.is_floating_point()]
    inputs = [t, dt, *y_leaves, *(all_p[i] for i in slots)]
    if not (torch.is_grad_enabled()
            and any(x.requires_grad for x in inputs)):
        return _trial(field, params, t, y, dt, rtol, atol, reduce, seed_axis)
    if seed_axis and any(x.dim() == 0 or x.shape[0] != t.shape[0]
                         for x in inputs):
        raise ValueError("solve_adaptive(seed_axis=True) differentiates a "
                         "state and parameters that all carry the leading "
                         f"seed axis ({t.shape[0]} seeds)")
    n_y = len(y_leaves)

    def run(t_, dt_, *rest):
        p_leaves = list(all_p)
        for i, p in zip(slots, rest[n_y:]):
            p_leaves[i] = p
        return _trial(field, tree_unflatten(params, p_leaves), t_,
                      tree_unflatten(y, rest[:n_y]), dt_, rtol, atol, reduce,
                      seed_axis)

    outs = _GuardedTrial.apply(run, *inputs)
    return tree_unflatten(y, outs[:n_y]), outs[n_y]


def solve_adaptive(field: Field, params, y0, t0, t1, *, rtol: float = 1e-5,
                   atol: float = 1e-7, max_steps: int = 512,
                   safety: float = 0.9, min_factor: float = 0.2,
                   max_factor: float = 10.0, return_final_t: bool = False,
                   impl: str = "while", trace: Optional[list] = None,
                   reduce: Optional[Callable] = None,
                   seed_axis: bool = False):
    """Adaptive dopri5 with a PI step-size controller, as the JAX package
    computes it: first trial step 0.1 * |t1 - t0|, each step cut to the
    span left, the factor ``0.9 * err^(-0.7/5) * err_prev^(0.4/5)``
    clipped to [0.2, 10] (``err_prev`` starts at 1 and takes the accepted
    errors floored at 1e-10), a step accepted when the RMS error over
    every leaf of the state is <= 1. A reverse span integrates backward
    (forward in sigma = |t - t0| on the direction-flipped field). Times,
    steps and errors are float32 tensors on the state's device.

    ``impl='while'`` is a Python loop of at most ``max_steps`` trials
    that reads ``t < span`` on the host once per trial: one
    synchronization with the device per trial step.

    ``impl='scan'`` runs exactly ``max_steps`` trials with no host read:
    a trial after the span is covered runs with its step forced to
    exactly 0 and changes nothing (``torch.where`` keeps the state). It
    is differentiable by autograd through the loop, every trial being
    paid for, so ``max_steps`` should be a realistic bound (16 for the
    NODE's 0.02 spans), not the while form's 512 backstop. A trial whose
    error is not finite contributes no gradient (``_GuardedTrial``); the
    values are unchanged.

    ``return_final_t=True`` returns ``(y, t_reached)``; a ``t_reached``
    short of ``t1`` means ``max_steps`` ran out. ``trace``, a list, gets
    one ``(err, accepted, active)`` triple of 0-d tensors per trial.

    ``reduce`` spreads the error norm over a gang (``_err_norm``): with
    the rows of ``y0`` split over a data-parallel group, ``rows_reduce``
    of that group gives every rank the whole batch's norm, as JAX's
    single-device math does. A state that every rank holds whole (a
    tensor-parallel rank's rows) takes none: its norm is the same on
    every rank already.

    ``seed_axis=True``: every leaf of ``y0`` and of ``params`` carries a
    leading seed axis S, and each seed takes its own steps, as ``jax.vmap``
    of the solver does: the error norm covers each seed's elements alone,
    and ``t``, the step, the controller's ``err_prev``, each trial's
    error, accept and active flags are (S,); every seed's first trial
    step is 0.1 * |t1 - t0|. A seed whose span is covered is frozen as the
    scan form freezes a finished trial (its step forced to 0, its carry
    kept). The ``while`` form then loops while any seed is short of the
    span (one host read a trial, of ``(t < span).any()``), as JAX's
    batched ``while_loop`` runs until every seed is done; ``max_steps``
    bounds every seed's trials, as JAX's ``n_steps`` does. The field sees
    the (S,) times. ``return_final_t`` returns each seed's time reached,
    and ``trace`` gets (S,) triples. It takes no ``reduce``."""
    if impl not in ("while", "scan"):
        raise ValueError(f"unknown adaptive impl {impl!r}")
    if seed_axis and reduce is not None:
        raise ValueError("solve_adaptive takes a seed axis or a gang's "
                         "reduce, not both")
    dev = _device(y0)
    t0 = torch.as_tensor(t0, dtype=torch.float32, device=dev)
    t1 = torch.as_tensor(t1, dtype=torch.float32, device=dev)
    span = torch.abs(t1 - t0)
    direction = torch.sign(t1 - t0)

    def sigma_field(p, s, y):
        return tree_map(lambda v: direction * v,
                        field(p, t0 + direction * s, y))

    def keep(mask, new, old):
        """``new`` where ``mask`` holds (per seed along axis 0 of each
        leaf), else ``old``."""
        return tree_map(lambda a, b: torch.where(_per_seed(mask, a), a, b),
                        new, old)

    def body(t, y, dt, err_prev):
        dt = torch.minimum(dt, span - t)
        y5, err = _guarded_trial(sigma_field, params, t, y, dt, rtol, atol,
                                 reduce, seed_axis)
        accept = err <= 1.0
        err_c = torch.clamp(err, min=1e-10)
        # a NaN error (a trial that overflowed, or one after it) leaves
        # the next step NaN, as in the JAX package; the selects keep the
        # NaN out of the gradient (0 * NaN in the products' backward)
        valid = ~torch.isnan(err)
        err_s = torch.where(valid, err_c, torch.ones_like(err_c))
        dt_s = torch.where(valid, dt, torch.ones_like(dt))
        factor = safety * err_s ** (-0.7 / 5.0) * err_prev ** (0.4 / 5.0)
        factor = torch.clamp(factor, min_factor, max_factor)
        new_dt = torch.where(valid, dt_s * factor,
                             torch.full_like(dt, float("nan")))
        return (torch.where(accept, t + dt, t), keep(accept, y5, y),
                new_dt, torch.where(accept, err_c, err_prev), err, accept)

    shape = (tree_leaves(y0)[0].shape[0],) if seed_axis else ()
    t = torch.zeros(shape, dtype=torch.float32, device=dev)
    err_prev = torch.ones(shape, dtype=torch.float32, device=dev)
    dt, y = (span * 0.1).expand(shape), y0
    if impl == "while" and not seed_axis:
        for _ in range(max_steps):
            if not bool(t < span):  # the per-trial host read
                break
            t, y, dt, err_prev, err, accept = body(t, y, dt, err_prev)
            if trace is not None:
                trace.append((err, accept, torch.ones_like(accept)))
    else:
        for _ in range(max_steps):
            active = t < span
            if impl == "while" and not bool(active.any()):  # the host read
                break
            # a frozen trial steps by exactly 0 (span - t may be a hair
            # below 0), so y5 = y4 = y and its discarded values stay finite
            t2, y2, dt2, ep2, err, accept = body(
                torch.where(active, t, span), y,
                torch.where(active, dt, torch.zeros_like(dt)), err_prev)
            t = torch.where(active, t2, t)
            y = keep(active, y2, y)
            dt = torch.where(active, dt2, dt)
            err_prev = torch.where(active, ep2, err_prev)
            if trace is not None:
                trace.append((err, accept & active, active))
    if return_final_t:
        return y, t0 + direction * t
    return y


# ---------------------------------------------------------------------------
# Unified front-end
# ---------------------------------------------------------------------------

def odeint(field: Field, params, y0, t0, t1, *, method: str = "euler",
           num_steps: int = 1, rtol: float = 1e-5, atol: float = 1e-7,
           max_steps: int = 512, impl: str = "while"):
    """Integrate ``dy/dt = field(params, t, y)`` from t0 to t1.

    method: 'euler' | 'midpoint' | 'heun' | 'rk4' (``num_steps`` equal
    steps) or 'dopri5' (adaptive; ``rtol``/``atol``/``max_steps``/``impl``
    apply, see ``solve_adaptive``)."""
    if method in FIXED_STEPS:
        return solve_fixed(field, params, y0, t0, t1, method=method,
                           num_steps=num_steps)
    if method == "dopri5":
        return solve_adaptive(field, params, y0, t0, t1, rtol=rtol,
                              atol=atol, max_steps=max_steps, impl=impl)
    raise ValueError(f"unknown method {method!r}; options: "
                     f"{sorted(FIXED_STEPS) + ['dopri5']}")
