"""Fixed-step explicit Runge-Kutta solvers (port of the fixed-step half of
``nlbac_tpu/ode/solvers.py``).

``field(params, t, y) -> dy/dt`` over a tensor state. The reference's hot
configuration is one Euler step over [0, dt]. The adaptive dopri5 solver
and the adjoint are not ported yet (ROADMAP.md)."""

from __future__ import annotations

from typing import Callable

Field = Callable  # field(params, t, y) -> dy/dt


def euler_step(field: Field, params, t, y, dt):
    """One explicit Euler step: y + dt * f(t, y)."""
    return y + dt * field(params, t, y)


def midpoint_step(field: Field, params, t, y, dt):
    k1 = field(params, t, y)
    k2 = field(params, t + 0.5 * dt, y + (0.5 * dt) * k1)
    return y + dt * k2


def heun_step(field: Field, params, t, y, dt):
    k1 = field(params, t, y)
    k2 = field(params, t + dt, y + dt * k1)
    return y + (dt * 0.5) * k1 + (dt * 0.5) * k2


def rk4_step(field: Field, params, t, y, dt):
    k1 = field(params, t, y)
    k2 = field(params, t + 0.5 * dt, y + (0.5 * dt) * k1)
    k3 = field(params, t + 0.5 * dt, y + (0.5 * dt) * k2)
    k4 = field(params, t + dt, y + dt * k3)
    return (y + (dt * (1 / 6)) * k1 + (dt * (1 / 3)) * k2
            + (dt * (1 / 3)) * k3 + (dt * (1 / 6)) * k4)


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


def odeint(field: Field, params, y0, t0, t1, *, method: str = "euler",
           num_steps: int = 1):
    """Solve from t0 to t1 and return the state at t1 (fixed methods)."""
    if method in FIXED_STEPS:
        return solve_fixed(field, params, y0, t0, t1, method=method,
                           num_steps=num_steps)
    raise ValueError(
        f"method {method!r} is not ported; fixed-step methods: "
        f"{sorted(FIXED_STEPS)}")
