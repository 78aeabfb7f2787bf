from nlbac_tpu_torch.ode.solvers import (  # noqa: F401
    euler_step,
    heun_step,
    midpoint_step,
    odeint,
    rk4_step,
    solve_fixed,
)
