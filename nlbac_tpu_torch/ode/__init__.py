from nlbac_tpu_torch.ode.adjoint import odeint_adjoint  # noqa: F401
from nlbac_tpu_torch.ode.solvers import (  # noqa: F401
    euler_step,
    heun_step,
    midpoint_step,
    odeint,
    odeint_grid,
    rk4_step,
    solve_adaptive,
    solve_fixed,
)
