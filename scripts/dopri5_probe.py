"""CPU probe of the port's adaptive NODE solve (no GPU needed):

    python3 scripts/dopri5_probe.py

1. The trial steps of ``odeint_adjoint``'s forward and backward dopri5
   solves on the unicycle NODE field at its full width (100), 128 rows,
   over the env's dt (0.02): the backward solve's error norm includes
   g_theta, so it takes many more trials than the forward.
2. How far the float32 gradient of the NODE fit's loss lies from the same
   gradient computed in float64, under the ``scan`` and ``while`` forms,
   as a fraction of each parameter leaf's largest entry, for six seeds of
   a small NODE (width 12, 8 rows): at dt = 0.02 the trial errors are
   float32 rounding noise, and the scan form's gradient also runs
   through the step sizes they set.

It prints counts and ratios measured on the CPU, no times.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from nlbac_tpu_torch.config import get_config  # noqa: E402
from nlbac_tpu_torch.envs import unicycle  # noqa: E402
from nlbac_tpu_torch.nn import (  # noqa: E402
    make_field,
    node_init,
    pack_input,
)
from nlbac_tpu_torch.nn.node import node_loss  # noqa: E402
from nlbac_tpu_torch.ode import odeint_adjoint  # noqa: E402
from nlbac_tpu_torch.tree import tree_leaves, tree_map  # noqa: E402

ROWS, SEEDS, FIT_ROWS = 128, range(6), 8


def adjoint_trials() -> None:
    cfg = get_config("unicycle")
    gen = torch.Generator().manual_seed(0)
    params = tree_map(lambda p: p.requires_grad_(True),
                      node_init(gen, cfg.node))
    base = make_field(cfg.node)
    calls = [0]

    def field(p, t, y):
        calls[0] += 1
        return base(p, t, y)

    high = torch.tensor(unicycle.SPEC.action_high)
    x = torch.randn(ROWS, 3, generator=gen)
    u = (torch.rand(ROWS, 2, generator=gen) * 2 - 1) * high
    s0 = pack_input(cfg.node, x, u).requires_grad_(True)
    y = odeint_adjoint(field, params, s0, 0.0, cfg.env.dt, method="dopri5")
    forward = calls[0]
    torch.autograd.grad(y.sum(), tree_leaves(params) + [s0])
    n = sum(p.numel() for p in tree_leaves(params))
    print(f"adjoint, width {cfg.node.hidden_dim}, {ROWS} rows, span "
          f"{cfg.env.dt}: forward {forward // 7} trial steps, backward "
          f"{(calls[0] - forward) // 7} (g_theta: {n} entries in the "
          "error norm)")


def fit_gradient_gap(impl: str) -> float:
    """The largest float32-vs-float64 gap of the fit's gradient, over the
    seeds, as a fraction of each leaf's largest entry."""
    ncfg = dataclasses.replace(
        get_config("unicycle").node, hidden_dim=12, f_hidden_layers=2,
        g_hidden_layers=2, solver="dopri5", adaptive_impl=impl)
    high = torch.tensor(unicycle.SPEC.action_high)
    worst = 0.0
    for seed in SEEDS:
        gen = torch.Generator().manual_seed(seed)
        params = node_init(gen, ncfg)
        obs = torch.randn(FIT_ROWS, 7, generator=gen)
        next_obs = torch.randn(FIT_ROWS, 7, generator=gen)
        u = (torch.rand(FIT_ROWS, 2, generator=gen) * 2 - 1) * high
        grads = {}
        for dtype in (torch.float32, torch.float64):
            p = tree_map(lambda v: v.to(dtype).requires_grad_(True), params)
            loss = node_loss(ncfg, p, unicycle.obs_to_state(obs.to(dtype)),
                             u.to(dtype),
                             unicycle.obs_to_state(next_obs.to(dtype)), 0.02)
            grads[dtype] = torch.autograd.grad(loss, tree_leaves(p))
        for a, b in zip(grads[torch.float32], grads[torch.float64]):
            gap = (a.double() - b).abs().max() / b.abs().max()
            worst = max(worst, gap.item())
    return worst


def main() -> None:
    adjoint_trials()
    for impl in ("scan", "while"):
        print(f"fit gradient, {impl}: float32 off float64 by up to "
              f"{fit_gradient_gap(impl):.3e} of a leaf's largest entry "
              f"(seeds {SEEDS.start}-{SEEDS.stop - 1}, {FIT_ROWS} rows, "
              "width 12, dt 0.02)")


if __name__ == "__main__":
    main()
