"""Adam over parameters stacked on a leading seed axis, stepping only the
seeds in a mask (the optimizer of a lockstep seed-batched state,
``parallel/lockstep.py``).

``torch.optim.Adam`` keeps one step count per tensor, so it cannot hold
seeds whose update counts differ. ``SeedAdam`` keeps, for one optimizer
group, both moments as flat (S, P) buffers over the group's P parameters
a seed and a step count per seed, and takes the update of
``torch.optim.Adam`` (the bias corrections in float64, as its Python
floats are) seed by seed. A step with a mask leaves every other seed's
parameters, moments and step count as they were, bit for bit: the new
moments are selected by the mask, and a masked-off seed's update is
zero. The masking is one select per buffer for the whole group, not one
per leaf.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch


class SeedAdam:
    """Adam (``torch.optim.Adam``'s defaults: betas (0.9, 0.999), eps
    1e-8) over ``params``, each (S, ...) with S seeds."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float,
                 betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8):
        self.params: List[torch.Tensor] = list(params)
        if not self.params:
            raise ValueError("SeedAdam needs at least one parameter")
        self.lr, self.betas, self.eps = lr, betas, eps
        p0 = self.params[0]
        self.seeds = p0.shape[0]
        if any(p.shape[0] != self.seeds for p in self.params):
            raise ValueError("every parameter needs the same leading seed "
                             "axis")
        self.sizes = [p[0].numel() for p in self.params]
        n = sum(self.sizes)
        opts = dict(dtype=torch.float32, device=p0.device)
        self.exp_avg = torch.zeros((self.seeds, n), **opts)
        self.exp_avg_sq = torch.zeros((self.seeds, n), **opts)
        # per-seed step counts, float64 on the device, so that the bias
        # corrections need no host value
        self.step_count = torch.zeros((self.seeds,), dtype=torch.float64,
                                      device=p0.device)

    def _leaf_views(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """Views of a flat (S, P) buffer shaped like each parameter."""
        out, off = [], 0
        for p, n in zip(self.params, self.sizes):
            out.append(flat[:, off:off + n].view(p.shape))
            off += n
        return out

    def moments(self) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """(exp_avg, exp_avg_sq), each a list of views shaped like the
        parameters."""
        return self._leaf_views(self.exp_avg), \
            self._leaf_views(self.exp_avg_sq)

    def load_seed(self, i: int, step: int, exp_avg=None,
                  exp_avg_sq=None) -> None:
        """Set seed i's step count and, where given, its moments (lists
        aligned with the parameters, each shaped like one seed's slice)."""
        self.step_count[i] = float(step)
        for flat, leaves in ((self.exp_avg, exp_avg),
                             (self.exp_avg_sq, exp_avg_sq)):
            if leaves is not None:
                flat[i] = torch.cat([t.reshape(-1).to(flat)
                                     for t in leaves])

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor],
             mask: Optional[torch.Tensor] = None) -> None:
        """One Adam step with ``grads`` (aligned with the parameters), for
        the seeds where ``mask`` (a (S,) bool device tensor) holds; None
        steps every seed."""
        b1, b2 = self.betas
        g = torch.cat([t.reshape(self.seeds, -1) for t in grads], dim=1)
        if mask is None:
            self.step_count += 1.0
            self.exp_avg.lerp_(g, 1.0 - b1)
            self.exp_avg_sq.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            m, v = self.exp_avg, self.exp_avg_sq
        else:
            self.step_count += mask.to(torch.float64)
            m = torch.lerp(self.exp_avg, g, 1.0 - b1)
            v = torch.mul(self.exp_avg_sq, b2).addcmul_(g, g, value=1.0 - b2)
            keep = mask[:, None]
            self.exp_avg.copy_(torch.where(keep, m, self.exp_avg))
            self.exp_avg_sq.copy_(torch.where(keep, v, self.exp_avg_sq))
        step = self.step_count
        step_size = (self.lr / (1.0 - b1 ** step)).to(torch.float32)
        bc2_sqrt = torch.sqrt(1.0 - b2 ** step).to(torch.float32)
        denom = (v.sqrt() / bc2_sqrt[:, None]).add_(self.eps)
        upd = (step_size[:, None] * m) / denom
        if mask is not None:
            # a masked-off seed's step count may be 0 (its step size
            # infinite): its update is selected away, not multiplied
            upd = torch.where(mask[:, None], upd, 0.0)
        torch._foreach_sub_([p.detach() for p in self.params],
                            self._leaf_views(upd))
