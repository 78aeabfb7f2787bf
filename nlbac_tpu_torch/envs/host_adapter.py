"""Host-environment adapter (port of ``nlbac_tpu/envs/host_adapter.py``):
runs a host-side Python environment with the reference's extended gym API

    reset() -> obs
    step(action) -> (obs, reward, constraint, [barrier_signal,]
                     lyap_t, lyap_t1, done, info)

and marshals each step into fixed types. ``info`` may carry
``num_safety_violation`` / ``safety_cost`` (or per-cause
``num_safety_violation*`` / ``safety_cost*`` entries, which are summed),
``goal_met`` and ``reached``.

``host_reset`` / ``host_step`` return numpy values for the host loop
(``train/host_loop.py``). ``reset`` / ``step`` give the env-module
contract (``envs/base.py``): they call the host env directly and return
tensors on the caller's device; the "state" is the step count.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from nlbac_tpu_torch.envs.base import EnvSpec, StepOut


def _info_sum(info: dict, prefix: str) -> float:
    """``info[prefix]`` when nonzero, else the sum of the entries whose
    names start with it."""
    return float(info.get(prefix, 0.0)
                 or sum(v for k, v in info.items() if k.startswith(prefix)))


class HostEnvAdapter:
    def __init__(self, env: Any, spec: EnvSpec,
                 has_barrier_signal: bool = False):
        self.env = env
        self.SPEC = spec
        self.has_barrier_signal = has_barrier_signal

    def host_reset(self) -> np.ndarray:
        """Reset the wrapped env; returns the float32 obs."""
        return np.asarray(self.env.reset(), np.float32)

    def host_step(self, action: np.ndarray):
        """Step the wrapped env; returns the 11-tuple (obs, reward,
        constraint, lyap_t, lyap_t1, barrier, done, goal_met, reached,
        violations, safety_cost) as numpy arrays and scalars."""
        out = self.env.step(np.asarray(action))
        if self.has_barrier_signal:
            (obs, reward, constraint, barrier, lyap_t, lyap_t1, done,
             info) = out
        else:
            obs, reward, constraint, lyap_t, lyap_t1, done, info = out
            barrier = 0.0
        info = info or {}
        f = np.float32
        return (np.asarray(obs, np.float32), f(reward), f(constraint),
                np.asarray(lyap_t, np.float32),
                np.asarray(lyap_t1, np.float32), f(barrier),
                np.bool_(done), np.bool_(info.get("goal_met", False)),
                f(info.get("reached", 0.0)),
                f(_info_sum(info, "num_safety_violation")),
                f(_info_sum(info, "safety_cost")))

    # -- the env-module contract -----------------------------------------

    def reset(self, device, gen=None, max_episode_steps=None):
        del gen, max_episode_steps  # the host env owns these
        return 0, torch.as_tensor(self.host_reset(), device=device)

    def step(self, state, action, *, barrier_B: float = 0.0,
             barrier_b: float = 0.0, max_episode_steps=None):
        del barrier_B, barrier_b, max_episode_steps  # the host env's own
        device = action.device
        (obs, reward, constraint, lyap_t, lyap_t1, barrier, done, goal_met,
         reached, viol, cost) = self.host_step(action.detach().cpu().numpy())

        def tensor(v, dtype=torch.float32):
            return torch.as_tensor(np.asarray(v), dtype=dtype, device=device)

        zeros3 = np.zeros(3, np.float32)
        out = StepOut(
            obs=tensor(obs), reward=tensor(reward),
            constraint=tensor(constraint), lyap_t=tensor(lyap_t),
            lyap_t1=tensor(lyap_t1), barrier_signal=tensor(barrier),
            done=tensor(done, torch.bool), goal_met=tensor(goal_met,
                                                           torch.bool),
            reached=tensor(reached), num_violations=tensor(viol),
            safety_cost=tensor(cost),
            viol_breakdown=tensor(np.concatenate([[viol], zeros3])),
            cost_breakdown=tensor(np.concatenate([[cost], zeros3])))
        return state + 1, out


def make_host_env(env_factory: Callable[[], Any], spec: EnvSpec,
                  has_barrier_signal: bool = False) -> HostEnvAdapter:
    return HostEnvAdapter(env_factory(), spec, has_barrier_signal)
