"""Expose one of the port's env modules through the reference's host gym
API (port of ``nlbac_tpu/envs/host_shim.py``), so that the host-loop
trainer (``train/host_loop.py``), built for external host physics, can be
driven by the known presets.

The env runs on ``torch.device('cpu')`` with its own CPU generator seeded
from ``seed`` (drawn by the resets that draw, e.g. cars), whatever device
the trainer uses: host physics stays on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from nlbac_tpu_torch.envs.host_adapter import HostEnvAdapter

_CPU = torch.device("cpu")


class _HostShim:
    """The host-API view of one env module (a stateful wrapper over its
    functional reset and step)."""

    def __init__(self, env_module, seed: int = 0, barrier_B: float = 0.0,
                 barrier_b: float = 0.0, max_episode_steps=None,
                 step_kwargs=None):
        self._env = env_module
        self._max_steps = (env_module.SPEC.max_episode_steps
                           if max_episode_steps is None
                           else int(max_episode_steps))
        self._step_kwargs = dict(barrier_B=barrier_B, barrier_b=barrier_b,
                                 max_episode_steps=self._max_steps,
                                 **(step_kwargs or {}))
        self.generator = torch.Generator(_CPU).manual_seed(seed)
        self.state = None

    def reset(self):
        self.state, obs = self._env.reset(
            _CPU, gen=self.generator, max_episode_steps=self._max_steps)
        return obs.numpy().astype(np.float32)

    def step(self, action):
        a = torch.as_tensor(np.asarray(action), dtype=torch.float32)
        self.state, o = self._env.step(self.state, a, **self._step_kwargs)
        info = {"num_safety_violation": float(o.num_violations),
                "safety_cost": float(o.safety_cost),
                "goal_met": bool(o.goal_met), "reached": float(o.reached)}
        return (o.obs.numpy().astype(np.float32), float(o.reward),
                float(o.constraint), float(o.barrier_signal),
                o.lyap_t.numpy().astype(np.float32),
                o.lyap_t1.numpy().astype(np.float32), bool(o.done), info)


def as_host_env(env_module, seed: int = 0, barrier_B: float = 0.0,
                barrier_b: float = 0.0, max_episode_steps=None,
                step_kwargs=None) -> HostEnvAdapter:
    """Wrap ``env_module`` (SPEC + reset/step) in the reference's host gym
    API and return a ready ``HostEnvAdapter``. ``step_kwargs`` are extra
    ``env.step`` kwargs (the driver's ``kill_penalty``/``kill_attitude``,
    ``train.driver.build_step_kwargs``). The module's obs -> NODE-state
    adapter is forwarded (PVTOL's ``obs_to_dynamics_state``), and so are
    ``state_to_obs`` and the quadrotor's ``ground_probe_obs``."""
    spec = env_module.SPEC
    if max_episode_steps is not None:
        spec = spec._replace(max_episode_steps=int(max_episode_steps))
    shim = _HostShim(env_module, seed=seed, barrier_B=barrier_B,
                     barrier_b=barrier_b, max_episode_steps=max_episode_steps,
                     step_kwargs=step_kwargs)
    adapter = HostEnvAdapter(shim, spec, has_barrier_signal=True)
    node_adapter = (getattr(env_module, "obs_to_dynamics_state", None)
                    if spec.name == "pvtol" else None)
    if node_adapter is None:
        node_adapter = getattr(env_module, "obs_to_state", None)
    if node_adapter is not None:
        adapter.obs_to_state = node_adapter
    for name in ("state_to_obs", "ground_probe_obs"):
        if hasattr(env_module, name):
            setattr(adapter, name, getattr(env_module, name))
    return adapter
