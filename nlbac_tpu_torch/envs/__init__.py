from nlbac_tpu_torch.envs import cars, pvtol, quadrotor, unicycle  # noqa: F401
from nlbac_tpu_torch.envs.base import EnvSpec, StepOut  # noqa: F401
from nlbac_tpu_torch.envs.host_adapter import (  # noqa: F401
    HostEnvAdapter,
    make_host_env,
)
from nlbac_tpu_torch.envs.host_shim import as_host_env  # noqa: F401

_ENVS = {"unicycle": unicycle, "cars": cars, "pvtol": pvtol,
         "quadrotor": quadrotor}


def get_env(name: str):
    """name -> env module: the four built-in envs and those registered
    with ``register_env``."""
    if name not in _ENVS:
        raise ValueError(
            f"unknown env {name!r}; options: {list(_ENVS)}. Third-party "
            "envs must be registered with nlbac_tpu_torch.envs.register_env "
            "in EVERY process — e.g. evaluating a custom-env run dir "
            "requires importing/registering your env module first "
            "(registration is per-process, not persisted)")
    return _ENVS[name]


def register_env(name: str, module) -> None:
    """Register a third-party env so ``EnvConfig(name=...)`` resolves to
    it. ``module`` is anything (a module, a SimpleNamespace, a class)
    exposing the contract of :mod:`nlbac_tpu_torch.envs.base`::

        SPEC: EnvSpec
        reset(device, gen=None, max_episode_steps=...) -> (EnvState, obs)
        step(state, action, *, barrier_B=..., barrier_b=...,
             max_episode_steps=...) -> (EnvState, StepOut)
        obs_to_state(obs) / state_to_obs(state)   # NODE-space adapters

    Re-registering the SAME object under its name is a no-op; binding a
    name to a DIFFERENT object (a built-in env's included) raises, since
    silent shadowing would re-route every preset using that name."""
    if name in _ENVS and _ENVS[name] is not module:
        raise ValueError(f"env name {name!r} is already registered")
    required = ("SPEC", "reset", "step", "obs_to_state", "state_to_obs")
    missing = [a for a in required if not hasattr(module, a)]
    if missing:
        raise ValueError(
            f"env module for {name!r} is missing required attributes "
            f"{missing}; see nlbac_tpu_torch/envs/base.py for the contract")
    if not isinstance(module.SPEC, EnvSpec):
        raise ValueError(f"{name!r}.SPEC must be an EnvSpec, got "
                         f"{type(module.SPEC).__name__}")
    _ENVS[name] = module
