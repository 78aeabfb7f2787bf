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
    """name -> env module (all four of the JAX package's envs)."""
    if name not in _ENVS:
        raise ValueError(f"unknown env {name!r}; options: {list(_ENVS)}")
    return _ENVS[name]
