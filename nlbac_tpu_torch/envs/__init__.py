from nlbac_tpu_torch.envs import cars, pvtol, unicycle  # noqa: F401
from nlbac_tpu_torch.envs.base import EnvSpec, StepOut  # noqa: F401

_ENVS = {"unicycle": unicycle, "cars": cars, "pvtol": pvtol}


def get_env(name: str):
    """name -> env module. The unicycle, cars and pvtol envs are ported;
    the quadrotor is not yet (ROADMAP.md)."""
    if name not in _ENVS:
        raise ValueError(f"env {name!r} is not ported; ported envs: "
                         f"{list(_ENVS)}")
    return _ENVS[name]
