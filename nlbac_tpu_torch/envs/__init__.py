from nlbac_tpu_torch.envs import unicycle  # noqa: F401
from nlbac_tpu_torch.envs.base import EnvSpec, StepOut  # noqa: F401

_ENVS = {"unicycle": unicycle}


def get_env(name: str):
    """name -> env module. Only the unicycle env is ported so far."""
    if name not in _ENVS:
        raise ValueError(f"env {name!r} is not ported; ported envs: "
                         f"{list(_ENVS)}")
    return _ENVS[name]
