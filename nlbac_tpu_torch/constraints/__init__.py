from nlbac_tpu_torch.constraints import unicycle
from nlbac_tpu_torch.constraints.common import (  # noqa: F401
    LagrangianState,
    ascend_multipliers,
    backup_loss,
    filtered_means,
    grow_rho,
    init_lagrangian,
    primary_loss,
)

_BUILDERS = {"unicycle": unicycle}


def get_builder(kind: str):
    """kind -> constraint-builder module (terms, NUM_PRIMARY, NUM_BACKUP).
    Only the unicycle builder is ported so far."""
    if kind not in _BUILDERS:
        raise ValueError(f"constraint kind {kind!r} is not ported; ported "
                         f"kinds: {list(_BUILDERS)}")
    return _BUILDERS[kind]


def uses_barrier(kind: str) -> bool:
    """Whether the builder trains a learned barrier critic."""
    return bool(getattr(get_builder(kind), "USES_BARRIER", False))
