from nlbac_tpu_torch.constraints import (
    cars,
    learned_barrier,
    pvtol,
    unicycle,
)
from nlbac_tpu_torch.constraints.common import (  # noqa: F401
    LagrangianState,
    ascend_multipliers,
    backup_loss,
    filtered_means,
    grow_rho,
    init_lagrangian,
    primary_loss,
)

_BUILDERS = {"unicycle": unicycle, "cars": cars, "pvtol": pvtol,
             "learned_barrier": learned_barrier}


def get_builder(kind: str):
    """kind -> constraint-builder module (terms, NUM_PRIMARY, NUM_BACKUP;
    USES_BARRIER on the learned barrier): the built-in builders and those
    registered with ``register_builder``."""
    if kind not in _BUILDERS:
        raise ValueError(
            f"unknown constraint kind {kind!r}; options: "
            f"{list(_BUILDERS)}. Third-party builders must be "
            "registered with nlbac_tpu_torch.constraints.register_builder "
            "in EVERY process (registration is per-process, not persisted)")
    return _BUILDERS[kind]


def uses_barrier(kind: str) -> bool:
    """Whether the builder trains a learned barrier critic, as it declares
    with ``USES_BARRIER = True`` (the built-in ``learned_barrier`` and any
    registered NBC-style builder)."""
    return bool(getattr(get_builder(kind), "USES_BARRIER", False))


def register_builder(kind: str, module) -> None:
    """Register a third-party constraint builder so
    ``ConstraintConfig(kind=...)`` resolves to it (the companion of
    :func:`nlbac_tpu_torch.envs.register_env`). ``module`` exposes::

        terms(ccfg, ncfg, node_params, field, lyap_params, obs, action,
              lyap_t, dt, include_clf=True, **extras) -> (B, K)
        NUM_PRIMARY: int   # K with the CLF column
        NUM_BACKUP: int    # K of the backup (CBF-only) branch

    ``extras`` hold ``gen``, ``t``/``next_t``, ``env_name``,
    ``barrier_params``, ``resample``, ``shorts`` and ``dp_group`` (pass
    ``shorts`` and ``dp_group`` on to ``predict_next_state``: a
    data-parallel rank's adaptive solves need the group). Optional:
    ``USES_BARRIER = True`` marks an NBC-family builder: ``terms`` then
    reads the live ``barrier_params`` and the ``resample(obs, k)`` closure
    over the current policy, and the agent TD-trains the barrier critic on
    the env's ``barrier_signal`` (examples/torch_custom_barrier_env.py).
    ``SEED_AXIS = True`` declares that ``terms`` also takes a leading seed
    axis, (S, B, .) rows with (S, ...) parameters, indexing only the last
    axes (``x[..., k]``, ``dim=-1``) as the built-in builders do: the
    lockstep seed runner (``parallel.make_seed_parallel_runner``) then
    takes every seed in one call, and calls a builder that does not
    declare it once per seed on that seed's slices.

    Same collision rule as ``register_env``: re-registering the same
    object is a no-op, shadowing a different one raises."""
    if kind in _BUILDERS and _BUILDERS[kind] is not module:
        raise ValueError(f"constraint kind {kind!r} is already registered")
    required = ("terms", "NUM_PRIMARY", "NUM_BACKUP")
    missing = [a for a in required if not hasattr(module, a)]
    if missing:
        raise ValueError(
            f"constraint builder for {kind!r} is missing required "
            f"attributes {missing}")
    _BUILDERS[kind] = module
