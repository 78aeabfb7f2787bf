"""Seed-, data- and tensor-parallel training (port of
``nlbac_tpu/parallel``): one process per rank, the collectives written
out (``mesh``), Megatron layouts (``tp``), the dp/tp runners
(``runners``; every NODE solver, dopri5 included, whose error norms span
the gang), the seed runner in worker processes (``seeds``), the lockstep
seed runner that trains N seeds in one seed-batched episode loop on one
device, or in shards over several (``lockstep``), and the local gang
launcher (``launch``)."""

from nlbac_tpu_torch.parallel.launch import run_gang  # noqa: F401
from nlbac_tpu_torch.parallel.lockstep import (  # noqa: F401
    ShardedSeedRunner,
    episode_to_host_seeds,
    make_seed_parallel_runner,
)
from nlbac_tpu_torch.parallel.mesh import (  # noqa: F401
    Comm,
    ProcessGrid,
    device_for_rank,
    free_port,
    init_distributed,
    is_rank0,
    make_grids,
    make_mesh,
    proc_id,
    statistics_scalar,
    world_size,
)
from nlbac_tpu_torch.parallel.runners import (  # noqa: F401
    broadcast,
    make_dp_episode_runner,
    make_dp_update,
    make_parallel_runner,
    make_tp_episode_runner,
)
from nlbac_tpu_torch.parallel.seeds import (  # noqa: F401
    make_async_seed_runner,
    state_arrays,
)
from nlbac_tpu_torch.parallel.tp import (  # noqa: F401
    _tp_param_specs,
    gather_state_tp,
    shard_bytes,
    shard_params_tp,
    shard_state_tp,
)
