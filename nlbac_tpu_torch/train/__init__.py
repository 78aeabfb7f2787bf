from nlbac_tpu_torch.train.driver import (  # noqa: F401
    EpisodeMetrics,
    create_replays,
    make_episode_runner,
)
from nlbac_tpu_torch.train.supervisor import (  # noqa: F401
    SupervisorState,
    backup_active,
    init_supervisor,
    post_step,
    pre_action,
)
