from nlbac_tpu_torch.nn.critics import (  # noqa: F401
    barrier_apply,
    barrier_init,
    lyapunov_apply,
    lyapunov_init,
    soft_update,
    twin_q_apply,
    twin_q_init,
    twin_q_stack,
    twin_q_unstack,
    value_apply,
    value_init,
)
from nlbac_tpu_torch.nn.adam import SeedAdam  # noqa: F401
from nlbac_tpu_torch.nn.mlp import (  # noqa: F401
    TPShard,
    mlp_apply,
    mlp_init,
    mlp_sizes,
    xavier_uniform,
)
from nlbac_tpu_torch.nn.node import (  # noqa: F401
    apply_grads,
    make_field,
    node_init,
    node_loss,
    node_train_step,
    pack_input,
    predict_next_state,
    seed_mean,
    uses_euler_kernel,
)
from nlbac_tpu_torch.nn.policy import (  # noqa: F401
    DEFAULT_SQUASH,
    ActionSpec,
    deterministic_policy_init,
    deterministic_policy_sample,
    gaussian_policy_forward,
    gaussian_policy_init,
    gaussian_policy_sample,
    policy_mean_action,
)
