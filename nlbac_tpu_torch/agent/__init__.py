from nlbac_tpu_torch.agent.state import (  # noqa: F401
    TrainState,
    create_train_state,
    make_optimizers,
)
from nlbac_tpu_torch.agent.update import Agent, make_agent  # noqa: F401
