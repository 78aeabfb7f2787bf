from nlbac_tpu_torch.utils.output import (  # noqa: F401
    get_output_folder,
    setup_logger_kwargs,
)
from nlbac_tpu_torch.utils.serialization import convert_json  # noqa: F401
from nlbac_tpu_torch.utils.grid import ExperimentGrid  # noqa: F401
from nlbac_tpu_torch.utils.math import (  # noqa: F401
    rot_2d,
    rotate,
    scale_action,
    unscale_action,
    wrap_angle,
)
