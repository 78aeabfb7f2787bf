from nlbac_tpu_torch.replay.buffer import (  # noqa: F401
    SCALAR_FIELDS,
    Replay,
    create,
    make_layout,
    push,
    push_row,
    record_from_step,
    sample,
    unpack_rows,
)
