from emotts_torch.parallel.mesh import (
    Mesh,
    RowDraws,
    average_gradients,
    data_axis_size,
    draw_rows,
    global_sum,
    make_mesh,
    replicate,
    round_up_to_multiple,
    row_draws,
    shard_batch,
)
from emotts_torch.parallel.tp import refuse_model_parallel

__all__ = [
    "Mesh",
    "RowDraws",
    "average_gradients",
    "data_axis_size",
    "draw_rows",
    "global_sum",
    "make_mesh",
    "refuse_model_parallel",
    "replicate",
    "round_up_to_multiple",
    "row_draws",
    "shard_batch",
]
