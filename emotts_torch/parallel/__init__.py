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
from emotts_torch.parallel.tp import (
    ModelAxis,
    gather_state_dict,
    shard_dim,
    shard_module_,
    shard_state_dict,
)

__all__ = [
    "Mesh",
    "ModelAxis",
    "RowDraws",
    "average_gradients",
    "data_axis_size",
    "draw_rows",
    "gather_state_dict",
    "global_sum",
    "make_mesh",
    "replicate",
    "round_up_to_multiple",
    "row_draws",
    "shard_batch",
    "shard_dim",
    "shard_module_",
    "shard_state_dict",
]
