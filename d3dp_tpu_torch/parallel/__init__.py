from d3dp_tpu_torch.parallel.mesh import (
    Mesh,
    auto_mesh,
    batch_rows,
    gather_params,
    gather_rows,
    join_state_dicts,
    make_mesh,
    mixste_param_spec,
    process_index,
    put_global,
    rank_noise,
    round_up_batch,
    shard_batch_fn,
    shard_model_params,
    shard_params,
    split_state_dict,
    step_noise_rows,
)
from d3dp_tpu_torch.parallel.multihost import host_slice, initialize_multihost, spawn
from d3dp_tpu_torch.parallel.tp import copy_to_tp, reduce_from_tp

__all__ = ["Mesh", "auto_mesh", "batch_rows", "gather_params", "gather_rows",
           "join_state_dicts", "make_mesh", "mixste_param_spec",
           "process_index", "put_global", "rank_noise", "round_up_batch", "shard_batch_fn",
           "shard_model_params", "shard_params", "split_state_dict", "step_noise_rows",
           "host_slice", "initialize_multihost", "spawn", "copy_to_tp", "reduce_from_tp"]
