from d3dp_tpu_torch.parallel.mesh import (
    Mesh,
    auto_mesh,
    batch_rows,
    gather_rows,
    make_mesh,
    process_index,
    put_global,
    rank_noise,
    round_up_batch,
    shard_batch_fn,
    step_noise_rows,
)
from d3dp_tpu_torch.parallel.multihost import host_slice, initialize_multihost, spawn

__all__ = ["Mesh", "auto_mesh", "batch_rows", "gather_rows", "make_mesh", "process_index",
           "put_global", "rank_noise", "round_up_batch", "shard_batch_fn", "step_noise_rows",
           "host_slice", "initialize_multihost", "spawn"]
