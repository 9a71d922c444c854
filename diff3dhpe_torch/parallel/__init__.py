from diff3dhpe_torch.parallel.mesh import (
    DataMesh,
    check_mesh_shape,
    entry_ranks,
    parse_mesh_shape,
    rank_device,
    start_ranks,
)
from diff3dhpe_torch.parallel.tensor import (
    check_divisible,
    check_params_replicated,
    copy_to_model,
    full_param_count,
    gather_optimizer_state,
    gather_params,
    param_sharding_rules,
    reduce_from_model,
    shard_model,
    shard_optimizer_state,
    shard_params,
    WholeWeights,
)

__all__ = ["DataMesh", "check_divisible", "check_mesh_shape", "check_params_replicated",
           "copy_to_model", "entry_ranks", "full_param_count", "gather_optimizer_state",
           "gather_params", "param_sharding_rules", "parse_mesh_shape",
           "rank_device", "reduce_from_model", "shard_model", "shard_optimizer_state",
           "shard_params", "start_ranks", "WholeWeights"]
