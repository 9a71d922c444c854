from diff3dhpe_torch.parallel.mesh import (
    DataMesh,
    check_mesh_shape,
    entry_ranks,
    parse_mesh_shape,
    rank_device,
    start_ranks,
)

__all__ = ["DataMesh", "check_mesh_shape", "entry_ranks", "parse_mesh_shape", "rank_device",
           "start_ranks"]
