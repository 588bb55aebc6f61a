"""Multi-device execution of the port: the (data, edge) mesh on
torch.distributed (``edge_sharding``) and the launcher of its ranks
(``launch``). Counterpart of the JAX package's ``gasfm_tpu/parallel``."""

from gasfm_tpu_torch.parallel.edge_sharding import (
    Distributed,
    Mesh,
    check_table_shard_contract,
    distributed_from_conf,
    make_mesh,
    mesh_shape_from_conf,
    pad_scene_group,
    table_sharding_on,
)
from gasfm_tpu_torch.parallel.launch import run_ranks

__all__ = ["Distributed", "Mesh", "check_table_shard_contract", "distributed_from_conf",
           "make_mesh", "mesh_shape_from_conf", "pad_scene_group", "run_ranks",
           "table_sharding_on"]
