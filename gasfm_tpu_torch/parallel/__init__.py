"""Multi-device execution of the port: the (data, edge) mesh on
torch.distributed (``edge_sharding``) and the launcher of its ranks
(``launch``). Counterpart of the JAX package's ``gasfm_tpu/parallel``."""

from gasfm_tpu_torch.parallel.edge_sharding import (
    Mesh,
    make_mesh,
    mesh_shape_from_conf,
    pad_scene_group,
)
from gasfm_tpu_torch.parallel.launch import run_ranks

__all__ = ["Mesh", "make_mesh", "mesh_shape_from_conf", "pad_scene_group", "run_ranks"]
