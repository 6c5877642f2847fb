"""Multi-device precompute and training over ``torch.distributed``
(port of ``s3grl_tpu/parallel``): the mesh and process groups
(``mesh``), the sharded precompute (``dist``) and the weak-scaling harness
(``scaling``)."""
from s3grl_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch
from s3grl_tpu_torch.parallel.dist import (
    dist_power_chain,
    precompute_pos_sharded,
    precompute_sop_sharded,
)

__all__ = [
    "make_mesh",
    "shard_batch",
    "replicate",
    "dist_power_chain",
    "precompute_pos_sharded",
    "precompute_sop_sharded",
]
