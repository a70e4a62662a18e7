"""Several devices and several processes (counterpart of
``cut_detection_tpu/parallel/``).

- ``mesh``: ``make_mesh`` lists the devices of one process's data axis.
- ``sharding``: data-parallel inference over a mesh, one frozen replica
  of the net per device, shards in and outputs out in frame order.
- ``distributed``: the ``torch.distributed`` group (one rank per card)
  behind multi-host work partitioning and data-parallel training, and
  training's collectives.
- ``local_cluster``: N gloo ranks on the CPU of one machine running what
  a multi-host job runs (``python -m
  cut_detection_tpu_torch.parallel.local_cluster --spawn 2``).
"""

from cut_detection_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    mesh_shape_for,
)
from cut_detection_tpu_torch.parallel.sharding import (
    make_sharded_classify_step,
    replicate,
    shard_batch,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "mesh_shape_for",
    "replicate",
    "shard_batch",
    "make_sharded_classify_step",
]
