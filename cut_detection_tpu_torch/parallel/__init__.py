"""Several devices and several processes (counterpart of
``cut_detection_tpu/parallel/``).

- ``mesh``: ``make_mesh`` lays one process's devices out as a (data,
  model) grid.
- ``sharding``: inference over a mesh, shards in and outputs out in
  frame order: data-parallel, one frozen replica of the net a data row,
  or tensor-parallel, each grid entry holding its slice of every layer's
  channels (``model_param_specs``, ``shard_bundle``).
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
    model_param_specs,
    replicate,
    shard_batch,
    shard_bundle,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "mesh_shape_for",
    "replicate",
    "shard_batch",
    "model_param_specs",
    "shard_bundle",
    "make_sharded_classify_step",
]
