"""Data-parallel inference over a mesh (counterpart of
``cut_detection_tpu/parallel/sharding.py``).

The frame axis is embarrassingly parallel through the CNN, so the JAX
package shards each batch over the mesh's ``data`` axis with replicated
parameters and no communication (``sharding.py:1-10``).  The port does
the same in one process: each mesh entry holds its own frozen replica of
the net (``replicate``), each shard of a batch is copied to its device and
runs the single-device step there, and the outputs come back to the
mesh's first device in frame order.  One host thread uploads every
shard and launches every replica's kernels, so the loop stays the
host's and a shard costs as many launches as a whole batch: over 2 to 4
cards the sharded loop runs at 0.6-0.9x the unsharded one's frames/s
(``PERF.md`` section 5; a thread a card measured slower still).
``segment_videos --data-parallel`` therefore splits its videos over the
cards, a process a card, and batch sharding serves ``serve
--data-parallel`` and the library's ``mesh`` arguments.

Training does not go through here: it runs one process per card in a
``torch.distributed`` group (``parallel.distributed``), where the batch
statistics and the gradients are reduced over the global batch.  Tensor
parallelism (``model_param_specs``, ``shard_bundle``) is not ported
(ROADMAP.md Queue 1).
"""

from __future__ import annotations

import torch

from cut_detection_tpu_torch.parallel.mesh import Mesh


def _check_divides(mesh: Mesh, n: int) -> None:
    shards = mesh.shape["data"]
    if n % shards:
        raise ValueError(f"batch of {n} frames must divide over the data "
                         f"axis ({shards} shards)")


def shard_batch(mesh: Mesh, batch) -> list[torch.Tensor]:
    """The leading axis of ``batch`` (a tensor or an array) split into one
    equal chunk per mesh entry, each on its device; raises where the axis
    does not divide."""
    batch = torch.as_tensor(batch)
    _check_divides(mesh, batch.shape[0])
    return [c.to(d) for c, d in zip(batch.tensor_split(mesh.shape["data"]),
                                    mesh.devices)]


def replicate(mesh: Mesh, net, *, fold: bool = True) -> list:
    """One frozen copy of ``net`` per mesh entry, on its device
    (``pipeline.frozen_copy``): each holds its own kernel arguments and,
    at ``uint8_chain`` and ``int8_mxu``, computes its own rings."""
    from cut_detection_tpu_torch.pipeline import frozen_copy

    return [frozen_copy(net, fold=fold, device=d) for d in mesh.devices]


def sharded(mesh: Mesh, steps: list):
    """``step(frames) -> (conf, pred)`` over the mesh: shard ``frames``,
    run ``steps[i]`` (a single-device step) on shard ``i``, and gather
    the outputs on the mesh's first device in frame order.  Each shard's
    upload from the host is synchronous, so a host buffer may be reused
    once the call returns."""
    if len(steps) != mesh.shape["data"]:
        raise ValueError(f"{len(steps)} steps for a mesh of "
                         f"{mesh.shape['data']} devices")
    first = mesh.devices[0]

    def step(frames):
        outs = [s(x) for s, x in zip(steps, shard_batch(mesh, frames))]
        return tuple(torch.cat([o[k].to(first) for o in outs])
                     for k in range(2))

    return step


def make_sharded_classify_step(net, mesh: Mesh):
    """Sharded inference: uint8 NHWC BGR ``[B, H, W, 3]`` (on the host or
    any device; ``B`` divisible by the data axis) -> ``(conf f32 [B], pred
    int32 [B])`` on the mesh's first device, in frame order: the
    production step, ``pipeline.make_classify_step(net, mesh=mesh)``, with
    the BGR flip and /255 folded into layer 1 where the JAX step
    normalizes ahead of an unfolded net (the same classes, conf within
    1e-5 at float32)."""
    from cut_detection_tpu_torch.pipeline import make_classify_step

    return make_classify_step(net, mesh=mesh)
