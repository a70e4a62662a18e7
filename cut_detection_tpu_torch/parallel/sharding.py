"""Data- and tensor-parallel inference over a mesh (counterpart of
``cut_detection_tpu/parallel/sharding.py``).

The frame axis is embarrassingly parallel through the CNN, so the JAX
package shards each batch over the mesh's ``data`` axis with replicated
parameters and no communication (``sharding.py:1-10``).  The port does
the same in one process: each data row holds its own frozen replica of
the net on its first device (``replicate``), each shard of a batch is
copied there and runs the single-device step, and the outputs come back
to the mesh's first device in frame order.  One host thread uploads
every shard and launches every replica's kernels, so the loop stays the
host's and a shard costs as many launches as a whole batch: over 2 to 4
cards the sharded loop runs at 0.6-0.9x the unsharded one's frames/s
(``PERF.md`` section 5; a thread a card measured slower still).
``segment_videos --data-parallel`` therefore splits its videos over the
cards, a process a card, and batch sharding serves ``serve
--data-parallel`` and the library's ``mesh`` arguments.

Tensor parallelism (``sharding.py:14-17, 43-137``) also splits the
channels over the ``model`` axis: each conv layer's output channels and
each hidden FC layer's output features (``model_param_specs``).
``shard_bundle`` gives every grid entry a frozen copy of its contiguous
slice, and the tensor-parallel step runs every block on each column of
a data row through the block kernels the single-device step launches at
the net's rung, then gathers the channels to every column of the row in
slice order: in one process a copy to each device and a ``torch.cat``
(the codes, at the chained rungs, as the single-device step carries
them between layers).  For the 68K-parameter prod net this is
demonstrative, as in the JAX package, whose CLIs do not reach it
either.

Training does not go through here: it runs one process per card in a
``torch.distributed`` group (``parallel.distributed``), where the batch
statistics and the gradients are reduced over the global batch.
"""

from __future__ import annotations

import functools

import torch

from cut_detection_tpu_torch.models.assembly import (
    folded_input,
    precompute_rings,
)
from cut_detection_tpu_torch.models.layers import ConvBlock, FCBlock
from cut_detection_tpu_torch.parallel.mesh import Mesh
from cut_detection_tpu_torch.utils.profiling import span


def _check_divides(mesh: Mesh, n: int) -> None:
    shards = mesh.shape["data"]
    if n % shards:
        raise ValueError(f"batch of {n} frames must divide over the data "
                         f"axis ({shards} shards)")


def shard_batch(mesh: Mesh, batch) -> list[torch.Tensor]:
    """The leading axis of ``batch`` (a tensor or an array) split into one
    equal chunk per data row, each on the row's first device; raises
    where the axis does not divide."""
    batch = torch.as_tensor(batch)
    _check_divides(mesh, batch.shape[0])
    return [c.to(d) for c, d in zip(batch.tensor_split(mesh.shape["data"]),
                                    mesh.data_devices)]


def replicate(mesh: Mesh, net, *, fold: bool = True) -> list:
    """One frozen copy of ``net`` per data row, on the row's first device
    (``pipeline.frozen_copy``): each holds its own kernel arguments and,
    at ``uint8_chain`` and ``int8_mxu``, computes its own rings."""
    from cut_detection_tpu_torch.pipeline import frozen_copy

    return [frozen_copy(net, fold=fold, device=d) for d in mesh.data_devices]


def sharded(mesh: Mesh, steps: list):
    """``step(frames) -> (conf, pred)`` over the mesh: shard ``frames``,
    run ``steps[i]`` (data row ``i``'s step) on shard ``i``, on the row's
    first device, and gather the outputs on the mesh's first device in
    frame order.  Each shard's upload from the host is synchronous, so a
    host buffer may be reused once the call returns."""
    if len(steps) != mesh.shape["data"]:
        raise ValueError(f"{len(steps)} steps for a mesh of "
                         f"{mesh.shape['data']} data rows")
    first = mesh.devices[0]

    def step(frames):
        with span("cutdet.classify.upload"):
            shards = shard_batch(mesh, frames)
        outs = [s(x) for s, x in zip(steps, shards)]
        return tuple(torch.cat([o[k].to(first) for o in outs])
                     for k in range(2))

    return step


def model_param_specs(net) -> dict[str, int | None]:
    """For each leaf of ``net``'s state dict, the axis that shards over
    the ``model`` axis, or None where the leaf is replicated: JAX's
    ``model_param_specs`` (``sharding.py:43-83``) leaf for leaf, in the
    port's layouts.  Each conv layer's kernel shards its output channels
    (O of JAX's HWIO, axis 0 of torch's OIHW), and so do its bias, BN
    gamma and beta and running mean and var; each hidden FC layer shards
    its output features (axis 1 of JAX's [in, out] kernel, 0 of torch's
    [out, in] weight), bias and BN vectors; the final FC layer, and BN's
    step counter (no JAX leaf), are replicated."""
    final = f"linear.layers.{len(net.linear.layers) - 1}."
    return {key: None if t.dim() == 0 or key.startswith(final) else 0
            for key, t in net.state_dict().items()}


def _cut(state: dict, specs: dict, prefix: str, k: int, m: int) -> dict:
    """The leaves of ``state`` under ``prefix``, without it, each cut to
    model column ``k`` of ``m``'s contiguous slice along its spec's axis,
    as ``P("model")`` splits it."""
    out = {}
    for key, t in state.items():
        if not key.startswith(prefix):
            continue
        axis = specs[key]
        if axis is not None:
            n = t.shape[axis] // m
            t = t.narrow(axis, k * n, n)
        out[key[len(prefix):]] = t
    return out


class ChannelShard:
    """Model column ``k`` of ``m``'s slice of a frozen net, on the
    device of ``whole``, the frozen copy of the whole net it is cut from
    (``pipeline.frozen_copy``: layer 1 takes raw uint8 BGR).

    - ``conv``: each conv block with output channels ``[k*C/m,
      (k+1)*C/m)``, frozen with ``whole``'s kernel arguments sliced
      (``ConvBlock.freeze_slice``);
    - ``hidden``: each hidden FC layer with its slice of the output
      features; ``final``: the final FC layer, whole;
    - ``affines``: at ``uint8_chain`` and ``int8_mxu``, each whole
      layer's pending affine, which the next layer folds along its input
      axis (the gathered codes' affine), else None.
    """

    def __init__(self, whole, specs: dict, k: int, m: int):
        self.whole, self.device = whole, whole.device
        state = whole.state_dict()
        cd = whole.compute_dtype
        self.conv, self.channels = [], []
        for i, wb in enumerate(whole.conv.conv_layers):
            n = wb.conv.out_channels // m
            block = ConvBlock(wb.conv.in_channels, n, cd,
                              feeds_head=wb.feeds_head)
            block.load_state_dict(_cut(state, specs,
                                       f"conv.conv_layers.{i}.", k, m))
            block.to(self.device).requires_grad_(False).eval()
            self.channels.append(slice(k * n, (k + 1) * n))
            block.freeze_slice(wb, self.channels[-1])
            self.conv.append(block)
        linear = []
        for i, wl in enumerate(whole.linear.layers):
            prefix = f"linear.layers.{i}."
            split = specs[prefix + "linear.weight"] is not None
            fc = FCBlock(wl.linear.in_features,
                         wl.linear.out_features // (m if split else 1),
                         hidden=wl.bn is not None, compute_dtype=cd)
            fc.load_state_dict(_cut(state, specs, prefix, k, m))
            linear.append(fc.to(self.device).requires_grad_(False).eval())
        self.hidden, self.final = linear[:-1], linear[-1]
        self.affines = None
        if cd == "int8_mxu":
            self.affines = [b.i8_pending_affine()
                            for b in whole.conv.conv_layers]
        elif cd == "uint8_chain":
            self.affines = [b.u8_pending_affine()
                            for b in whole.conv.conv_layers]
        self._rings: dict = {}

    def rings(self, h: int, w: int) -> list:
        """This column's slice of each layer's ring at an input of ``h`` x
        ``w`` (None for a layer without one): ``assembly.precompute_rings``
        of the whole net, whose rings sum over the whole input width of
        each layer, once per size."""
        if (h, w) not in self._rings:
            whole = precompute_rings(self.whole, h, w)
            self._rings[(h, w)] = [
                None if r is None else r[..., c].contiguous()
                for r, c in zip(whole, self.channels)]
        return self._rings[(h, w)]


def _whole(net, device):
    """The frozen copy of ``net`` on ``device`` that a grid entry's slice
    is cut from: layer 1 folded, and at ``int8_mxu`` each layer's int8
    kernel arguments computed from the whole layers (layer 1 on raw
    pixels, the others on the previous layer's codes)."""
    from cut_detection_tpu_torch.pipeline import frozen_copy

    whole = frozen_copy(net, device=device)
    if net.compute_dtype == "int8_mxu":
        affine = None
        for layer in whole.conv.conv_layers:
            layer.i8_args(affine)
            affine = layer.i8_pending_affine()
    return whole


def shard_bundle(mesh: Mesh, net, *, tensor_parallel: bool = False) -> list:
    """Place ``net`` on the mesh: ``replicate``'s copies, or, with
    ``tensor_parallel``, a ``ChannelShard`` for every grid entry in the
    mesh's order, model column ``k`` holding channels ``[k*C/m,
    (k+1)*C/m)`` of every sharded leaf (``model_param_specs``).  Raises
    where a sharded axis does not divide over the ``model`` axis, as
    JAX's placement does."""
    if not tensor_parallel:
        return replicate(mesh, net)
    m = mesh.shape["model"]
    specs = model_param_specs(net)
    state = net.state_dict()
    for key, axis in specs.items():
        if axis is not None and state[key].shape[axis] % m:
            raise ValueError(f"{key}: {state[key].shape[axis]} channels do "
                             f"not divide over the model axis ({m} columns)")
    wholes = {d: _whole(net, d) for d in dict.fromkeys(mesh.devices)}
    return [ChannelShard(wholes[d], specs, i % m, m)
            for i, d in enumerate(mesh.devices)]


def _gather(devices, parts: list) -> dict:
    """A row's channel slices ``parts`` gathered to each of its
    ``devices``: a copy of each to the device and a ``torch.cat`` on the
    channel (last) axis, in slice order; ``{device: whole tensor}``."""
    return {d: torch.cat([p.to(d) for p in parts], dim=-1) for d in devices}


def _tensor_parallel_step(net, mesh: Mesh):
    """See ``make_sharded_classify_step``."""
    shards = shard_bundle(mesh, net, tensor_parallel=True)
    data, m = mesh.shape["data"], mesh.shape["model"]
    rows = [shards[i * m:(i + 1) * m] for i in range(data)]
    chain = {"uint8_chain": ConvBlock.forward_u8_chain,
             "int8_mxu": ConvBlock.forward_i8_chain}.get(net.compute_dtype)

    @torch.inference_mode()
    def run_row(row, frames):
        # One shard a device of the row: the columns on a device share
        # its whole copy, so its head and affines.
        by_device = {s.device: s for s in row}
        x = folded_input(frames)
        rings = [s.rings(*x.shape[1:3]) for s in row] if chain else None
        xs = {d: x.to(d) for d in by_device}
        for i in range(len(row[0].conv)):
            parts = []
            for j, s in enumerate(row):
                if chain is None:
                    parts.append(s.conv[i](xs[s.device]))
                else:
                    affine = None if i == 0 else s.affines[i - 1]
                    parts.append(chain(s.conv[i], xs[s.device], affine,
                                       rings[j][i])[0])
            xs = _gather(by_device, parts)
        feats = {d: s.whole.conv.head(xs[d], s.affines[-1] if chain else None)
                 for d, s in by_device.items()}
        for i in range(len(row[0].hidden)):
            feats = _gather(by_device,
                            [s.hidden[i](feats[s.device]) for s in row])
        # The final layer is replicated: each column would compute the
        # same logits, so the row's first computes them once.
        logits = row[0].final(feats[row[0].device])
        return logits.amax(dim=1), logits.argmax(dim=1).to(torch.int32)

    return sharded(mesh, [functools.partial(run_row, row) for row in rows])


def make_sharded_classify_step(net, mesh: Mesh, *,
                               tensor_parallel: bool = False):
    """Sharded inference: uint8 NHWC BGR ``[B, H, W, 3]`` (on the host or
    any device; ``B`` divisible by the data axis) -> ``(conf f32 [B], pred
    int32 [B])`` on the mesh's first device, in frame order.

    Without ``tensor_parallel``: the production step,
    ``pipeline.make_classify_step(net, mesh=mesh)``, with the BGR flip
    and /255 folded into layer 1 where the JAX step normalizes ahead of
    an unfolded net (the same classes, conf within 1e-5 at float32).

    With it: each data row takes its shard of the frames, and each model
    column of the row runs every conv block on its own output channels
    (``shard_bundle``) through the kernels the single-device step
    launches at the net's rung (``conv1_block`` on the raw pixels with
    the preprocess folded in, ``conv_block``, their int8 instances at
    ``int8_mxu``; plain PyTorch at the uint8 rungs), the row gathering
    the channels to every column after each block (``_gather``).  The
    head pools and flattens the gathered features, each column computes
    its slice of each hidden FC layer, gathered likewise, and the final
    layer, max and argmax run on the row's first column.  Each block
    kernel is launched (data rows x model columns) times a batch for
    each layer that runs it.  Raises where ``B`` does not divide over the
    data axis or a sharded axis over the model axis.
    """
    if tensor_parallel:
        return _tensor_parallel_step(net, mesh)
    from cut_detection_tpu_torch.pipeline import make_classify_step

    return make_classify_step(net, mesh=mesh)
