"""The port's tensor parallelism (``parallel.mesh`` with a model axis,
``model_param_specs``, ``shard_bundle`` and ``make_sharded_classify_step
(..., tensor_parallel=True)``) against the JAX package's, on the CPU.

The port's grids of CPU entries stand where the JAX tests use the 8
virtual CPU devices (``tests/test_parallel.py:109-128``), on the same
seeded 8 x 36 x 64 frames (``rng(1)``):

- the mesh lays the devices out in JAX's (data, model) order, and
  ``model_parallel=3`` of 8 raises;
- ``model_param_specs`` shards the leaves JAX's spec tree shards, on the
  same axis mapped to the port's layouts (OIHW kernels, [out, in] FC
  weights), leaf for leaf;
- at float32, model 2 and 4, the tensor-parallel step against JAX's:
  conf within 1e-5 (the port's folded step is 4.8e-6 from JAX's
  normalized one, ``test_torch_parallel.py``) and pred equal; at
  ``int8_mxu`` pred equal (an off-by-one code moves the tiny maps' conf
  by up to 0.075, as ``test_torch_parallel.py`` says);
- against the port's unsharded step at all six rungs at model 2 and at
  float32 and ``int8_mxu`` at model 4: pred equal, conf within 1e-5 at
  float32 and ``QUANT_CONF_TOL`` elsewhere (on the CPU the slices'
  kernel arguments are the whole layers' bit for bit, and the conf came
  out equal); each conv layer runs through its block wrapper once a grid
  entry a batch, at ``48 / model`` output channels;
- ``shard_bundle``'s slices are the folded net's, cut along the specs,
  and their kernel arguments the whole blocks', sliced;
- the data-parallel step on a model-2 mesh splits frames over the four
  data rows only and equals the unsharded step;
- a batch or a channel count that does not divide raises.
"""

import jax
import numpy as np
import pytest
import torch

from cut_detection_tpu.models.assembly import load_default_net as jax_default
from cut_detection_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cut_detection_tpu.parallel.sharding import (
    make_sharded_classify_step as jax_sharded_step,
)
from cut_detection_tpu.parallel.sharding import (
    model_param_specs as jax_specs,
)
from cut_detection_tpu.parallel.sharding import shard_batch as jax_shard
from cut_detection_tpu.parallel.sharding import (
    shard_bundle as jax_shard_bundle,
)
from cut_detection_tpu_torch import pipeline
from cut_detection_tpu_torch.models import layers
from cut_detection_tpu_torch.models.assembly import (
    PORTED_PRECISIONS,
    fold_preprocess,
    load_default_net,
)
from cut_detection_tpu_torch.parallel import (
    make_mesh,
    make_sharded_classify_step,
    model_param_specs,
    shard_batch,
    shard_bundle,
)
from cut_detection_tpu_torch.parallel.sharding import ChannelShard

CPU = torch.device("cpu")
QUANT_CONF_TOL = 2e-2  # chip_smoke.QUANT_CONF_TOL
FRAMES = np.random.default_rng(1).integers(0, 256, size=(8, 36, 64, 3),
                                           dtype=np.uint8)


def _jax_tp(precision, model):
    """JAX's tensor-parallel step on its 8 virtual devices."""
    jnet, _ = jax_default(precision=precision)
    mesh = jax_make_mesh(jax.devices()[:8], model_parallel=model)
    step = jax_sharded_step(jnet, mesh, tensor_parallel=True)
    conf, pred = step(jax_shard_bundle(mesh, jnet.bundle,
                                       tensor_parallel=True),
                      jax_shard(mesh, FRAMES))
    return np.asarray(conf), np.asarray(pred)


def test_mesh_grid_in_jax_order():
    mesh = make_mesh([CPU] * 8, model_parallel=2)
    assert mesh.shape == {"data": 4, "model": 2}
    assert hash(mesh) == hash(make_mesh(["cpu"] * 8, model_parallel=2))
    assert mesh != make_mesh([CPU] * 8)
    # Distinct devices show the order (no card is touched to name one).
    cards = [torch.device("cuda", i) for i in range(8)]
    for model in (1, 2, 4, 8):
        ours = make_mesh(cards, model_parallel=model)
        ids = np.vectorize(lambda d: d.id)(np.asarray(
            jax_make_mesh(jax.devices()[:8], model_parallel=model).devices))
        assert ids.shape == (8 // model, model)
        assert np.array([d.index for d in ours.devices]).reshape(
            -1, model).tolist() == ids.tolist()
        assert [d.index for d in ours.data_devices] == ids[:, 0].tolist()
    with pytest.raises(ValueError, match="must divide"):
        make_mesh([CPU] * 8, model_parallel=3)


def test_model_param_specs_match_jax():
    """JAX's ``P`` tree mapped to an axis of the port's layout: a conv
    kernel's HWIO axis 3 is OIHW's 0, an FC kernel's [in, out] axis 1 is
    [out, in]'s 0; vectors keep theirs."""
    jnet, _ = jax_default()
    net, _ = load_default_net(CPU)
    theirs = jax_specs(jnet.bundle)

    def axis(spec, perm=None):
        names = tuple(spec)
        if "model" not in names:
            return None
        a = names.index("model")
        return a if perm is None else perm.index(a)

    want = {}
    for group, part, key in (("conv", "conv_layers", "conv"),
                             ("linear", "layers", "linear")):
        for i, (p, s) in enumerate(zip(theirs[group]["params"],
                                       theirs[group]["state"])):
            pfx = f"{group}.{part}.{i}."
            want[pfx + f"{key}.weight"] = axis(
                p["kernel"], (3, 2, 0, 1) if group == "conv" else (1, 0))
            want[pfx + f"{key}.bias"] = axis(p["bias"])
            if "gamma" in p:
                want[pfx + "bn.weight"] = axis(p["gamma"])
                want[pfx + "bn.bias"] = axis(p["beta"])
                want[pfx + "bn.running_mean"] = axis(s["mean"])
                want[pfx + "bn.running_var"] = axis(s["var"])
                want[pfx + "bn.num_batches_tracked"] = None  # no JAX leaf
    ours = model_param_specs(net)
    assert ours == want
    assert ours["linear.layers.1.linear.weight"] is None
    assert ours["conv.conv_layers.2.conv.weight"] == 0


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("precision", ["float32", "int8_mxu"])
def test_tensor_parallel_step_matches_jax(precision, model):
    jconf, jpred = _jax_tp(precision, model)
    net, _ = load_default_net(CPU, precision)
    mesh = make_mesh([CPU] * 8, model_parallel=model)
    conf, pred = make_sharded_classify_step(net, mesh,
                                            tensor_parallel=True)(FRAMES)
    assert conf.shape == (8,) and conf.dtype == torch.float32
    assert pred.dtype == torch.int32
    np.testing.assert_array_equal(pred.numpy(), jpred)
    if precision == "float32":
        np.testing.assert_allclose(conf.numpy(), jconf, rtol=0, atol=1e-5)


def _count_blocks(monkeypatch):
    """Count the block wrappers' calls from the blocks, by (wrapper,
    output channels)."""
    calls = {}

    def counted(name, fn):
        def call(x, kernel, *args, **kw):
            key = (name, kernel.shape[-1])
            calls[key] = calls.get(key, 0) + 1
            return fn(x, kernel, *args, **kw)
        return call

    for name in ("conv1_block", "conv_block", "conv1_block_i8",
                 "conv_block_i8"):
        monkeypatch.setattr(layers, name, counted(name,
                                                  getattr(layers, name)))
    return calls


# The block wrappers each rung's layers call: layer 1, then 2 and 3.
RUNG_BLOCKS = {"float32": ("conv1_block", "conv_block"),
               "bfloat16": ("conv1_block", "conv_block"),
               "bfloat16_full": ("conv1_block", "conv_block"),
               "int8_mxu": ("conv1_block_i8", "conv_block_i8")}


@pytest.mark.parametrize("precision,model",
                         [(p, 2) for p in PORTED_PRECISIONS]
                         + [("float32", 4), ("int8_mxu", 4)])
def test_tensor_parallel_step_matches_unsharded(monkeypatch, precision,
                                                model):
    net, _ = load_default_net(CPU, precision)
    conf1, pred1 = pipeline.make_classify_step(net)(torch.from_numpy(FRAMES))
    mesh = make_mesh([CPU] * 8, model_parallel=model)
    step = make_sharded_classify_step(net, mesh, tensor_parallel=True)
    calls = _count_blocks(monkeypatch)
    conf, pred = step(FRAMES)
    np.testing.assert_array_equal(pred.numpy(), pred1.numpy())
    np.testing.assert_allclose(conf.numpy(), conf1.numpy(), rtol=0,
                               atol=1e-5 if precision == "float32"
                               else QUANT_CONF_TOL)
    first, mid = RUNG_BLOCKS.get(precision, (None, None))
    want = {} if first is None else {(first, 48 // model): 8,
                                     (mid, 48 // model): 16}
    assert calls == want


def test_shard_bundle():
    net, _ = load_default_net(CPU, "int8_mxu")
    mesh = make_mesh([CPU] * 8, model_parallel=4)
    replicas = shard_bundle(mesh, net)
    assert len(replicas) == 2 and all(r.precision == "int8_mxu"
                                      for r in replicas)
    shards = shard_bundle(mesh, net, tensor_parallel=True)
    assert len(shards) == 8 and all(isinstance(s, ChannelShard)
                                    for s in shards)
    folded = fold_preprocess(net.state_dict())
    for i, s in enumerate(shards):
        k = i % 4
        c = slice(12 * k, 12 * (k + 1))
        for j, (block, whole) in enumerate(zip(s.conv,
                                               s.whole.conv.conv_layers)):
            pfx = f"conv.conv_layers.{j}."
            assert torch.equal(block.conv.weight,
                               folded[pfx + "conv.weight"][c])
            assert torch.equal(block.bn.running_var,
                               folded[pfx + "bn.running_var"][c])
            for got, full in zip(block.kernel_args(), whole.kernel_args()):
                assert torch.equal(got, full[..., c])
            branch = "pixels" if j == 0 else "codes"
            for got, full in zip(block._i8_frozen[branch],
                                 whole._i8_frozen[branch]):
                assert torch.equal(got, full[..., c])
        hidden, = s.hidden
        assert torch.equal(hidden.linear.weight,
                           folded["linear.layers.0.linear.weight"][8 * k:
                                                                  8 * k + 8])
        assert torch.equal(s.final.linear.weight,
                           folded["linear.layers.1.linear.weight"])
        assert len(s.affines) == 3 and s.affines[0][0].shape == (48,)


def test_data_parallel_on_a_model_mesh_shards_over_data_only():
    net, _ = load_default_net(CPU)
    mesh = make_mesh([CPU] * 8, model_parallel=2)
    frames = np.random.default_rng(0).integers(0, 256, (16, 36, 64, 3),
                                               dtype=np.uint8)
    assert [c.shape[0] for c in shard_batch(mesh, frames)] == [4] * 4
    step = make_sharded_classify_step(net, mesh)
    assert step is pipeline.make_classify_step(net, mesh=mesh)
    conf, pred = step(frames)
    conf1, pred1 = pipeline.make_classify_step(net)(torch.from_numpy(frames))
    np.testing.assert_allclose(conf.numpy(), conf1.numpy(), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(pred.numpy(), pred1.numpy())


def test_what_does_not_divide_raises():
    net, _ = load_default_net(CPU)
    step = make_sharded_classify_step(
        net, make_mesh([CPU] * 8, model_parallel=2), tensor_parallel=True)
    with pytest.raises(ValueError, match="must divide over the data axis"):
        step(FRAMES[:6])
    # 48 conv channels divide over 3 columns, the 32 hidden features not;
    # JAX's placement raises there too.
    with pytest.raises(ValueError, match="linear.layers.0.linear.weight: "
                       "32 channels do not divide over the model axis"):
        make_sharded_classify_step(net, make_mesh([CPU] * 6,
                                                  model_parallel=3),
                                   tensor_parallel=True)
    jnet, _ = jax_default()
    with pytest.raises(ValueError):
        jax_shard_bundle(jax_make_mesh(jax.devices()[:6], model_parallel=3),
                         jnet.bundle, tensor_parallel=True)
