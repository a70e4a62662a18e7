"""The port's data-parallel inference (``parallel.mesh``, ``sharding``
and the pipeline's ``mesh``) against the JAX package's, on the CPU.

The port's mesh of 8 CPU entries, each with a replica of its own, stands
where the JAX tests use the 8 virtual CPU devices
(``tests/test_parallel.py:29-107``), on the same seeded 16 x 36 x 64
frames:

- ``make_classify_step(net, mesh=...)``, the step ``segment_videos`` and
  ``serve`` run, which ``make_sharded_classify_step`` returns: conf
  within 1e-5 of the port's unsharded step, pred equal to it and to
  JAX's mesh steps; at float32 conf within 1e-5 of JAX's
  ``make_classify_step(mesh=...)`` and of its ``make_sharded_classify_step``
  (the frames normalized ahead of an unfolded net; 4.8e-6 measured
  against both);
- at ``int8_mxu``'s fold path the same but the JAX conf: the port's and
  JAX's int8 confidences are not held to 1e-5: an off-by-one code (which
  ``tests/test_torch_int8.py`` allows) moves the 1 x 2 map layer 3 leaves
  of a 36 x 64 frame by up to 0.075 here; that file holds them within
  2e-2 at 144 x 256;
- ``segment_video_file(mesh=...)`` on the synthetic clip writes the
  unsharded port's CSV and JAX's mesh CSV byte for byte;
- a batch that does not divide over the mesh raises naming the division,
  before any decode, and closes a decode-ahead handle it was given; the
  daemon with a mesh answers 200 (its CSV the unsharded port's) and then
  400 for such a batch, as ``tests/test_serve.py:841-870``.
"""

import threading

import jax
import numpy as np
import pytest
import torch

from cut_detection_tpu.models.assembly import load_default_net as jax_default
from cut_detection_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cut_detection_tpu.parallel.sharding import (
    make_sharded_classify_step as jax_sharded_step,
)
from cut_detection_tpu.parallel.sharding import replicate as jax_replicate
from cut_detection_tpu.parallel.sharding import shard_batch as jax_shard
from cut_detection_tpu.pipeline import make_classify_step as jax_step
from cut_detection_tpu.pipeline import segment_video_file as jax_segment
from cut_detection_tpu_torch import pipeline
from cut_detection_tpu_torch.cli import serve
from cut_detection_tpu_torch.models.assembly import load_default_net
from cut_detection_tpu_torch.parallel import (
    make_mesh,
    make_sharded_classify_step,
    mesh_shape_for,
    shard_batch,
)

CPU = torch.device("cpu")
MESH = make_mesh([CPU] * 8)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_mesh_shape_for():
    assert mesh_shape_for(8, 1) == (8, 1)
    assert mesh_shape_for(8, 2) == (4, 2)
    with pytest.raises(ValueError):
        mesh_shape_for(8, 3)


def test_make_mesh(monkeypatch):
    assert MESH.shape == {"data": 8, "model": 1}
    assert MESH.devices == (CPU,) * 8 and hash(MESH) == hash(make_mesh(
        ["cpu"] * 8))
    assert make_mesh([CPU] * 8, model_parallel=2).shape == {"data": 4,
                                                            "model": 2}
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert make_mesh().devices == (torch.device("cuda", 0),
                                   torch.device("cuda", 1))


@pytest.mark.parametrize("precision", ["float32", "int8_mxu"])
def test_sharded_step_matches_jax_and_unsharded(precision):
    jnet, _ = jax_default(precision=precision)
    net, _ = load_default_net(CPU, precision)
    seed = 0 if precision == "float32" else 3
    frames = np.random.default_rng(seed).integers(
        0, 256, size=(16, 36, 64, 3), dtype=np.uint8)
    jmesh = jax_make_mesh(jax.devices()[:8])
    jconf, jpred = jax_step(jnet, mesh=jmesh)(jnet.bundle, frames)
    step = pipeline.make_classify_step(net, mesh=MESH)
    assert make_sharded_classify_step(net, MESH) is step
    conf, pred = step(frames)
    conf1, pred1 = pipeline.make_classify_step(net)(torch.from_numpy(frames))
    assert conf.shape == (16,) and pred.dtype == torch.int32
    np.testing.assert_allclose(conf.numpy(), conf1.numpy(), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(pred.numpy(), pred1.numpy())
    np.testing.assert_array_equal(pred.numpy(), np.asarray(jpred))
    if precision == "float32":
        sconf, spred = jax_sharded_step(jnet, jmesh)(
            jax_replicate(jmesh, jnet.bundle), jax_shard(jmesh, frames))
        np.testing.assert_array_equal(pred.numpy(), np.asarray(spred))
        for theirs in (jconf, sconf):
            np.testing.assert_allclose(conf.numpy(), np.asarray(theirs),
                                       rtol=0, atol=1e-5)


def test_a_batch_that_does_not_divide_raises(synthetic_video):
    with pytest.raises(ValueError, match="must divide over the data axis"):
        shard_batch(MESH, np.zeros((15, 4, 4, 3), np.uint8))
    closed = []
    pre = pipeline.start_decode_ahead(synthetic_video, batch_size=63,
                                      on_close=lambda: closed.append(1))
    net, _ = load_default_net(CPU)
    with pytest.raises(ValueError, match=r"batch_size=63 must divide over "
                       r"the data axis \(8 shards\)"):
        pipeline.classify_video(synthetic_video, net, batch_size=63,
                                preloaded=pre, mesh=MESH)
    assert closed == [1]


@pytest.fixture(scope="module")
def unsharded_csv(synthetic_video, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("unsharded") / "one.csv")
    pipeline.segment_video_file(synthetic_video, out, device=CPU,
                                print_every=0, transfer="bgr")
    return _read(out)


def test_segment_video_file_mesh_csv(synthetic_video, unsharded_csv,
                                     tmp_path):
    ours, theirs = str(tmp_path / "mesh.csv"), str(tmp_path / "jax.csv")
    pipeline.segment_video_file(synthetic_video, ours, device=CPU,
                                print_every=0, transfer="bgr", mesh=MESH)
    jax_segment(synthetic_video, theirs, print_every=0, transfer="bgr",
                decode_process=False, mesh=jax_make_mesh(jax.devices()[:8]))
    assert _read(ours) == unsharded_csv == _read(theirs)


def test_serve_data_parallel_mesh(synthetic_video, unsharded_csv, tmp_path):
    from test_torch_serve import _post

    srv, state = serve.make_server("127.0.0.1", 0, device=CPU, mesh=MESH)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        out = str(tmp_path / "dp.csv")
        status, data = _post(base + "/segment", {
            "input_path": synthetic_video, "output_path": out,
            "batch_size": 64, "transfer": "bgr"})
        assert status == 200 and data["stats"]["frames"] > 0
        assert _read(out) == unsharded_csv
        status, data = _post(base + "/segment", {
            "input_path": synthetic_video, "batch_size": 63})
        assert status == 400
        assert "must divide over the data axis (8 shards)" in data["error"]
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(10)
    assert state.mesh is MESH and not t.is_alive()
