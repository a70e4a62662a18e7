"""``embed_frames`` and ``export_model`` on the CPU, against the JAX CLIs.

The nets are tiny (2 conv layers of 8 channels), written from a seed with
the port's ``save_bundle``: an embedding pair (``{name}_conv.npz``,
``{name}_linear.npz``, ``{name}_embed_params.json``, as the training
CLIs write it) and a classifier triplet.  Tolerances: embeddings within
1e-4 of the JAX CLI's at float32 (summation order) and within the rung's
bar, 1e-2, at ``bfloat16_full``; the exported program, at every rung,
within 1e-5 of the port's net on the CPU (the same plain ops) and within
the rung's ``export_model.EXPORT_TOL`` of JAX's ``net(example)`` (1e-4 at
float32); the ``torch`` format's state dicts equal to the JAX CLI's.
"""

import json
import os

import numpy as np
import pytest
import torch

from cut_detection_tpu.cli import embed_frames as jax_embed
from cut_detection_tpu.cli import export_model as jax_export
from cut_detection_tpu.models.assembly import (
    load_embedding_net as jax_load_embedding_net,
)
from cut_detection_tpu.models.assembly import (
    load_triplet_or_default as jax_load_triplet,
)
from cut_detection_tpu_torch.checkpoint.io import save_bundle
from cut_detection_tpu_torch.cli import embed_frames, export_model
from cut_detection_tpu_torch.config import PRECISION_CHOICES, ModelParams
from cut_detection_tpu_torch.models.assembly import (
    GluedNet,
    load_embedding_net,
    load_triplet_or_default,
)
from test_torch_copies import clip30  # noqa: F401 (a fixture)

CPU = torch.device("cpu")
EMBED = ModelParams(conv_layers=2, conv_channels=8, avg_pool_size=1,
                    linear_layers=2, linear_size=8, linear_output_size=4)
CLASSIFIER = ModelParams(conv_layers=2, conv_channels=8, avg_pool_size=2,
                         linear_layers=2, linear_size=8,
                         linear_output_size=3)
EMBED_TOL = {"float32": 1e-4, "bfloat16_full": 1e-2}


def _seeded_bundle(mp: ModelParams, seed: int) -> dict:
    """A net's weights from ``seed``, with BN running statistics away from
    their initial values so that they take part."""
    net = GluedNet(mp)
    net.init_weights(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    for name, buf in net.named_buffers():
        if name.endswith("running_mean"):
            buf.copy_(torch.from_numpy(rng.normal(
                0, 0.1, buf.shape).astype(np.float32)))
        elif name.endswith("running_var"):
            buf.copy_(torch.from_numpy(rng.uniform(
                0.5, 1.5, buf.shape).astype(np.float32)))
    return net.bundle()


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """The embedding pair ``emb`` and the classifier triplet ``cls``."""
    d = tmp_path_factory.mktemp("models")
    emb = _seeded_bundle(EMBED, 1)
    save_bundle(str(d / "emb_conv.npz"), emb["conv"])
    save_bundle(str(d / "emb_linear.npz"), emb["linear"])
    (d / "emb_embed_params.json").write_text(json.dumps(EMBED.to_dict()))
    cls = _seeded_bundle(CLASSIFIER, 2)
    save_bundle(str(d / "cls_classifier_conv.npz"), cls["conv"])
    save_bundle(str(d / "cls_classifier_linear.npz"), cls["linear"])
    (d / "cls_model_params.json").write_text(
        json.dumps(CLASSIFIER.to_dict()))
    return str(d)


@pytest.fixture(scope="module")
def frame_dir(tmp_path_factory):
    """40 seeded 72x128 JPEGs ``frame_%07d.jpg``."""
    import cv2

    d = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(40)
    for i in range(40):
        cv2.imwrite(str(d / f"frame_{i:07d}.jpg"),
                    rng.integers(0, 256, (72, 128, 3), dtype=np.uint8))
    return str(d)


def test_load_embedding_net_matches_jax(models):
    net, params = load_embedding_net(models, "emb", CPU)
    theirs, their_params = jax_load_embedding_net(models, "emb")
    assert params == their_params == EMBED.to_dict()
    x = np.random.default_rng(3).random((3, 72, 128, 3), dtype=np.float32)
    with torch.inference_mode():
        got = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(theirs(x)), atol=1e-5)


@pytest.mark.parametrize("source,precision", [
    ("frames", "float32"), ("frames", "bfloat16_full"),
    ("video", "float32")])
def test_embed_frames_matches_jax_cli(tmp_path, models, frame_dir, clip30,
                                      source, precision, monkeypatch):
    """A frame directory (a frame limit of 37: a padded last batch) and a
    30-frame clip at ``--resize 128``, in batches of 16."""
    monkeypatch.setenv("CUTDET_NO_COMPILE_CACHE", "1")
    src = frame_dir if source == "frames" else clip30
    flags = ["--model-dir", models, "--model-name", "emb", "--batch-size",
             "16", "--precision", precision, "--cpu"]
    flags += (["--frame-limit", "37"] if source == "frames"
              else ["--resize", "128"])
    ours = embed_frames.main([src, "--output", str(tmp_path / "o.npz"),
                              *flags])
    theirs = jax_embed.main([src, "--output", str(tmp_path / "j.npz"),
                             *flags])
    got = np.load(ours)["embeddings"]
    want = np.load(theirs)["embeddings"]
    assert got.shape == want.shape == (37 if source == "frames" else 30, 4)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=EMBED_TOL[precision])


def test_embed_frames_default_output_name(tmp_path, models, clip30):
    video = tmp_path / "game.mp4"
    os.symlink(clip30, video)
    out = embed_frames.main([str(video), "--model-dir", models,
                             "--model-name", "emb", "--frame-limit", "5",
                             "--cpu"])
    assert out == str(tmp_path / "game_embeddings.npz")
    assert np.load(out)["embeddings"].shape == (5, 4)


@pytest.mark.parametrize("precision", PRECISION_CHOICES)
def test_export_program_matches_net_and_jax(tmp_path, models, precision):
    """``--format export`` at every rung: a ``torch.export`` program of
    aten ops only, which reloads and runs without the kernels; within 1e-5
    of the port's net on the CPU and of JAX's ``net(example)`` within the
    rung's bar, ``EXPORT_TOL`` (1e-4 at float32)."""
    out = str(tmp_path / "cls.pt2")
    path = export_model.main(["--model-dir", models, "--model-name", "cls",
                              "--output", out, "--batch-size", "2",
                              "--height", "72", "--width", "96",
                              "--precision", precision, "--cpu"])
    assert path == out
    program = torch.export.load(out)
    ops = {str(n.target) for n in program.graph.nodes
           if n.op == "call_function"}
    assert ops and all(op.startswith("aten.") for op in ops), ops
    x = np.random.default_rng(5).random((2, 72, 96, 3), dtype=np.float32)
    got = program.module()(torch.from_numpy(x)).detach().numpy()
    net, _ = load_triplet_or_default(models, "cls", CPU, precision)
    with torch.inference_mode():
        np.testing.assert_allclose(got, net(torch.from_numpy(x)).numpy(),
                                   atol=1e-5)
    theirs, _ = jax_load_triplet(models, "cls", precision=precision)
    np.testing.assert_allclose(got, np.asarray(theirs(x)),
                               atol=export_model.EXPORT_TOL[precision])


def test_export_torch_format_matches_jax_cli(tmp_path, models):
    """``--format torch``: the JAX CLI's directory, file names and
    tensors."""
    common = ["--model-dir", models, "--model-name", "cls", "--format",
              "torch"]
    ours = export_model.main([*common, "--output", str(tmp_path / "o"),
                              "--cpu"])
    theirs = jax_export.main([*common, "--output", str(tmp_path / "j")])
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs)) == [
        "classifier_conv.pt", "classifier_linear.pt"]
    for name in os.listdir(ours):
        a = torch.load(os.path.join(ours, name), weights_only=True)
        b = torch.load(os.path.join(theirs, name), weights_only=True)
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    default = export_model.main([*common, "--cpu"])
    assert default == os.path.join(models, "cls_torch_export")


def test_export_parser_matches_jax_but_its_xla_formats():
    ours = vars(export_model.build_parser().parse_args(["--format",
                                                        "torch"]))
    theirs = vars(jax_export.build_parser().parse_args(["--format",
                                                        "torch"]))
    assert ours.pop("cpu") is False
    assert ours == theirs
    assert export_model.build_parser().parse_args([]).format == "export"
    for fmt in ("stablehlo", "flax"):
        with pytest.raises(SystemExit):
            export_model.build_parser().parse_args(["--format", fmt])
    assert set(export_model.EXPORT_TOL) == set(
        export_model.build_parser()._option_string_actions[
            "--precision"].choices)
