"""The port's training CLIs on the CPU, and what they write, against the
JAX package.

A tiny labelled frame tree (24 JPEG frames of 36x64 with a labels CSV),
written here with numpy and cv2, trains a 2-layer, 8-channel net:

- the triplet the port saves loads in JAX's ``load_model_triplet`` and
  ``GluedNet``, whose logits equal the port's within 1e-4, at both
  training precisions; its ``--export-torch`` ``.pt`` files equal JAX's
  ``export_torch_state_dicts`` of the same bundle;
- ``--resume`` continues the epoch numbering and the optimizer's step;
  ``--checkpoint-every-n`` keeps its cadence;
- ``--load-conv-net`` warm-starts from the port's contrastive
  ``{name}_conv.npz``, which JAX's ``load_embedding_net`` also reads;
- without a card and without ``--cpu`` both CLIs stop; ``--data-parallel``
  trains unsharded on one device and over several starts one rank a card
  (the ranks' loops are held in ``tests/test_torch_distributed.py``).
"""

import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cut_detection_tpu.checkpoint.convert import (
    export_torch_state_dicts as jax_export,
)
from cut_detection_tpu.config import ModelParams as JaxModelParams
from cut_detection_tpu.models.assembly import GluedNet as JaxGluedNet
from cut_detection_tpu.models.assembly import load_embedding_net
from cut_detection_tpu.train.checkpointing import (
    load_model_triplet as jax_load_triplet,
)
from cut_detection_tpu_torch.checkpoint.io import load_bundle
from cut_detection_tpu_torch.cli import train_contrastive, train_supervised
from cut_detection_tpu_torch.models.assembly import load_triplet_or_default
from cut_detection_tpu_torch.train.checkpointing import (
    latest_checkpoint,
    load_train_state,
)

NET = ["--conv-layers", "2", "--conv-hidden-channels", "8",
       "--avg-pool-size", "2", "--linear-size", "8"]


@pytest.fixture(scope="module")
def frames_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(0)
    for i in range(24):
        base = np.array([(40, 120, 40), (150, 60, 60), (10, 10, 10)][i // 8],
                        np.int16)
        img = np.clip(base + rng.integers(0, 60, (36, 64, 3)), 0, 255)
        cv2.imwrite(str(d / f"frame_{i:07d}.jpg"), img.astype(np.uint8))
    (d / "frames.csv").write_text("0,a22\n8,ez\n16,b\n")
    return str(d)


def _supervised(frames_dir, model_dir, *extra):
    train_supervised.main(["--data-dirs", frames_dir, *NET, "--batch-size",
                           "8", "--num-workers", "0", "--model-dir",
                           str(model_dir), "--model-name", "t", "--cpu",
                           *extra])


def _frames(n=6):
    return np.random.default_rng(1).random((n, 36, 64, 3), dtype=np.float32)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_trained_triplet_loads_in_jax(frames_dir, tmp_path, precision):
    _supervised(frames_dir, tmp_path, "--epochs", "1", "--precision",
                precision, "--export-torch")
    bundle = jax_load_triplet(str(tmp_path), "t")
    params = JaxModelParams.from_json(str(tmp_path / "t_model_params.json"))
    assert params.conv_channels == 8 and params.avg_pool_size == 2
    x = _frames()
    theirs = np.asarray(JaxGluedNet(bundle, params)(jnp.asarray(x)))
    net, _ = load_triplet_or_default(str(tmp_path), "t", "cpu")
    with torch.no_grad():
        ours = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, theirs, atol=1e-4)
    # GluedNet.save writes the same bundle, in one file.
    net.save(str(tmp_path / "net.npz"))
    saved = jax.tree_util.tree_leaves(load_bundle(str(tmp_path / "net.npz")))
    for a, b in zip(saved, jax.tree_util.tree_leaves(bundle)):
        np.testing.assert_array_equal(a, b)
    # The BN statistics moved off their init in training.
    assert np.abs(bundle["conv"]["state"][0]["mean"]).max() > 0
    # The .pt files are JAX's export of the same bundle.
    for part, sd in zip(("conv", "linear"), jax_export(bundle)):
        got = torch.load(str(tmp_path / f"t_classifier_{part}.pt"),
                         weights_only=True)
        assert got.keys() == sd.keys()
        for k, v in sd.items():
            assert got[k].dtype == v.dtype, k
            torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)


def test_resume_continues_epoch_numbering(frames_dir, tmp_path):
    _supervised(frames_dir, tmp_path, "--epochs", "1")
    first = latest_checkpoint(str(tmp_path))
    assert os.path.basename(first) == "train_state_0000.npz"
    _supervised(frames_dir, tmp_path, "--epochs", "2", "--resume")
    assert sorted(n for n in os.listdir(tmp_path)
                  if n.startswith("train_state_") and n.endswith(".npz")) \
        == ["train_state_0000.npz", "train_state_0001.npz"]
    with open(tmp_path / "train_state_meta.json") as f:
        assert json.load(f)["epoch"] == 1
    # 18 training frames: 3 steps an epoch; the resumed run went on from
    # the first snapshot's optimizer state.
    from cut_detection_tpu_torch.config import TrainConfig
    from cut_detection_tpu_torch.train.supervised import init_train_state

    cfg = TrainConfig(conv_layers=2, conv_hidden_channels=8, avg_pool_size=2,
                      linear_size=8)
    steps = []
    for name in ("train_state_0000.npz", "train_state_0001.npz"):
        state = load_train_state(str(tmp_path / name),
                                 init_train_state(torch.Generator(), cfg,
                                                  "cpu"))
        steps.append((state.step, {int(s["step"]) for s in
                                   state.optimizer.state_dict()
                                   ["state"].values()}))
    assert steps == [(3, {3}), (6, {6})]
    # The final triplet holds the resumed run's weights.
    saved = load_bundle(str(tmp_path / "t_classifier_conv.npz"))
    np.testing.assert_array_equal(
        saved["params"][0]["kernel"],
        state.net.bundle()["conv"]["params"][0]["kernel"])


def test_checkpoint_every_n_cadence(frames_dir, tmp_path):
    _supervised(frames_dir, tmp_path, "--epochs", "4",
                "--checkpoint-every-n", "2")
    assert sorted(n for n in os.listdir(tmp_path) if n.endswith(".npz")
                  and n.startswith("train_state_")) == [
        "train_state_0001.npz", "train_state_0003.npz"]


@pytest.mark.parametrize("fast", [False, True])
def test_load_conv_net_warm_starts_from_contrastive(frames_dir, tmp_path,
                                                    fast):
    train_contrastive.main(
        ["--data-dir", frames_dir, "--conv-layers", "2",
         "--conv-hidden-channels", "8", "--linear-layers", "2",
         "--linear-size", "8", "--output-size", "4", "--batch-size", "4",
         "--epochs", "1", "--num-workers", "0", "--model-dir",
         str(tmp_path), "--model-name", "t", "--cpu"]
        + (["--fast-augment"] if fast else []))
    conv = load_bundle(str(tmp_path / "t_conv.npz"))
    # JAX reads the pair as an embedding net.
    net, _ = load_embedding_net(str(tmp_path), "t")
    emb = np.asarray(net(jnp.asarray(_frames(2))))
    assert emb.shape == (2, 4) and np.isfinite(emb).all()
    # Zero epochs: the saved classifier's backbone is the warm start.
    _supervised(frames_dir, tmp_path, "--epochs", "0", "--load-conv-net")
    saved = load_bundle(str(tmp_path / "t_classifier_conv.npz"))
    for a, b in zip(jax.tree_util.tree_leaves(saved),
                    jax.tree_util.tree_leaves(conv)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cli", ["supervised", "contrastive"])
def test_clis_need_a_card_or_cpu(frames_dir, tmp_path, monkeypatch, cli,
                                 capsys):
    """No card: both stop unless ``--cpu``.  ``--data-parallel`` with one
    device trains unsharded (``--cpu``); over several cards it starts one
    rank a card, each running the CLI's ``train`` on the parsed flags."""
    main = (train_supervised if cli == "supervised"
            else train_contrastive).main
    args = (["--data-dirs", frames_dir] if cli == "supervised"
            else ["--data-dir", frames_dir])
    args += ["--model-dir", str(tmp_path), "--epochs", "0"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        main(args)
    assert "--cpu" in capsys.readouterr().err
    main(args + ["--cpu", "--data-parallel"])
    from cut_detection_tpu_torch.parallel import distributed

    spawned = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(distributed, "spawn",
                        lambda fn, n, *a: spawned.append((fn, n, a)))
    main(args + ["--data-parallel"])
    module = train_supervised if cli == "supervised" else train_contrastive
    [(fn, n, (ns,))] = spawned
    assert fn is module.train and n == 2
    assert ns.data_parallel and not ns.cpu and ns.epochs == 0
