"""Training checkpoints and the model triplet.

Counterpart of ``cut_detection_tpu/train/checkpointing.py:25-117``:

- ``save_train_state`` snapshots the whole state every N epochs as
  ``train_state_{epoch:04d}.npz`` (with ``train_state_meta.json``):
  through ``flatten_tree``, the net's state dict (``model/<key>``), the
  optimizer's moments and step per parameter (``optimizer/<parameter
  name>/<exp_avg|exp_avg_sq|step|...>``) and the step count;
  ``load_train_state`` restores one into a freshly initialised state.
  The JAX package's snapshots hold its own pytrees: neither package
  resumes the other's.
- ``save_model_triplet`` writes the reference's artifact contract, the
  conv and linear bundles and the ``*_model_params.json`` sidecar
  (supervised_training.py:224-245), which the JAX package's
  ``load_model_triplet`` reads; with ``export_torch`` also the
  reference's ``.pt`` state dicts.  The port reads a triplet back as a
  net with ``models.assembly.load_triplet_or_default``, as the inference
  CLIs do.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from cut_detection_tpu_torch.checkpoint.convert import export_torch_state_dicts
from cut_detection_tpu_torch.checkpoint.io import (
    flatten_tree,
    load_bundle,
    save_bundle,
)
from cut_detection_tpu_torch.config import TrainConfig


def _np(t) -> np.ndarray:
    return torch.as_tensor(t).detach().cpu().numpy()


def _state_tree(state) -> dict:
    names = [n for n, _ in state.net.named_parameters()]
    opt = state.optimizer.state_dict()["state"]
    return {
        "model": {k: _np(v) for k, v in state.net.state_dict().items()},
        "optimizer": {names[i]: {k: _np(v) for k, v in s.items()}
                      for i, s in opt.items()},
        "step": np.asarray(state.step, np.int64),
    }


def save_train_state(directory: str, state, cfg, epoch: int) -> str:
    """Write a whole-state snapshot; returns its path."""
    os.makedirs(directory, exist_ok=True)
    flat = flatten_tree(_state_tree(state))
    path = os.path.join(directory, f"train_state_{epoch:04d}.npz")
    np.savez(path, **flat)
    with open(os.path.join(directory, "train_state_meta.json"), "w") as f:
        json.dump({"epoch": epoch, "n_leaves": len(flat)}, f)
    return path


def latest_checkpoint(directory: str) -> str | None:
    if not os.path.isdir(directory):
        return None
    snaps = sorted(f for f in os.listdir(directory)
                   if f.startswith("train_state_") and f.endswith(".npz"))
    return os.path.join(directory, snaps[-1]) if snaps else None


def load_train_state(path: str, template_state):
    """Restore a snapshot into ``template_state`` (its net and optimizer,
    built as the snapshot's were) and return it."""
    tree = load_bundle(path)
    net = template_state.net
    net.load_state_dict({k: torch.from_numpy(np.asarray(v))
                         for k, v in tree["model"].items()})
    index = {n: i for i, (n, _) in enumerate(net.named_parameters())}
    opt_sd = template_state.optimizer.state_dict()
    opt_sd["state"] = {index[n]: {k: torch.from_numpy(np.asarray(v))
                                  for k, v in s.items()}
                       for n, s in tree["optimizer"].items()}
    template_state.optimizer.load_state_dict(opt_sd)
    template_state.step = int(tree["step"])
    return template_state


def save_model_triplet(model_dir: str, model_name: str, state,
                       cfg: TrainConfig, *,
                       export_torch: bool = False) -> None:
    """``{name}_classifier_conv.npz`` + ``{name}_classifier_linear.npz`` +
    ``{name}_model_params.json`` (the reference's keys); with
    ``export_torch`` also ``{name}_classifier_{conv,linear}.pt``."""
    os.makedirs(model_dir, exist_ok=True)
    bundle = state.net.bundle()
    save_bundle(os.path.join(model_dir, f"{model_name}_classifier_conv.npz"),
                bundle["conv"])
    save_bundle(os.path.join(model_dir,
                             f"{model_name}_classifier_linear.npz"),
                bundle["linear"])
    params_json = {
        "conv_layers": cfg.conv_layers,
        "conv_channels": cfg.conv_hidden_channels,
        "avg_pool_size": cfg.avg_pool_size,
        "linear_layers": cfg.linear_layers,
        "linear_size": cfg.linear_size,
        "linear_output_size": cfg.output_size,
        "data_size": cfg.data_size,
        "batch_size": cfg.batch_size,
        "epochs": cfg.epochs,
    }
    with open(os.path.join(model_dir, f"{model_name}_model_params.json"),
              "w") as f:
        json.dump(params_json, f)
    if export_torch:
        conv_sd, lin_sd = export_torch_state_dicts(bundle)
        torch.save(conv_sd,
                   os.path.join(model_dir, f"{model_name}_classifier_conv.pt"))
        torch.save(lin_sd,
                   os.path.join(model_dir,
                                f"{model_name}_classifier_linear.pt"))

