"""Native bundles <-> the port's ``GluedNet`` state dict, and the
reference's torch state dicts.

Counterpart of ``cut_detection_tpu/checkpoint/convert.py:104-142``
(``export_torch_state_dicts``, copied here): the bundle holds HWIO conv
kernels and [in, out] linear weights; the port's modules hold torch's
OIHW and [out, in].  Keys follow the reference's own module layout
(``conv_layers.{i}.conv|bn.*``, ``layers.{i}.linear|bn.*``) under the
``conv.`` / ``linear.`` prefixes of ``GluedNet``, so a reference ``.pt``
state dict loads into the same modules unchanged.  ``params_from_jax``
reads a bundle into a state dict; ``bundle_from_state_dict`` writes one
back, so a triplet the port trains loads in the JAX package;
``convert_torch_checkpoint`` reads the reference's ``.pt`` pair into a
bundle (``cut_detection_tpu/checkpoint/convert.py:83-101``).
"""

from __future__ import annotations

import numpy as np
import torch

from cut_detection_tpu_torch.config import ModelParams


def _t(arr) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, dtype=np.float32, copy=True))


def params_from_jax(bundle) -> dict[str, torch.Tensor]:
    """``{conv, linear} -> {params, state}`` numpy bundle -> state dict."""
    sd: dict[str, torch.Tensor] = {}
    for i, (p, s) in enumerate(zip(bundle["conv"]["params"],
                                   bundle["conv"]["state"])):
        pfx = f"conv.conv_layers.{i}."
        sd[pfx + "conv.weight"] = _t(np.asarray(p["kernel"])
                                     .transpose(3, 2, 0, 1))
        sd[pfx + "conv.bias"] = _t(p["bias"])
        sd[pfx + "bn.weight"] = _t(p["gamma"])
        sd[pfx + "bn.bias"] = _t(p["beta"])
        sd[pfx + "bn.running_mean"] = _t(s["mean"])
        sd[pfx + "bn.running_var"] = _t(s["var"])
        sd[pfx + "bn.num_batches_tracked"] = torch.tensor(0)
    for i, (p, s) in enumerate(zip(bundle["linear"]["params"],
                                   bundle["linear"]["state"])):
        pfx = f"linear.layers.{i}."
        sd[pfx + "linear.weight"] = _t(np.asarray(p["kernel"]).T)
        sd[pfx + "linear.bias"] = _t(p["bias"])
        if "gamma" in p:
            sd[pfx + "bn.weight"] = _t(p["gamma"])
            sd[pfx + "bn.bias"] = _t(p["beta"])
            sd[pfx + "bn.running_mean"] = _t(s["mean"])
            sd[pfx + "bn.running_var"] = _t(s["var"])
            sd[pfx + "bn.num_batches_tracked"] = torch.tensor(0)
    return sd


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy().copy()


def _layer_count(sd, prefix: str) -> int:
    idx = {int(k[len(prefix):].split(".")[0]) for k in sd
           if k.startswith(prefix)}
    if idx != set(range(len(idx))):
        raise ValueError(f"{prefix}*: layers {sorted(idx)} are not 0..n-1")
    return len(idx)


def bundle_from_state_dict(sd) -> dict:
    """The inverse of ``params_from_jax``: a ``GluedNet`` state dict -> the
    ``{conv, linear} -> {params, state}`` numpy bundle that both packages'
    ``save_bundle`` / ``GluedNet`` read (HWIO kernels, [in, out] weights,
    ``{}`` as the state of a layer without BN).  ``num_batches_tracked``
    is dropped, as ``convert_torch_checkpoint`` drops it."""
    conv_p, conv_s = [], []
    for i in range(_layer_count(sd, "conv.conv_layers.")):
        pfx = f"conv.conv_layers.{i}."
        conv_p.append({
            "kernel": _np(sd[pfx + "conv.weight"]).transpose(2, 3, 1, 0)
            .copy(),
            "bias": _np(sd[pfx + "conv.bias"]),
            "gamma": _np(sd[pfx + "bn.weight"]),
            "beta": _np(sd[pfx + "bn.bias"]),
        })
        conv_s.append({"mean": _np(sd[pfx + "bn.running_mean"]),
                       "var": _np(sd[pfx + "bn.running_var"])})
    lin_p, lin_s = [], []
    for i in range(_layer_count(sd, "linear.layers.")):
        pfx = f"linear.layers.{i}."
        p = {"kernel": _np(sd[pfx + "linear.weight"]).T.copy(),
             "bias": _np(sd[pfx + "linear.bias"])}
        s = {}
        if pfx + "bn.weight" in sd:
            p["gamma"] = _np(sd[pfx + "bn.weight"])
            p["beta"] = _np(sd[pfx + "bn.bias"])
            s = {"mean": _np(sd[pfx + "bn.running_mean"]),
                 "var": _np(sd[pfx + "bn.running_var"])}
        lin_p.append(p)
        lin_s.append(s)
    return {"conv": {"params": conv_p, "state": conv_s},
            "linear": {"params": lin_p, "state": lin_s}}


def convert_torch_checkpoint(param_file: str, conv_file: str,
                             linear_file: str):
    """The reference's checkpoint triplet (the ``*_model_params.json``
    sidecar and the conv and linear ``.pt`` state dicts) -> ``(bundle,
    model_params)``.  The state dicts are read with ``weights_only=True``
    (tensors only, nothing unpickled beyond them) and must hold the
    sidecar's layer counts."""
    model_params = ModelParams.from_json(param_file)
    sd = {}
    for prefix, path in (("conv.", conv_file), ("linear.", linear_file)):
        loaded = torch.load(path, map_location="cpu", weights_only=True)
        sd.update({prefix + k: v for k, v in loaded.items()})
    bundle = bundle_from_state_dict(sd)
    got = (len(bundle["conv"]["params"]), len(bundle["linear"]["params"]))
    want = (model_params.conv_layers, model_params.linear_layers)
    if got != want:
        raise ValueError(f"{conv_file}, {linear_file}: {got[0]} conv and "
                         f"{got[1]} linear layers, but {param_file} says "
                         f"{want[0]} and {want[1]}")
    return bundle, model_params


def export_torch_state_dicts(bundle):
    """Native bundle -> the reference's torch state dicts ``(conv_sd,
    linear_sd)`` (keys without the ``GluedNet`` prefixes), as
    ``cut_detection_tpu/checkpoint/convert.py:104`` writes them:
    ``num_batches_tracked`` is 0."""

    def t(arr):
        return torch.from_numpy(np.asarray(arr).copy())

    conv_sd = {}
    for i, (p, s) in enumerate(zip(bundle["conv"]["params"],
                                   bundle["conv"]["state"])):
        pfx = f"conv_layers.{i}."
        conv_sd[pfx + "conv.weight"] = t(
            np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
        conv_sd[pfx + "conv.bias"] = t(p["bias"])
        conv_sd[pfx + "bn.weight"] = t(p["gamma"])
        conv_sd[pfx + "bn.bias"] = t(p["beta"])
        conv_sd[pfx + "bn.running_mean"] = t(s["mean"])
        conv_sd[pfx + "bn.running_var"] = t(s["var"])
        conv_sd[pfx + "bn.num_batches_tracked"] = torch.tensor(0)
    linear_sd = {}
    for i, (p, s) in enumerate(zip(bundle["linear"]["params"],
                                   bundle["linear"]["state"])):
        pfx = f"layers.{i}."
        linear_sd[pfx + "linear.weight"] = t(np.asarray(p["kernel"]).T)
        linear_sd[pfx + "linear.bias"] = t(p["bias"])
        if "gamma" in p:
            linear_sd[pfx + "bn.weight"] = t(p["gamma"])
            linear_sd[pfx + "bn.bias"] = t(p["beta"])
            linear_sd[pfx + "bn.running_mean"] = t(s["mean"])
            linear_sd[pfx + "bn.running_var"] = t(s["var"])
            linear_sd[pfx + "bn.num_batches_tracked"] = torch.tensor(0)
    return conv_sd, linear_sd
