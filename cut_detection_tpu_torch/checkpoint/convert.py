"""Native bundle -> the port's ``GluedNet`` state dict.

Counterpart of ``cut_detection_tpu/checkpoint/convert.py:104-142``
(``export_torch_state_dicts``): the bundle holds HWIO conv kernels and
[in, out] linear weights; the port's modules hold torch's OIHW and
[out, in].  Keys follow the reference's own module layout
(``conv_layers.{i}.conv|bn.*``, ``layers.{i}.linear|bn.*``) under the
``conv.`` / ``linear.`` prefixes of ``GluedNet``, so a reference ``.pt``
state dict loads into the same modules unchanged.
"""

from __future__ import annotations

import numpy as np
import torch


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
