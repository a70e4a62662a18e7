"""``export_model``: the glued classifier as a portable artifact.

Counterpart of ``cut_detection_tpu/cli/export_model.py`` (``:32-160``;
reference training_scripts/make_torchscript_model.py), with the JAX
parser's flags and defaults, ``--cpu`` added:

- ``--format export`` (the default; the JAX CLI's ``stablehlo``): a
  ``torch.export`` ``ExportedProgram`` of the net's forward on NHWC float
  frames in [0, 1] at ``--batch-size`` x ``--height`` x ``--width`` and
  ``--precision``, written with ``torch.export.save`` (``.pt2``) for the
  CLI's device.  As the JAX artifact is ``_glued_apply``'s XLA graph with
  no Pallas call in it, the net is traced on the CPU, where every kernel
  wrapper takes its plain version, so the artifact holds aten ops only
  and loads with ``torch.export.load`` and no ``nvcc`` (the kernels are
  bound by ``ctypes``, which export cannot trace); then its tensors move
  to the CLI's device.  The consistency check reloads it, runs it on that
  device and holds it to the net's own forward there (the kernels, on the
  card): within ``EXPORT_TOL[precision]``, or it raises.
- ``--format torch``: the reference's ``.pt`` state dicts
  (``checkpoint.convert.export_torch_state_dicts``), in the JAX CLI's
  directory and file names.

``stablehlo`` and ``flax`` are formats of the XLA ecosystem (a PJRT
artifact, a flax/linen checkpoint); the port has neither runtime, so its
parser does not offer them.

    python -m cut_detection_tpu_torch.cli.export_model \\
        [--use-default-net | --model-dir DIR --model-name NAME] \\
        [--format {export,torch}] [--batch-size N] [--height H] \\
        [--width W] [--precision P] [--output PATH] [--cpu]
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np

from cut_detection_tpu_torch.config import PRECISION_CHOICES
from cut_detection_tpu_torch.utils.logging import setup_logging

# The exported program (plain versions) against the net's forward on the
# same device (the kernels on the card).  float32: summation order only.
# The bf16 rungs: the input is float frames, so layer 1 is unfolded and
# layer 2 reads a bf16-rounded input, where a last-bit difference of the
# sums becomes a whole ulp (5.7e-3 at most against JAX on the CPU tests'
# frames); they take bfloat16_full's bar.  The quantized rungs: a code
# one step apart.  Read on an NVIDIA H100 80GB HBM3 (700 W) by
# chip_smoke.py's tools phase, the prod net at batch 128: float32
# 4.3e-6, bfloat16 2.8e-3, bfloat16_full 4.4e-3, uint8_pool, uint8_chain
# and int8_mxu 0.
EXPORT_TOL = {"float32": 1e-4, "bfloat16": 1e-2, "bfloat16_full": 1e-2,
              "uint8_pool": 2e-2, "uint8_chain": 2e-2, "int8_mxu": 2e-2}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("Export the glued classifier.",
                                fromfile_prefix_chars="@")
    p.add_argument("--model-dir", type=str, default="./models")
    p.add_argument("--model-name", type=str, default="init_model")
    p.add_argument("--use-default-net", action="store_true",
                   help="Export the bundled prod classifier instead of a "
                        "triplet from --model-dir.")
    p.add_argument("--format", choices=["export", "torch"],
                   default="export",
                   help="export: a torch.export program (.pt2) of the "
                        "plain forward; torch: the reference's .pt state "
                        "dicts.  The JAX CLI's stablehlo and flax are XLA "
                        "formats, which the port has no runtime for.")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--height", type=int, default=144)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--precision",
                   choices=list(PRECISION_CHOICES),
                   default="float32",
                   help="Precision mode baked into the exported program.")
    p.add_argument("--output", type=str, default=None)
    p.add_argument("--cpu", action="store_true",
                   help="Run on the CPU (otherwise a CUDA device is "
                        "required).")
    return p


def main(args=None) -> str:
    parser = build_parser()
    ns = parser.parse_args(args)
    setup_logging()

    import torch

    from cut_detection_tpu_torch.models.assembly import (
        load_default_net,
        load_triplet_or_default,
    )
    from cut_detection_tpu_torch.utils.device import (
        resolve_device,
        strict_fp32,
    )

    try:
        device = resolve_device(cpu=ns.cpu)
    except RuntimeError as e:
        parser.error(str(e))
    strict_fp32()

    def load(where):
        if ns.use_default_net:
            return load_default_net(where, ns.precision)[0]
        # npz preferred, reference-format torch .pt accepted.
        return load_triplet_or_default(ns.model_dir, ns.model_name, where,
                                       ns.precision)[0]

    net = load(device)

    rng = np.random.default_rng(0)
    example = torch.from_numpy(rng.random(
        (ns.batch_size, ns.height, ns.width, 3), dtype=np.float32))
    with torch.inference_mode():
        eager = net(example.to(device)).cpu().numpy()
    logging.info("Normal: %s", eager)

    if ns.format == "torch":
        from cut_detection_tpu_torch.checkpoint.convert import (
            export_torch_state_dicts,
        )

        conv_sd, lin_sd = export_torch_state_dicts(net.bundle())
        out = ns.output or os.path.join(ns.model_dir,
                                        f"{ns.model_name}_torch_export")
        os.makedirs(out, exist_ok=True)
        torch.save(conv_sd, os.path.join(out, "classifier_conv.pt"))
        torch.save(lin_sd, os.path.join(out, "classifier_linear.pt"))
        logging.info("Wrote torch state dicts to %s", out)
        return out

    from torch.export.passes import move_to_device_pass

    # Traced on the CPU, where every kernel wrapper takes its plain
    # version: the program holds aten ops only.
    plain = net if device.type == "cpu" else load(torch.device("cpu"))
    exported = torch.export.export(plain, (example,))
    if device.type != "cpu":
        exported = move_to_device_pass(exported, device)
    out = ns.output or os.path.join(ns.model_dir,
                                    f"{ns.model_name}_exported.pt2")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    torch.export.save(exported, out)
    # Consistency check like make_torchscript_model.py:31-32, on the
    # CLI's device against the net's own forward there.
    with torch.inference_mode():
        traced = torch.export.load(out).module()(
            example.to(device)).cpu().numpy()
    diff = float(np.abs(eager - traced).max())
    logging.info("Exported: %s", traced)
    logging.info("Max diff eager vs exported: %.3e", diff)
    if not diff <= EXPORT_TOL[ns.precision]:
        raise AssertionError(
            f"exported program differs from the net by {diff:.3e} at "
            f"{ns.precision} (bar {EXPORT_TOL[ns.precision]:.0e})")
    logging.info("Wrote %d bytes to %s", os.path.getsize(out), out)
    return out


if __name__ == "__main__":
    main()
