"""Convert the reference's prod checkpoint into a native bundle.

Port of ``scripts/convert_prod_net.py``: reads the reference's torch
state dicts and sidecar (``init_model_model_params.json``,
``init_model_classifier_conv.pt``, ``init_model_classifier_linear.pt``)
from ``--reference`` (the reference checkout's ``frameID/prod_net``)
and writes ``init_model.npz`` and the sidecar into
``--out``, the layout that ``cut_detection_tpu/prod_net/`` holds.  The
port reads the bundled net from that directory by path, so this script
refuses to write there.  Conversion is host work: no card is used.

    python -m cut_detection_tpu_torch.scripts.convert_prod_net \\
        --reference REF/frameID/prod_net --out DIR
"""

from __future__ import annotations

import argparse
import json
import os

BUNDLED = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "cut_detection_tpu", "prod_net")


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reference", required=True,
                    help="the reference checkout's frameID/prod_net")
    ap.add_argument("--out", required=True,
                    help="directory for init_model.npz and its sidecar")
    ns = ap.parse_args(argv)
    if os.path.realpath(ns.out) == os.path.realpath(BUNDLED):
        raise SystemExit(f"{BUNDLED} holds the bundled net the port reads; "
                         "write elsewhere")
    from cut_detection_tpu_torch.checkpoint.convert import (
        convert_torch_checkpoint,
    )
    from cut_detection_tpu_torch.checkpoint.io import save_bundle

    bundle, model_params = convert_torch_checkpoint(
        os.path.join(ns.reference, "init_model_model_params.json"),
        os.path.join(ns.reference, "init_model_classifier_conv.pt"),
        os.path.join(ns.reference, "init_model_classifier_linear.pt"),
    )
    os.makedirs(ns.out, exist_ok=True)
    npz = os.path.join(ns.out, "init_model.npz")
    save_bundle(npz, bundle)
    with open(os.path.join(ns.out, "init_model_model_params.json"),
              "w") as f:
        json.dump(model_params.to_dict(), f)
    print("wrote", npz)
    print("model_params:", model_params)
    return npz


if __name__ == "__main__":
    main()
