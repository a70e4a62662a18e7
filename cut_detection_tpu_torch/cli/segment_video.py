"""``segment_video`` on PyTorch + CUDA: the port's production CLI.

Same flags and defaults as ``cut_detection_tpu/cli/segment_video.py``
(reference segment_video.py:81-126).  The model runs on the CUDA device,
or on the CPU with ``--cpu``; without a CUDA device and without ``--cpu``
it stops with an error.  ``--device-resize`` decodes at source
resolution and resizes on the device, bit-exact with cv2;
``--pallas-preprocess`` runs the fused resize + flip + /255 kernel there
instead (float bilinear).  ``--transfer yuv420`` uploads packed planar
YUV420 from the native decoder (1.5 B/px where BGR takes 3) and converts
it on the device, exactly as swscale does; ``--transfer auto``, the
default, picks it on CUDA when the native YUV decoder is built and no
on-device preprocess is asked for, and bgr otherwise (always on the CPU).
yuv420 resizes in YUV space, so it is held by the accuracy corpus;
``--transfer bgr`` is the byte-parity path.  ``--precision`` takes
``float32`` (the reference-parity CSVs), ``bfloat16``, ``bfloat16_full``,
``uint8_pool``, ``uint8_chain`` and ``int8_mxu`` (int8 convs with int32
sums).  ``--device-glue`` runs the segment smoother on the model's
device (same CSV); ``--profile DIR`` writes a ``torch.profiler`` trace of
the run into DIR.  Every option of the JAX CLI runs; as there,
``--transfer yuv420`` does not combine with an on-device resize.

    python -m cut_detection_tpu_torch.cli.segment_video VIDEO.mp4 \\
        [--transfer {auto,bgr,yuv420}] \\
        [--device-resize [--pallas-preprocess]] \\
        [--precision {float32,bfloat16,bfloat16_full,uint8_pool,
                      uint8_chain,int8_mxu}] \\
        [--device-glue] [--profile DIR] [--output_path OUT.csv] [--cpu]
"""

from __future__ import annotations

import argparse
import logging

from cut_detection_tpu_torch.config import PRECISION_CHOICES
from cut_detection_tpu_torch.utils.logging import setup_logging


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "Segment a video into scenes.", fromfile_prefix_chars="@")
    p.add_argument("input_path", type=str, help="Path to video to segment.")
    p.add_argument("--output_path", type=str, default=None,
                   help="Path to output csv")
    p.add_argument(
        "--base-threshold", type=int, default=100,
        help="Number of frames below which an A22 or EZ segment will be "
             "considered an orphan.")
    p.add_argument(
        "--blank-threshold", type=int, default=10,
        help="Number of frames below which a blank segment will be "
             "considered an orphan.")
    p.add_argument("--batch-size", type=int, default=128,
                   help="Batch size for loading frames.")
    p.add_argument("--print-every", type=int, default=50,
                   help="Log message every n batches. 0 to disable.")
    p.add_argument("--frame-limit", type=int, default=None,
                   help="Limit how many frames are processed. Mainly for "
                        "testing.")
    p.add_argument("--cpu", action="store_true",
                   help="Run on the CPU (otherwise a CUDA device is "
                        "required).")
    p.add_argument("--decode-workers", type=int, default=1,
                   help="Parallel decode threads (1 = sequential reference "
                        "behavior).")
    p.add_argument("--decoder", choices=["cv2", "native", "auto"],
                   default="cv2",
                   help="Decode backend: OpenCV, the native libav stage, "
                        "or auto (native when built).")
    p.add_argument("--decode-process", choices=["auto", "on", "off"],
                   default="auto",
                   help="Run host decode in a subprocess feeding a shared-"
                        "memory batch ring (auto: on for CUDA).")
    p.add_argument("--transfer", choices=["auto", "bgr", "yuv420"],
                   default="auto",
                   help="Host->device frame format: bgr (uint8 BGR, byte "
                        "parity), yuv420 (packed planar YUV420 from the "
                        "native decoder, converted on the device), or "
                        "auto (yuv420 on CUDA when the native YUV decoder "
                        "is built and no on-device preprocess is asked "
                        "for, else bgr).")
    p.add_argument("--device-resize", action="store_true",
                   help="Resize frames on the device (bit-exact cv2 "
                        "emulation) instead of the host.")
    p.add_argument("--pallas-preprocess", action="store_true",
                   help="Use the fused resize+normalize kernel (float "
                        "bilinear fast path, implies on-device "
                        "preprocessing).")
    p.add_argument("--model-dir", type=str, default=None,
                   help="Load a trained model triplet from this directory "
                        "instead of the bundled prod classifier.")
    p.add_argument("--model-name", type=str, default="init_model",
                   help="Triplet name prefix within --model-dir.")
    p.add_argument("--device-glue", action="store_true",
                   help="Run the orphan-glue/merge smoother on the model's "
                        "device instead of the host loop (same output).")
    p.add_argument("--cache-scores", type=str, default=None,
                   help="Path to a per-frame score cache (.npz); resumes "
                        "from it if present.")
    p.add_argument("--profile", type=str, default=None,
                   help="Directory for a torch.profiler trace of the run.")
    p.add_argument("--precision", choices=list(PRECISION_CHOICES),
                   default="float32",
                   help="float32 guarantees reference-parity CSVs; "
                        "bfloat16 uses bf16 operands; bfloat16_full also "
                        "keeps activations bf16; uint8_pool quantizes the "
                        "conv activations to uint8 before the pool; "
                        "uint8_chain also keeps them uint8 between layers; "
                        "int8_mxu stores them int8 and runs the convs as "
                        "int8 x int8 -> int32.")
    return p


def main(args=None) -> str:
    parser = build_parser()
    ns = parser.parse_args(args)
    if ns.transfer == "yuv420" and (ns.device_resize or ns.pallas_preprocess):
        # The JAX CLI's parse-time exclusion, kept as it is.
        parser.error("--transfer yuv420 cannot combine with "
                     "--device-resize/--pallas-preprocess (YUV frames "
                     "arrive at model resolution already); use "
                     "--transfer auto or bgr")
    setup_logging()

    from cut_detection_tpu_torch.utils.device import (
        resolve_device,
        strict_fp32,
    )

    try:
        device = resolve_device(cpu=ns.cpu)
    except RuntimeError as e:
        parser.error(str(e))
    strict_fp32()
    logging.info("Using %s", device)

    from cut_detection_tpu_torch.models.assembly import (
        load_triplet_or_default,
    )
    from cut_detection_tpu_torch.pipeline import segment_video_file
    from cut_detection_tpu_torch.utils.profiling import maybe_trace

    net = None
    if ns.model_dir:
        net, _ = load_triplet_or_default(ns.model_dir, ns.model_name, device,
                                         ns.precision)
        logging.info("Loaded model triplet %s from %s", ns.model_name,
                     ns.model_dir)
    with maybe_trace(ns.profile, cuda=device.type == "cuda"):
        out_path, _, _ = segment_video_file(
            ns.input_path,
            ns.output_path,
            device=device,
            net=net,
            base_threshold=ns.base_threshold,
            blank_threshold=ns.blank_threshold,
            batch_size=ns.batch_size,
            frame_limit=ns.frame_limit,
            print_every=ns.print_every,
            decode_workers=ns.decode_workers,
            decoder=ns.decoder,
            decode_process={"auto": "auto", "on": True,
                            "off": False}[ns.decode_process],
            transfer=ns.transfer,
            device_resize=ns.device_resize,
            pallas_preprocess=ns.pallas_preprocess,
            cache_path=ns.cache_scores,
            precision=ns.precision,
            device_glue=ns.device_glue,
        )
    return out_path


if __name__ == "__main__":
    main()
