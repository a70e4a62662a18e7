"""Batch inference CLI of the port: segment many videos with one model.

Port of ``cut_detection_tpu/cli/segment_videos.py``, with its flags and
defaults, on ``pipeline.segment_many``: one net and one step for every
video, and video i + 1's host decode running while video i is on the
device (``--no-decode-ahead`` turns that off).  The model runs on the
CUDA device, or on the CPU with ``--cpu``.  ``--data-parallel`` and
``--multi-host`` are not ported yet (ROADMAP.md Queue 1 item 5) and are
refused at parse time.

    python -m cut_detection_tpu_torch.cli.segment_videos A.mp4 B.mp4 \\
        [--transfer {auto,bgr,yuv420}] [--precision ...] [--cpu]
"""

from __future__ import annotations

import argparse
import logging

from cut_detection_tpu_torch.config import PRECISION_CHOICES
from cut_detection_tpu_torch.utils.logging import setup_logging


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("Segment several videos into scenes.",
                                fromfile_prefix_chars="@")
    p.add_argument("input_paths", type=str, nargs="+",
                   help="Paths to videos to segment.")
    p.add_argument("--base-threshold", type=int, default=100)
    p.add_argument("--blank-threshold", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--print-every", type=int, default=0)
    p.add_argument("--decode-workers", type=int, default=1)
    p.add_argument("--no-decode-ahead", action="store_true",
                   help="Process videos strictly sequentially instead of "
                        "starting video i+1's host decode while video i "
                        "runs on the device.")
    p.add_argument("--device-resize", action="store_true")
    p.add_argument("--transfer", choices=["auto", "bgr", "yuv420"],
                   default="auto",
                   help="Host->device byte format: 'yuv420' uploads "
                        "planar YUV at 1.5 B/px (half of BGR24) and "
                        "converts on the device (accuracy-gated fast "
                        "path; needs the native decoder's YUV entry "
                        "points); 'auto' (default) picks yuv420 on CUDA "
                        "when it can run, bgr otherwise.")
    p.add_argument("--precision", choices=list(PRECISION_CHOICES),
                   default="float32")
    p.add_argument("--data-parallel", action="store_true",
                   help="Not ported yet (ROADMAP.md Queue 1 item 5); "
                        "refused.")
    p.add_argument("--multi-host", action="store_true",
                   help="Not ported yet (ROADMAP.md Queue 1 item 5); "
                        "refused.")
    p.add_argument("--model-dir", type=str, default=None,
                   help="Use a trained triplet instead of the bundled "
                        "prod classifier.")
    p.add_argument("--model-name", type=str, default="init_model")
    p.add_argument("--cpu", action="store_true",
                   help="Run on the CPU (otherwise a CUDA device is "
                        "required).")
    return p


def main(args=None) -> list[str]:
    parser = build_parser()
    ns = parser.parse_args(args)
    unported = [flag for flag, on in (("--data-parallel", ns.data_parallel),
                                      ("--multi-host", ns.multi_host)) if on]
    if unported:
        parser.error(f"{', '.join(unported)}: not yet ported, see "
                     "ROADMAP.md Queue 1 item 5")
    if ns.transfer == "yuv420" and ns.device_resize:
        # The pipeline's exclusion, at parse time (before the model loads).
        parser.error("--transfer yuv420 cannot combine with "
                     "--device-resize (YUV frames arrive at model "
                     "resolution already); use --transfer auto or bgr")
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
    from cut_detection_tpu_torch.pipeline import segment_many

    net, _ = load_triplet_or_default(ns.model_dir, ns.model_name, device,
                                     ns.precision)
    results = segment_many(
        ns.input_paths,
        net=net,
        base_threshold=ns.base_threshold,
        blank_threshold=ns.blank_threshold,
        batch_size=ns.batch_size,
        print_every=ns.print_every,
        decode_workers=ns.decode_workers,
        device_resize=ns.device_resize,
        transfer=ns.transfer,
        pipeline_decode=not ns.no_decode_ahead,
    )
    outs = [r[0] for r in results]
    for out, (_, seg, stats) in zip(outs, results):
        logging.info("%s: %d segments, %.1f fps", out, len(seg),
                     stats.frames_per_sec)
    return outs


if __name__ == "__main__":
    main()
