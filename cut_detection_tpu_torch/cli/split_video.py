"""``split_video``: a video into one JPEG per frame.

Copy of ``cut_detection_tpu/cli/split_video.py`` (``:17-73``; reference
training_scripts/split_video.py) over the port's ``data.video``: decode,
an optional host resize (cv2 INTER_LINEAR, the reference's size rule,
split_video.py:35-38,48-51), and ``frame_%07d.jpg`` per frame
(split_video.py:53), sequentially or chunk-parallel with
``--decode-workers``.  It runs on the host only, so it has no ``--cpu``.

    python -m cut_detection_tpu_torch.cli.split_video VIDEO.mp4 OUT_DIR \\
        [--resize N] [--max-frames N] [--decode-workers N]
"""

from __future__ import annotations

import argparse
import os

from cut_detection_tpu_torch.utils.logging import setup_logging


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("Split a video into individual frames.",
                                fromfile_prefix_chars="@")
    p.add_argument("input_path", type=str,
                   help="Path to video to turn into frames.")
    p.add_argument("output_dir", type=str,
                   help="Path to directory to write images. Will be created "
                        "if it doesn't exist.")
    p.add_argument("--resize", type=int, default=0,
                   help="Size of larger dimension.")
    p.add_argument("--max-frames", type=int, default=-1,
                   help="Number of frames to save.")
    p.add_argument("--decode-workers", type=int, default=1,
                   help="Parallel decode threads.")
    return p


def main(args=None) -> None:
    ns = build_parser().parse_args(args)
    setup_logging()

    import cv2

    from cut_detection_tpu_torch.data.video import (
        ParallelVideoReader,
        VideoFrameSource,
        open_video,
    )

    if not os.path.isfile(ns.input_path):
        raise ValueError(f"{ns.input_path} does not exist.")

    cap, props = open_video(ns.input_path)
    cap.release()
    frame_limit = props["length"] if ns.max_frames < 0 else ns.max_frames
    print(f"Processing {frame_limit} frames from {ns.input_path}.")

    os.makedirs(ns.output_dir, exist_ok=True)
    resize = ns.resize if ns.resize > 0 else None

    if ns.decode_workers > 1:
        source = ParallelVideoReader(ns.input_path, resize=resize,
                                     num_threads=ns.decode_workers)
    else:
        source = VideoFrameSource(ns.input_path, resize=resize)

    for i, frame in enumerate(source):
        if i >= frame_limit:
            break
        if i % 5000 == 4999:
            print(f"Processing frame {i + 1}")
        cv2.imwrite(f"{ns.output_dir}/frame_{i:07}.jpg", frame)
    print("Done")


if __name__ == "__main__":
    main()
