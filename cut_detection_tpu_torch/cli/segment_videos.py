"""Batch inference CLI of the port: segment many videos with one model.

Port of ``cut_detection_tpu/cli/segment_videos.py``, with its flags and
defaults, on ``pipeline.segment_many``: one net and one step for every
video, and video i + 1's host decode running while video i is on the
device (``--no-decode-ahead`` turns that off).  The model runs on the
CUDA device, or on the CPU with ``--cpu``.

``--data-parallel`` splits the videos over this process's cards when it
has more than one: a process a card (at most one a video), each
segmenting its round-robin share (``partition_inputs``) unsharded.  The
JAX CLI shards every frame batch over a mesh instead; in the port that
loop is bound by its one host thread, and a batch split over 2 to 4
cards ran at 0.6-0.9x one card's frames/s.  Split by video, the
processes are bound by the host's decode and resize: over four cards
1.1x one card's frames/s once they have started, which takes each some
10 s (``PERF.md`` section 5).  ``--multi-host`` joins
the process group torchrun's environment describes
(``parallel.distributed.initialize``; a no-op without one) and keeps
this process's round-robin share of the videos.  The group runs over
gloo: it only partitions the list, and nothing crosses between
processes on the card.  Each process then owns its cards
(``distributed.local_devices``: with one process a host, all of them;
with one a card, its own), and ``--data-parallel`` splits its share over
those alone, where a JAX mesh from ``make_mesh()`` spans every host's
devices.

    python -m cut_detection_tpu_torch.cli.segment_videos A.mp4 B.mp4 \\
        [--transfer {auto,bgr,yuv420}] [--precision ...] [--cpu] \\
        [--data-parallel] [--multi-host]
"""

from __future__ import annotations

import argparse
import logging
import multiprocessing
import time

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
                   help="Split the videos over this process's cards, a "
                        "process a card, each taking its round-robin "
                        "share (with one card: unsharded).")
    p.add_argument("--multi-host", action="store_true",
                   help="Join torchrun's process group and take this "
                        "process's round-robin shard of the video list "
                        "(no-op in a single process).")
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

    import torch.distributed as dist

    from cut_detection_tpu_torch.parallel import distributed

    inputs = ns.input_paths
    if ns.multi_host:
        pid = distributed.initialize(backend="gloo")
        inputs = distributed.partition_inputs(inputs)
        logging.info("process %d segments %d of %d videos", pid,
                     len(inputs), len(ns.input_paths))
    try:
        return _run(ns, inputs, device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _run(ns, inputs: list[str], device) -> list[str]:
    """Segment ``inputs`` on this process's first card, or, with
    ``--data-parallel`` and several cards, in a process a card."""
    devices = [device]
    if device.type == "cuda":
        from cut_detection_tpu_torch.parallel.distributed import (
            local_devices,
        )

        owned = local_devices()
        devices = (owned[:max(1, len(inputs))] if ns.data_parallel
                   else owned[:1])
    if len(devices) == 1:
        return _segment(ns, inputs, devices[0])
    return segment_per_device(ns, inputs, devices)[0]


def segment_per_device(ns, inputs: list[str],
                       devices) -> tuple[list[str], float]:
    """``_segment`` in a process a device (``multiprocessing``'s spawn),
    the one on device i taking the videos ``partition_inputs`` gives
    process i of ``len(devices)``; returns the CSV paths in input order
    and the seconds the slowest process took from loading the net to its
    last CSV (its interpreter's start-up excluded).  Raises naming the
    devices whose process failed; none is left running."""
    from cut_detection_tpu_torch.parallel.distributed import (
        partition_inputs,
    )
    from cut_detection_tpu_torch.pipeline import default_output_path

    n = len(devices)
    ctx = multiprocessing.get_context("spawn")
    done = ctx.SimpleQueue()
    shares = [partition_inputs(inputs, process_id=i, num_processes=n)
              for i in range(n)]
    procs = [ctx.Process(target=_device_worker, name=f"segment[{d}]",
                         args=(ns, share, str(d), done))
             for share, d in zip(shares, devices)]
    logging.info("%d videos over %d devices, a process each", len(inputs), n)
    try:
        for p in procs:
            p.start()
        for p in procs:
            p.join()
    finally:
        for p in procs:
            if p.pid is not None and p.is_alive():
                p.terminate()
                p.join()
    failed = [str(d) for p, d in zip(procs, devices) if p.exitcode != 0]
    if failed:
        raise RuntimeError(f"segment_videos: the process on {failed} failed")
    seconds = max(done.get() for _ in procs)
    logging.info("%d videos over %d devices: the slowest process took "
                 "%.2f s after its start-up", len(inputs), n, seconds)
    return [default_output_path(p) for p in inputs], seconds


def _device_worker(ns, inputs: list[str], device: str, done) -> None:
    """One device's process of ``segment_per_device``; puts its seconds
    from loading the net to its last CSV on ``done``."""
    import torch

    from cut_detection_tpu_torch.utils.device import strict_fp32

    setup_logging()
    strict_fp32()
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    _segment(ns, inputs, dev)
    done.put(time.perf_counter() - t0)


def _segment(ns, inputs: list[str], device) -> list[str]:
    from cut_detection_tpu_torch.models.assembly import (
        load_triplet_or_default,
    )
    from cut_detection_tpu_torch.pipeline import segment_many

    logging.info("Using %s", device)
    net, _ = load_triplet_or_default(ns.model_dir, ns.model_name, device,
                                     ns.precision)
    results = segment_many(
        inputs,
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
