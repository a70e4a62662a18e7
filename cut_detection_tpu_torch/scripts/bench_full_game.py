"""One whole game through the production pipeline on one card.

Port of ``scripts/bench_full_game.py``, with its environment, its
incremental merge and its record keys.  The reference's product is one
``segment_video`` pass over a ~3-hour broadcast (~324,000 frames at 30
fps).  This script writes a seeded clip of that length
(``bench_clip.make_bench_clip``, kept in the temporary directory), runs
``pipeline.segment_video_file`` once per ``transfer:precision`` mode
with windowed rates from the pipeline's own "Scored batch" log records,
and writes the record to ``FULL_GAME_OUT``.

Modes (``FULL_GAME_MODES``, comma-separated ``transfer:precision``):
  yuv420:uint8_chain   the planar upload at the fastest rung
  bgr:uint8_chain      the byte-parity transfer at the same rung
  bgr:float32          the strict-parity mode (logits within 1e-4 of the
                       JAX package), against which the fast rung's CSV is
                       compared over the whole game (``csv_parity_bgr``)

A mode whose transfer this host cannot run is recorded as ``{"skipped":
reason}`` and never run under another transfer: ``yuv420`` needs the
native decoder's YUV entry points, which need the libav headers.

Environment: ``FULL_GAME_FRAMES`` (324000), ``FULL_GAME_MODES`` (the
three above), ``FULL_GAME_OUT`` (``docs/FULL_GAME_TORCH.json``),
``FULL_GAME_WORKERS`` (decode workers, 1).  Runs merge: a run adds its
modes to an existing record of the same frame count and recomputes the
parity flags from the per-mode CSVs left in the temporary directory,
whose names carry the frame count.

    python -m cut_detection_tpu_torch.scripts.bench_full_game [--cpu]
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_MODES = "yuv420:uint8_chain,bgr:uint8_chain,bgr:float32"
PIPELINE_LOGGER = "cut_detection_tpu_torch.pipeline"
BATCH = 128
PRINT_EVERY = 20


class _BatchTimes(logging.Handler):
    """Collect (wall_time, batch_index) from 'Scored batch' log records."""

    def __init__(self):
        super().__init__()
        self.events: list[tuple[float, int]] = []

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("Scored batch "):
            self.events.append((record.created, int(msg.split()[2])))


def _windows(events, batch_size, t_start, n_windows=14):
    """Per-window fps at ~frames/n_windows granularity."""
    if not events:
        return []
    total = events[-1][1] * batch_size
    win = max(1, total // n_windows)
    out = []
    prev_t, prev_f = t_start, 0
    for t, b in events:
        f = b * batch_size
        if f - prev_f >= win:
            out.append({"frames": f,
                        "fps": round((f - prev_f) / (t - prev_t), 1)})
            prev_t, prev_f = t, f
    return out


def _flat(windows) -> bool | None:
    """Flat = every post-ramp window within 15% of the window median."""
    if len(windows) < 3:
        return None
    rates = [w["fps"] for w in windows[1:]]  # drop the ramp window
    med = float(np.median(rates))
    return bool(min(rates) >= 0.85 * med)


def settings() -> dict:
    """The run's settings from the environment."""
    return {
        "frames": int(os.environ.get("FULL_GAME_FRAMES", 324000)),
        "modes": [m.split(":") for m in os.environ.get(
            "FULL_GAME_MODES", DEFAULT_MODES).split(",") if m],
        "out": os.environ.get("FULL_GAME_OUT", os.path.join(
            REPO, "docs", "FULL_GAME_TORCH.json")),
        "workers": int(os.environ.get("FULL_GAME_WORKERS", 1)),
    }


def csv_path(frames: int, key: str) -> str:
    """Where a mode's CSV is kept between runs: the frame count is in the
    name, so a merge never compares CSVs of two different clips."""
    return os.path.join(tempfile.gettempdir(),
                        f"full_game_{frames}_{key}.csv")


def skip_reason(transfer: str) -> str | None:
    """Why this host cannot run ``transfer``, or None."""
    from cut_detection_tpu_torch.data import native_video

    if transfer == "yuv420" and not native_video.yuv_available():
        return ("the native decoder's YUV entry points are not built on "
                "this host (they need the libav headers)")
    return None


def run_mode(clip: str, net, transfer: str, precision: str, workers: int,
             out_csv: str) -> dict:
    """One mode over the whole clip: its wall time, rates and windows."""
    from cut_detection_tpu_torch.pipeline import segment_video_file

    handler = _BatchTimes()
    logger = logging.getLogger(PIPELINE_LOGGER)
    level = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)  # the "Scored batch" records are INFO
    t_start = time.perf_counter()
    t_wall0 = time.time()
    try:
        _, seg, stats = segment_video_file(
            clip, out_csv, net=net, precision=precision,
            print_every=PRINT_EVERY, decode_workers=workers,
            transfer=transfer)
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    wall = time.perf_counter() - t_start
    windows = _windows(handler.events, BATCH, t_wall0)
    return {
        "transfer": transfer, "precision": precision,
        "frames": stats.frames, "e2e_s": round(wall, 1),
        "fps": round(stats.frames / wall, 1),
        "segments": len(seg),
        "decode_failures": stats.decode_failures,
        "windows": windows,
        "windows_flat": _flat(windows),
    }


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    if any(a != "--cpu" for a in argv):
        raise SystemExit("usage: bench_full_game [--cpu]")
    from cut_detection_tpu_torch.models.assembly import load_default_net
    from cut_detection_tpu_torch.pipeline import resolve_transfer
    from cut_detection_tpu_torch.scripts.bench_clip import make_bench_clip
    from cut_detection_tpu_torch.utils.device import (
        card_info,
        resolve_device,
        strict_fp32,
    )

    cfg = settings()
    frames = cfg["frames"]
    device = resolve_device(cpu="--cpu" in argv)
    if device.type == "cuda":
        strict_fp32()
        hardware = card_info()
    else:
        hardware = f"cpu ({os.cpu_count()} cores)"
    print(f"[full-game] device={hardware} frames={frames}", file=sys.stderr,
          flush=True)
    t0 = time.perf_counter()
    clip = make_bench_clip(os.path.join(
        tempfile.gettempdir(), f"cutdet_bench_{frames}.mp4"), frames)
    print(f"[full-game] clip ready in {time.perf_counter() - t0:.0f}s",
          file=sys.stderr, flush=True)

    nets: dict = {}
    runs: dict = {}
    csvs: dict = {}
    # Merge base: modes measured by an earlier run at the same frame count.
    if os.path.isfile(cfg["out"]):
        with open(cfg["out"]) as f:
            prev = json.load(f)
        if prev.get("clip", {}).get("frames") == frames:
            runs.update(prev.get("modes", {}))
            for key in runs:
                path = csv_path(frames, key)
                if os.path.isfile(path):
                    with open(path, "rb") as f:
                        csvs[key] = f.read()
    for transfer, precision in cfg["modes"]:
        key = f"{transfer}_{precision}"
        reason = skip_reason(transfer)
        if reason is not None:
            runs[key] = {"skipped": reason}
            csvs.pop(key, None)
            print(f"[full-game] {key}: skipped: {reason}", file=sys.stderr,
                  flush=True)
            continue
        if precision not in nets:
            nets[precision], _ = load_default_net(device, precision)
        out_csv = csv_path(frames, key)
        runs[key] = run_mode(clip, nets[precision], transfer, precision,
                             cfg["workers"], out_csv)
        with open(out_csv, "rb") as f:
            csvs[key] = f.read()
        print(f"[full-game] {key}: {runs[key]['e2e_s']}s "
              f"({runs[key]['fps']} fps), "
              f"flat={runs[key]['windows_flat']}", file=sys.stderr,
              flush=True)

    # The headline: the mode the CLI's defaults run on this host.
    prod_key = f"{resolve_transfer('auto', device=device)}_uint8_chain"
    measured = {k: r for k, r in runs.items() if "skipped" not in r}
    if not measured:
        raise RuntimeError(f"no mode ran: {runs}")
    head = measured.get(prod_key) or next(iter(measured.values()))
    record = {
        "date": datetime.date.today().isoformat(),
        "hardware": hardware,
        "command": "python -m cut_detection_tpu_torch.scripts."
                   "bench_full_game",
        "clip": {"w": 640, "h": 360, "fps": 30, "frames": frames,
                 "generator": "cut_detection_tpu_torch.scripts.bench_clip."
                              "make_bench_clip (deterministic)"},
        "transfer": head["transfer"],
        "precision": head["precision"],
        "frames": head["frames"],
        "e2e_s": head["e2e_s"],
        "fps": head["fps"],
        "windows_flat": head["windows_flat"],
        "seconds_per_3h_game_1chip": head["e2e_s"],
        "modes": runs,
    }
    if "bgr_uint8_chain" in csvs and "bgr_float32" in csvs:
        record["csv_parity_bgr"] = bool(
            csvs["bgr_uint8_chain"] == csvs["bgr_float32"])
        record["csv_parity_note"] = (
            "uint8_chain CSV byte-equal to the strict-parity float32 CSV "
            "over the full game (float32 is the mode held within 1e-4 of "
            "the JAX package's logits)")
    if "yuv420_uint8_chain" in csvs and "bgr_uint8_chain" in csvs:
        record["csv_yuv_equals_bgr"] = bool(
            csvs["yuv420_uint8_chain"] == csvs["bgr_uint8_chain"])
    os.makedirs(os.path.dirname(os.path.abspath(cfg["out"])), exist_ok=True)
    with open(cfg["out"], "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
