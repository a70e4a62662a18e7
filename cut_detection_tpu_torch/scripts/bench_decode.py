"""Sequential decode throughput by backend and ffmpeg thread setting.

Port of ``scripts/bench_decode.py``, with its arguments and JSON keys.
It measures decode + resize to width 256 in frames/s for each backend,
each pass in a fresh subprocess (cv2 reads
``$OPENCV_FFMPEG_CAPTURE_OPTIONS`` when a capture opens, so a clean
process keeps the settings apart): cv2 at ``threads;1`` and ``threads;0``
(ffmpeg's own choice), best of three each; the native libav decoder
(``data.native_video``), best of three, or ``"unavailable: ..."`` where
it is not built; and one process that alternates full passes of cv2 BGR,
native BGR and, where built, native YUV420 at the target size, three
repetitions each with their median (``"failed: ..."`` where that process
fails).  The clip is ``bench_clip.make_bench_clip``'s, kept in the
temporary directory.  Decoding is the host's work: no card is used.

    python -m cut_detection_tpu_torch.scripts.bench_decode [frames]

3000 frames by default.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

WORKER = r"""
import json, sys, time
backend, clip = sys.argv[1], sys.argv[2]
if backend == "cv2":
    from cut_detection_tpu_torch.data.video import VideoFrameSource
    src = VideoFrameSource(clip, resize=256)
else:
    from cut_detection_tpu_torch.data.native_video import NativeVideoSource
    src = NativeVideoSource(clip, resize=256)
t0 = time.perf_counter(); n = 0
for _ in src:
    n += 1
print(json.dumps({"frames": n, "fps": n / (time.perf_counter() - t0)}))
"""

# Interleaved A/B in one process: full decode passes of BGR (cv2), BGR
# (native) and YUV420 (native, at the target size) in turn, so that the
# three are compared back to back rather than across drifting windows.
WORKER_AB = r"""
import json, statistics, sys, time
clip, reps = sys.argv[1], int(sys.argv[2])
from cut_detection_tpu_torch.data.video import VideoFrameSource
from cut_detection_tpu_torch.data.native_video import (
    NativeVideoSource, NativeYUVSource, yuv_available)

def run(make):
    src = make(); t0 = time.perf_counter(); n = 0
    for _ in src:
        n += 1
    dt = time.perf_counter() - t0
    if hasattr(src, "close"):
        src.close()
    return n / dt

cfgs = {"bgr_cv2": lambda: VideoFrameSource(clip, resize=256),
        "bgr_native": lambda: NativeVideoSource(clip, resize=256)}
if yuv_available():
    cfgs["yuv_native"] = lambda: NativeYUVSource(clip, resize=256)
rates = {k: [] for k in cfgs}
for r in range(reps):
    for k, mk in cfgs.items():
        rates[k].append(round(run(mk), 1))
print(json.dumps({k: {"reps": v,
                      "median": round(statistics.median(v), 1)}
                  for k, v in rates.items()}))
"""


def _env(threads: str | None = None) -> dict:
    """The workers' environment: the repo first on the path (so that the
    workers import this tree's port, whatever the caller's path names),
    and cv2's capture options only where ``threads`` is given."""
    env = dict(os.environ)
    env.pop("OPENCV_FFMPEG_CAPTURE_OPTIONS", None)
    if threads is not None:
        env["OPENCV_FFMPEG_CAPTURE_OPTIONS"] = f"threads;{threads}"
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p)
    return env


def run_ab(clip: str, reps: int = 3) -> dict:
    out = subprocess.run([sys.executable, "-c", WORKER_AB, clip, str(reps)],
                         capture_output=True, text=True, env=_env(),
                         timeout=1200)
    if out.returncode != 0:
        raise RuntimeError(out.stderr[-500:])
    return json.loads(out.stdout.strip().splitlines()[-1])


def run_one(backend: str, clip: str, threads: str | None) -> dict:
    """One full decode pass of ``clip`` by ``backend`` ("cv2" or
    "native") in a fresh process: ``{"frames": n, "fps": rate}``."""
    out = subprocess.run([sys.executable, "-c", WORKER, backend, clip],
                         capture_output=True, text=True,
                         env=_env(threads), timeout=600)
    if out.returncode != 0:
        raise RuntimeError(out.stderr[-500:])
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    frames = int(argv[0]) if argv else 3000
    from cut_detection_tpu_torch.scripts.bench_clip import make_bench_clip

    clip = make_bench_clip(
        os.path.join(tempfile.gettempdir(), f"cutdet_bench_{frames}.mp4"),
        frames)
    res: dict = {}
    for threads in ("1", "0"):  # 1 = single-threaded, 0 = ffmpeg's choice
        best = max(run_one("cv2", clip, threads)["fps"] for _ in range(3))
        res[f"cv2_threads_{threads}"] = round(best, 1)
    try:
        res["native"] = round(max(run_one("native", clip, None)["fps"]
                                  for _ in range(3)), 1)
    except Exception as e:  # noqa: BLE001 — recorded as the result
        res["native"] = f"unavailable: {e}"[:120]
    res["cores"] = os.cpu_count()
    try:
        res["ab_one_process"] = run_ab(clip)
    except Exception as e:  # noqa: BLE001 — recorded as the result
        res["ab_one_process"] = f"failed: {e}"[:200]
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
