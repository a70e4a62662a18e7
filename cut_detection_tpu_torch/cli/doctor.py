"""``doctor``: diagnose an installation of the port and its CUDA device.

Counterpart of ``cut_detection_tpu/cli/doctor.py`` (``:35-220``), with
CUDA in place of the relay.  The checks, in dependency order:

1. ``backend-init``: a CUDA device answers, with its name and compute
   capability, in bounded time (``--timeout``); with ``--cpu`` the CPU.
   Without a card and without ``--cpu`` it fails: the port never falls
   back to the CPU on its own;
2. ``kernels-build`` (on the card): the hand-written kernels compile with
   ``nvcc`` and load, bounded by ``max(--timeout, 600)`` s since a cold
   build takes minutes;
3. ``device-compute``: a small tensor makes a round trip through the
   device;
4. ``classify-step`` (``--full``): the bundled classifier through the
   pipeline's step on a zero batch of 8 at 144x256, with its kernels'
   launches by instance;
5. host decode: cv2, the native libav decoder and the native library
   (the last two optional).

Each check prints ``ok`` / ``FAIL`` (``warn`` for an optional one) with
its time; the process exits 0 when every required check passed, 1
otherwise, so a deploy script or a supervisor can gate on it.
``--json`` prints one line ``{"healthy": ..., "checks": [{check, ok,
seconds, detail, error, required}, ...]}`` instead.  A hang is a failed
check, never a hung doctor.

    python -m cut_detection_tpu_torch.cli.doctor [--full] [--json] \\
        [--timeout S] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "Diagnose a cut_detection_tpu_torch installation / CUDA device.")
    p.add_argument("--timeout", type=float, default=120.0,
                   help="Per-check wall-clock bound in seconds.")
    p.add_argument("--full", action="store_true",
                   help="Also run the serving-shape classify step (the "
                        "kernels' build is bounded by max(--timeout, 600s) "
                        "so a cold nvcc build doesn't false-fail).")
    p.add_argument("--json", action="store_true",
                   help="Emit one JSON line instead of human-readable "
                        "check output.")
    p.add_argument("--cpu", action="store_true",
                   help="Diagnose on the CPU (otherwise a CUDA device is "
                        "required).")
    return p


def _check(name: str, fn, results: list, required: bool = True) -> bool:
    t0 = time.perf_counter()
    try:
        detail = fn()
        ok = True
        err = None
    except Exception as e:  # noqa: BLE001 — every fault is a finding here
        detail = None
        ok = False
        err = f"{type(e).__name__}: {e}"[:300]
    dt = time.perf_counter() - t0
    results.append({"check": name, "ok": ok, "seconds": round(dt, 2),
                    "detail": detail, "error": err, "required": required})
    return ok


def _probe_backend(cpu: bool) -> dict:
    """The device the port would run on, and what it is."""
    import torch

    from cut_detection_tpu_torch.utils.device import resolve_device

    device = resolve_device(cpu=cpu)
    if device.type == "cpu":
        return {"platform": "cpu", "threads": torch.get_num_threads()}
    major, minor = torch.cuda.get_device_capability(0)
    return {"platform": "cuda", "devices": torch.cuda.device_count(),
            "name": torch.cuda.get_device_name(0),
            "capability": f"{major}.{minor}",
            "torch_cuda": torch.version.cuda}


def _backend_init(cpu: bool, timeout: float) -> dict:
    from cut_detection_tpu_torch.utils.device import bounded_call

    return bounded_call(lambda: _probe_backend(cpu), timeout, "backend init")


def _kernels_build(timeout: float) -> dict:
    from cut_detection_tpu_torch.ops.kernels import _build
    from cut_detection_tpu_torch.utils.device import bounded_call

    bounded_call(_build.library, timeout, "kernel build")
    return {"library": _build._lib_path(),
            "build_seconds": round(_build.BuildInfo.seconds, 2)}


def _device_compute(device, timeout: float) -> dict:
    from cut_detection_tpu_torch.utils.device import bounded_call

    def probe():
        import torch

        # A fetch: only a value back on the host proves the round trip.
        return float(torch.arange(8.0, device=device).sum())

    value = bounded_call(probe, timeout, "device compute probe")
    if value != 28.0:
        raise ValueError(f"device returned {value}, expected 28.0")
    return {"roundtrip": "ok"}


def _classify_step(device, timeout: float) -> dict:
    from cut_detection_tpu_torch.utils.device import bounded_call

    def probe():
        import torch

        from cut_detection_tpu_torch.models.assembly import load_default_net
        from cut_detection_tpu_torch.ops.kernels import launch_counts
        from cut_detection_tpu_torch.pipeline import make_classify_step

        net, _ = load_default_net(device)
        step = make_classify_step(net)
        before = launch_counts()
        conf, pred = step(torch.zeros((8, 144, 256, 3), dtype=torch.uint8,
                                      device=device))
        conf.cpu(), pred.cpu()
        launches = {k: n - before[k] for k, n in launch_counts().items()
                    if n != before[k]}
        return {"params": net.num_params(), "launches": launches}

    return bounded_call(probe, timeout, "classify step")


def _decode_cv2() -> dict:
    import tempfile

    import cv2
    import numpy as np

    # Unique probe path (concurrent doctors must not race on one file),
    # always cleaned up.
    fd, path = tempfile.mkstemp(prefix="cutdet_doctor_", suffix=".mp4")
    os.close(fd)
    try:
        wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30,
                             (64, 36))
        for _ in range(3):
            wr.write(np.zeros((36, 64, 3), np.uint8))
        wr.release()
        from cut_detection_tpu_torch.data.video import VideoFrameSource

        frames = sum(1 for _ in VideoFrameSource(path, resize=None))
    finally:
        try:
            os.unlink(path)
        except OSError:
            pass
    if frames != 3:
        raise ValueError(f"decoded {frames} frames, expected 3")
    return {"cv2": cv2.__version__}


def _decoder_native() -> dict:
    from cut_detection_tpu_torch.data import native_video

    if not native_video.available():
        raise RuntimeError("native libav decoder not built "
                           "(make -C native)")
    return {"native_decoder": "available"}


def _native_lib() -> dict:
    from cut_detection_tpu_torch import native

    if not native.available():
        raise RuntimeError("cutdet_native library not built "
                           "(make -C native)")
    return {"native": "available"}


def main(args=None) -> None:
    parser = build_parser()
    ns = parser.parse_args(args)
    if ns.timeout <= 0:
        parser.error("--timeout must be positive")
    from cut_detection_tpu_torch.utils.logging import setup_logging

    setup_logging()

    results: list = []
    init_ok = _check("backend-init", lambda: _backend_init(ns.cpu,
                                                           ns.timeout),
                     results)
    if init_ok:
        import torch

        device = torch.device("cpu" if ns.cpu else "cuda")
        built = ns.cpu or _check(
            "kernels-build", lambda: _kernels_build(max(ns.timeout, 600.0)),
            results)
        compute_ok = _check("device-compute",
                            lambda: _device_compute(device, ns.timeout),
                            results)
        if compute_ok and built and ns.full:
            _check("classify-step",
                   lambda: _classify_step(device, max(ns.timeout, 600.0)),
                   results)
    _check("decode-cv2", _decode_cv2, results)
    # Optional accelerations: their absence is a warning, not a failure
    # (the cv2 and numpy paths are complete fallbacks).
    _check("decoder-native", _decoder_native, results, required=False)
    _check("native-lib", _native_lib, results, required=False)

    healthy = all(r["ok"] for r in results if r["required"])
    if ns.json:
        print(json.dumps({"healthy": healthy, "checks": results}))
    else:
        for r in results:
            mark = "ok  " if r["ok"] else ("warn" if not r["required"]
                                           else "FAIL")
            line = f"[{mark}] {r['check']:16s} {r['seconds']:7.2f}s"
            if r["detail"]:
                line += f"  {r['detail']}"
            if r["error"]:
                line += f"  {r['error']}"
            print(line)
        print("healthy" if healthy else "UNHEALTHY")
    sys.exit(0 if healthy else 1)


if __name__ == "__main__":
    main()
