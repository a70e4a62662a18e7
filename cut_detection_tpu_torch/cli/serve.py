"""The port's HTTP serving daemon: ``cut_detection_tpu/cli/serve.py`` on
PyTorch + CUDA.

Every endpoint, option and rule of the JAX daemon, on the port's step,
kernels and segmentation; its CSVs are the JAX daemon's byte for byte at
``transfer: "bgr"``, float32.  What differs: the model runs on the CUDA
device, or on the CPU with ``--cpu``; the device heartbeat's probe is a
tiny op on the model's device followed by ``torch.cuda.synchronize``
there; warmup runs the port's ``make_classify_step`` on a zero batch;
JAX's start-up (its compile cache, its backend init and the mesh) is
gone, and ``--data-parallel`` is refused at parse time (ROADMAP.md Queue
1 item 5).

    python -m cut_detection_tpu_torch.cli.serve [--port 8571] \\
        [--precision ...] [--transfer {auto,bgr,yuv420}] [--cpu]

The reference ships only a batch Docker ENTRYPOINT (Dockerfile:36).  For
production serving this daemon keeps the model loaded and the classify
step built, processing one video per request (videos are local paths —
the deployment contract mounts media under a shared volume, like the
reference's ``-v $(OUTPUT_LOC):/home/sources`` runner, Makefile:20-24).

API (stdlib http.server; no extra dependencies):

- ``GET  /healthz``                      -> {"status": "ok", ...}; turns
  503/"stuck" when the device-liveness heartbeat goes stale (a hung
  device blocks forever instead of raising — ``--heartbeat-interval``)
- ``GET  /metrics``                      -> request/queue/latency counters
- ``POST /segment`` body {"input_path": ..., optional "output_path",
  "base_threshold", "blank_threshold", "batch_size", "frame_limit",
  "decode_workers"}    -> {"output_path", "segments": [[start, label],
  ...], "stats": {...}}
- ``POST /segment_batch`` body {"input_paths": [...], ...same options}
  -> {"results": [per-video result or {"error": ...}]}
- ``POST /upload?name=game.mp4`` raw video bytes -> {"input_path": ...}
  (spooled under --spool-dir; size-capped by --max-upload-mb) — remote
  ingestion without a shared volume mount.
- ``POST /reload`` body {optional "model_dir", "model_name",
  "precision", "model"} — hot-swap a served model without restarting
  (loads and validates the new triplet first, then swaps under the
  device lock; in-flight requests finish on the old model).

Multi-model routing: ``--model NAME=DIR[:MODEL_NAME]`` (repeatable)
preloads additional checkpoints; requests pick one with
``{"model": "NAME"}`` (the bundled/default model is ``"default"``), and
``/reload`` with ``"model": "NAME"`` swaps that entry.

TLS: ``--certfile/--keyfile`` serve HTTPS; adding ``--client-ca``
requires client certificates (mTLS) so only holders of certs signed by
that CA can reach the daemon.  ``--auth-token`` (or $CUTDET_AUTH_TOKEN)
instead gates every endpoint except /healthz on a bearer token — the
lighter-weight option when TLS terminates at a fronting proxy.

Device work is serialized through a lock — the card is a single-program
resource; concurrency belongs at the batch level, not the request level.
A queued request's HOST decode starts immediately though (decode-ahead
into a bounded prefetch queue, ``--no-decode-ahead`` to disable).
Prefetch SLOTS bound host memory: at most 2 decode pipelines exist at
once regardless of queue depth, and waiters re-try claiming a slot
while queued on the device lock, so the next request in line starts
decoding the moment a slot frees.  ``/segment_batch`` additionally
pipelines each video's decode under the previous video's device time —
the card never idles waiting for the next decode.  ``/metrics``
reports the resulting queue depth and wait/latency percentiles so
operators can see saturation.

The CLI warms the serving-shape classify step at startup (and
``/reload`` warms the incoming model before swapping), so the first
request never pays the kernel build and the step's setup while holding
the device lock; ``--no-warmup`` / ``{"warmup": false}`` opt out.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import re
import tempfile
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from cut_detection_tpu_torch.config import PRECISION_CHOICES
from cut_detection_tpu_torch.utils.logging import setup_logging

logger = logging.getLogger(__name__)

_LATENCY_WINDOW = 512  # rolling sample window for percentile metrics


class _DeviceHeartbeat(threading.Thread):
    """Background device-liveness probe feeding ``/healthz``.

    The worst failure mode of an accelerator is a HANG: in-flight device
    calls block forever without raising, so the daemon keeps accepting
    requests that will never finish and an HTTP health check that only
    proves the process is alive stays green.  This thread runs a tiny op
    on the model's device every ``interval`` seconds, synchronizes the
    device and fetches the value (sub-ms of device time; classify steps
    are ~ms, so a healthy-but-busy device still answers promptly) and
    records the last success.
    ``/healthz`` turns 503/"stuck" when that success is older than
    ``stale_after`` — a duration-of-request check can't do this, because
    a long video legitimately holds the device lock for minutes.

    A wedged probe call itself never returns, so probes run on small
    disposable threads with at most ``_MAX_OUTSTANDING`` in flight —
    staleness keeps growing while they hang, and whichever one finally
    completes (device healed) resets the clock.  Completed requests also
    reset it via :meth:`note_ok` (they prove the device end-to-end).
    """

    _MAX_OUTSTANDING = 4

    def __init__(self, interval: float = 60.0,
                 stale_after: float | None = None, device=None):
        super().__init__(daemon=True, name="device-heartbeat")
        self.device = torch.device(device or "cpu")
        self.interval = interval
        self.stale_after = stale_after or max(3.0 * interval, 180.0)
        self._meta = threading.Lock()
        # Not ``_stop``: that name is threading.Thread's own (join calls it).
        self._halt = threading.Event()
        self._started_at = time.monotonic()
        self._last_ok: float | None = None
        self._last_err: str | None = None
        self._outstanding = 0
        self._last_launch = self._started_at

    def note_ok(self) -> None:
        with self._meta:
            self._last_ok = time.monotonic()

    def _probe(self) -> None:
        try:
            one = torch.ones((), device=self.device)
            value = one + one
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            float(value)  # the fetch proves the op completed
            self.note_ok()
            with self._meta:
                self._last_err = None
        except Exception as e:  # noqa: BLE001 — any fault is a liveness miss
            with self._meta:
                self._last_err = f"{type(e).__name__}: {e}"[:200]
        finally:
            with self._meta:
                self._outstanding -= 1

    def run(self) -> None:
        while not self._halt.wait(self.interval):
            now = time.monotonic()
            with self._meta:
                if self._outstanding >= self._MAX_OUTSTANDING:
                    # Hung probes piling up — but if probes blocked on a
                    # dead connection NEVER return, an idle daemon would
                    # otherwise stay 503 forever after the device heals
                    # (no request arrives to reset the clock once a load
                    # balancer pulls a stuck backend).  Let one fresh
                    # probe through per stale_after window: recovery
                    # stays possible and thread leakage during an
                    # extended outage stays bounded (~1/stale_after).
                    if now - self._last_launch < self.stale_after:
                        continue
                self._outstanding += 1
                self._last_launch = now
            threading.Thread(target=self._probe, daemon=True,
                             name="device-heartbeat-probe").start()

    def stop(self) -> None:
        self._halt.set()

    def status(self) -> dict:
        with self._meta:
            last_ok, last_err = self._last_ok, self._last_err
            outstanding = self._outstanding
        ref = last_ok if last_ok is not None else self._started_at
        age = time.monotonic() - ref
        return {
            "ok_age_s": round(age, 1),
            "stale_after_s": self.stale_after,
            "stuck": age > self.stale_after,
            "outstanding_probes": outstanding,
            "last_error": last_err,
        }


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("Serve the segmentation pipeline over HTTP.")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8571)
    p.add_argument("--precision",
                   choices=list(PRECISION_CHOICES),
                   default="float32")
    p.add_argument("--model-dir", type=str, default=None,
                   help="Serve a trained triplet instead of the bundled "
                        "prod classifier.")
    p.add_argument("--model-name", type=str, default="init_model")
    p.add_argument("--model", action="append", default=[],
                   metavar="NAME=DIR[:MODEL_NAME]",
                   help="Preload an extra checkpoint under NAME "
                        "(repeatable); requests select it with "
                        '{"model": "NAME"}.')
    p.add_argument("--spool-dir", type=str, default=None,
                   help="Directory for /upload ingestion (default: a "
                        "fresh tempdir).")
    p.add_argument("--max-upload-mb", type=int, default=2048,
                   help="Reject /upload bodies larger than this.")
    p.add_argument("--spool-ttl-hours", type=float, default=24.0,
                   help="Delete spooled uploads older than this (swept "
                        "on each /upload).")
    p.add_argument("--certfile", type=str, default=None,
                   help="PEM certificate: serve HTTPS instead of HTTP.")
    p.add_argument("--keyfile", type=str, default=None,
                   help="PEM private key for --certfile.")
    p.add_argument("--client-ca", type=str, default=None,
                   help="CA bundle; require client certs signed by it "
                        "(mTLS).  Implies --certfile/--keyfile.")
    p.add_argument("--auth-token", type=str,
                   default=os.environ.get("CUTDET_AUTH_TOKEN"),
                   help="Require 'Authorization: Bearer <token>' on every "
                        "endpoint except /healthz (default from "
                        "$CUTDET_AUTH_TOKEN).")
    p.add_argument("--transfer", choices=["auto", "bgr", "yuv420"],
                   default="auto",
                   help="Default host->device byte format for requests "
                        "that don't specify one.  'yuv420' uploads "
                        "planar YUV at 1.5 B/px (half of BGR24) and "
                        "converts on device — a fast-path mode "
                        "(YUV-space resize; accuracy-gated, not "
                        "byte-parity) needing the native decoder's YUV "
                        "entry points.  'auto' (default) picks yuv420 "
                        "when it can run and wins, bgr otherwise.  "
                        "Requests override with "
                        '{"transfer": "auto"|"bgr"|"yuv420"}.')
    p.add_argument("--no-decode-ahead", action="store_true",
                   help="Disable overlapping a queued request's host "
                        "decode with the in-flight request's device "
                        "compute (decode-ahead is on by default).")
    p.add_argument("--no-warmup", action="store_true",
                   help="Skip running the serving-shape classify step "
                        "at startup (warmup is on by default so the "
                        "first request doesn't pay the kernel build).")
    p.add_argument("--data-parallel", action="store_true",
                   help="Not ported yet (ROADMAP.md Queue 1 item 5); "
                        "refused.")
    p.add_argument("--heartbeat-interval", type=float, default=60.0,
                   help="Seconds between device-liveness probes; "
                        "/healthz turns 503 when the device has not "
                        "answered for 3x this (floor 180s — a hung "
                        "device blocks forever instead of raising, "
                        "which no process-alive check catches).  "
                        "0 disables.")
    p.add_argument("--cpu", action="store_true",
                   help="Serve on the CPU (otherwise a CUDA device is "
                        "required).")
    return p


class _State:
    def __init__(self):
        self.net = None
        self.precision = "float32"
        self.lock = threading.Lock()
        self.meta_lock = threading.Lock()
        self.requests_served = 0
        self.requests_failed = 0
        self.frames_total = 0
        self.queue_depth = 0  # requests waiting on or holding the lock
        self.wait_s = []      # rolling lock-wait samples
        self.latency_s = []   # rolling end-to-end samples
        self.started = time.time()
        self.spool_dir = None
        self.max_upload_bytes = 2 << 30
        self.spool_ttl_s = 24 * 3600.0
        self.auth_token = None
        self.decode_ahead = True
        # Server-level default host->device byte format; per-request
        # {"transfer": ...} overrides.  "yuv420" halves upload bytes
        # (pipeline.classify_video) but is accuracy-gated, not
        # byte-parity — the operator opts in.
        self.transfer = "bgr"
        # Decode-ahead slot accounting: at most this many prefetch
        # pipelines alive at once, so host memory stays bounded at
        # ~slots x prefetch_batches x batch_size frames no matter how
        # deep the request queue gets.  Waiters re-try claiming a slot
        # while queued on the device lock, so the next-in-line request
        # starts its decode as soon as a slot frees (not only if it
        # happened to arrive when the queue was short).
        self.prefetch_slots = 2
        self.active_prefetch = 0
        # Server-level warmup policy; /reload defaults to it (a server
        # started with --no-warmup shouldn't warm on reload unless the
        # request explicitly asks with {"warmup": true}).
        self.warmup_default = False
        self.nets = {}  # name -> GluedNet ("default" = self.net)
        self.heartbeat: _DeviceHeartbeat | None = None
        self.device = torch.device("cpu")  # where every model runs

    def sweep_spool(self) -> int:
        """Delete spool files older than the TTL; returns count removed.

        Called on every /upload so a long-lived daemon's disk use is
        bounded by (upload rate x TTL) instead of growing forever."""
        removed = 0
        try:
            entries = os.listdir(self.spool_dir)
        except OSError:
            return 0
        cutoff = time.time() - self.spool_ttl_s
        for name in entries:
            p = os.path.join(self.spool_dir, name)
            try:
                if os.path.isfile(p) and os.path.getmtime(p) < cutoff:
                    os.unlink(p)
                    removed += 1
            except OSError:  # raced with another sweep/consumer
                pass
        return removed

    def record(self, wait: float, latency: float, frames: int) -> None:
        with self.meta_lock:
            self.requests_served += 1
            self.frames_total += frames
            self.wait_s = (self.wait_s + [wait])[-_LATENCY_WINDOW:]
            self.latency_s = (self.latency_s + [latency])[-_LATENCY_WINDOW:]
        if self.heartbeat is not None:
            # A completed request proves the device end-to-end; don't
            # let an unlucky probe schedule mark a working daemon stuck.
            self.heartbeat.note_ok()

    def metrics(self) -> dict:
        def pct(xs, q):
            if not xs:
                return 0.0
            xs = sorted(xs)
            return round(xs[min(len(xs) - 1, int(q * len(xs)))], 3)

        with self.meta_lock:
            out = {
                "uptime_s": round(time.time() - self.started, 1),
                "requests_served": self.requests_served,
                "requests_failed": self.requests_failed,
                "frames_total": self.frames_total,
                "queue_depth": self.queue_depth,
                "lock_wait_p50_s": pct(self.wait_s, 0.5),
                "lock_wait_p95_s": pct(self.wait_s, 0.95),
                "latency_p50_s": pct(self.latency_s, 0.5),
                "latency_p95_s": pct(self.latency_s, 0.95),
                "precision": self.precision,
            }
        if self.heartbeat is not None:
            # Full (unredacted) liveness detail lives behind the auth
            # gate; /healthz carries the redacted form.
            out["device"] = self.heartbeat.status()
        return out


class CapabilityError(ValueError):
    """A request needs a capability this server wasn't built with (e.g.
    yuv420 transfer without the native decoder's YUV entry points).
    Mapped to HTTP 501, not 400 — operators and monitoring must be able
    to tell a server capability gap from a malformed request.
    """


def _resolved_transfer(req: dict, state: "_State") -> str:
    """Request transfer (default: the server's), with "auto" resolved."""
    t = req.get("transfer", state.transfer)
    if t == "auto":
        from cut_detection_tpu_torch.pipeline import resolve_transfer

        t = resolve_transfer("auto", device=state.device)
    return t


def _warmup_modes(state: "_State") -> list[str]:
    """Transfer modes to warm: the server default plus — when the
    native YUV decoder is present — the other mode, so a per-request
    override doesn't pay a cold step inside its own request."""
    from cut_detection_tpu_torch.data import native_video

    modes = [state.transfer]
    if native_video.yuv_available():
        modes.append("bgr" if state.transfer == "yuv420" else "yuv420")
    return modes


def _warmup_net(net, batch_size: int = 128,
                resize_hw: tuple = (144, 256),
                transfer: str = "bgr") -> float:
    """Build and run the serving-shape classify step on a zero batch on
    the net's device; returns seconds.

    The first call builds the kernels (nvcc) and the step's frozen
    weights; warming at startup/reload moves that cost off the request
    path, where it would run while holding the device lock.  The default
    shape (reference batch 128, the 16:9 resize output 144x256) covers
    the dominant case; other aspect ratios or batch sizes set up their
    step on their first request.
    """
    from cut_detection_tpu_torch.pipeline import make_classify_step

    t0 = time.time()
    h, w = resize_hw
    if transfer == "yuv420":
        # Packed planar-YUV vectors at the default serving geometry (the
        # step is memoized per yuv_dims).
        from cut_detection_tpu_torch.geometry import yuv420_nbytes

        step = make_classify_step(net, yuv_dims=(h, w))
        frames = torch.zeros((batch_size, yuv420_nbytes(h, w)),
                             dtype=torch.uint8, device=net.device)
    else:
        step = make_classify_step(net)
        frames = torch.zeros((batch_size, h, w, 3), dtype=torch.uint8,
                             device=net.device)
    conf, pred = step(frames)
    conf.cpu(), pred.cpu()  # fetch: proves execution completed
    return time.time() - t0


def _try_prefetch(state: _State, input_path: str, batch_size: int,
                  decode_workers: int):
    """Claim a prefetch slot and start decode-ahead; None if slots full.

    The slot is released exactly once, through the loader's ``on_close``
    callback — which fires automatically when ``classify_video`` drains
    the batches (so the slot frees as soon as the decoded frames are
    consumed, not when the whole request finishes) or via the owner's
    ``preloaded[1].close()`` on error paths.
    """
    if not (state.decode_ahead and os.path.isfile(input_path)):
        return None
    with state.meta_lock:
        if state.active_prefetch >= state.prefetch_slots:
            return None
        state.active_prefetch += 1

    released = [False]

    def release() -> None:
        with state.meta_lock:
            if not released[0]:
                released[0] = True
                state.active_prefetch -= 1

    try:
        from cut_detection_tpu_torch.pipeline import start_decode_ahead

        return start_decode_ahead(input_path, batch_size=batch_size,
                                  decode_workers=decode_workers,
                                  on_close=release)
    except Exception:
        release()
        logger.exception("decode-ahead failed for %s", input_path)
        return None


def _make_handler(state: _State):
    class Handler(BaseHTTPRequestHandler):
        # Bounds socket reads (including deferred TLS handshakes) so a
        # stalled client releases its handler thread.
        timeout = 120

        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # route through logging
            logger.info("%s - %s", self.address_string(), fmt % args)

        def _authorized(self) -> bool:
            """Bearer-token gate for every endpoint except /healthz.

            Constant-time comparison; when --auth-token is unset the
            daemon is open (use behind a trusted network or mTLS)."""
            if not state.auth_token:
                return True
            got = self.headers.get("Authorization", "")
            import hmac

            # Compare bytes: compare_digest on str raises TypeError for
            # non-ASCII (header bytes are latin-1-decoded), which would
            # kill the handler thread instead of returning 401.  Wire
            # bytes for a non-ASCII token depend on the client stack
            # (curl sends utf-8, http.client sends latin-1), so accept
            # either encoding; both comparisons always run.
            raw = got.encode("latin-1", "replace")
            bearer = "Bearer " + state.auth_token
            ok_utf8 = hmac.compare_digest(raw, bearer.encode("utf-8"))
            ok_lat1 = hmac.compare_digest(
                raw, bearer.encode("latin-1", "replace"))
            if ok_utf8 or ok_lat1:
                return True
            self._reply(401, {"error": "missing or bad bearer token"})
            return False

        def do_GET(self):
            if self.path == "/healthz":
                device = (state.heartbeat.status()
                          if state.heartbeat is not None else None)
                if device and state.auth_token:
                    # /healthz is the one unauthenticated endpoint; raw
                    # exception text belongs behind the gate (/metrics).
                    device.pop("last_error", None)
                stuck = bool(device and device["stuck"])
                # 503 (not 200 + a field) so plain HTTP health checks —
                # load balancers, restart supervisors — catch a wedged
                # device without parsing the body.
                self._reply(503 if stuck else 200, {
                    "status": "stuck" if stuck else "ok",
                    "requests_served": state.requests_served,
                    "precision": state.precision,
                    "models": ["default"] + sorted(state.nets),
                    "device": device,
                })
            elif self.path == "/metrics":
                if self._authorized():
                    self._reply(200, state.metrics())
            else:
                self._reply(404, {"error": "not found"})

        def _segment_one(self, input_path: str, req: dict,
                         allow_output_path: bool = True,
                         preloaded=None) -> dict:
            """Run one video through the pipeline (serialized); returns
            the response payload.  Raises ValueError for bad inputs.
            ``preloaded`` hands over an already-started decode-ahead
            handle (the batch endpoint pipelines video i+1's decode
            under video i's device time); ownership transfers — it is
            closed here on every path."""
            from cut_detection_tpu_torch.pipeline import segment_video_file

            model = req.get("model", "default")
            net = state.net if model == "default" else \
                state.nets.get(model)
            if net is None:
                if preloaded is not None:  # ownership is ours to release
                    preloaded[1].close()
                raise ValueError(
                    f"unknown model {model!r}; loaded: "
                    f"{['default'] + sorted(state.nets)}")
            kwargs = {
                k: req[k] for k in (
                    "output_path", "base_threshold", "blank_threshold",
                    "batch_size", "frame_limit", "decode_workers",
                    "transfer",
                ) if k in req
            }
            transfer = kwargs.setdefault("transfer", state.transfer)
            if transfer not in ("auto", "bgr", "yuv420"):
                if preloaded is not None:
                    preloaded[1].close()
                raise ValueError(
                    f"unknown transfer {transfer!r} "
                    "(choices: auto, bgr, yuv420)")
            if transfer == "auto":
                transfer = kwargs["transfer"] = _resolved_transfer(
                    req, state)
            if transfer == "yuv420":
                from cut_detection_tpu_torch.data import native_video

                if not native_video.yuv_available():
                    if preloaded is not None:
                        preloaded[1].close()
                    raise CapabilityError(
                        "transfer='yuv420' unavailable on this server: "
                        "the native decoder lacks YUV entry points "
                        "(make -C native)")
                if preloaded is not None:
                    # Decode-ahead handles carry BGR batches; the yuv420
                    # pipeline can't consume them (pipeline.classify_video
                    # rejects the combination) — drop the handle and let
                    # the request decode to YUV itself.
                    preloaded[1].close()
                    preloaded = None
            output_path = kwargs.pop("output_path", None)
            if not allow_output_path:
                # Batch mode: one shared output_path would make every
                # video overwrite the same CSV; use per-video defaults
                # (input stem + _segments.csv).
                output_path = None
            t0 = time.time()
            with state.meta_lock:
                state.queue_depth += 1
            try:
                # Start this request's host decode BEFORE waiting on the
                # device lock: while request N holds the card, request
                # N+1's decode fills a bounded prefetch queue, so the
                # card-idle-during-decode serialization collapses to
                # max(decode, device) across requests.
                # Prefetch slots (not queue position) bound host memory:
                # at most state.prefetch_slots pipelines exist at once,
                # and a queued request keeps re-trying to claim a slot
                # while waiting on the device lock — so the next request
                # in line starts decoding as soon as a slot frees, even
                # at saturation depth.
                bs = kwargs.get("batch_size", 128)
                dw = kwargs.get("decode_workers", 1)
                # yuv420 requests decode to target-size YUV inside the
                # pipeline; the BGR decode-ahead path doesn't apply.
                want_pre = transfer != "yuv420"
                if preloaded is None and want_pre:
                    preloaded = _try_prefetch(state, input_path, bs, dw)
                while not state.lock.acquire(timeout=0.2):
                    if preloaded is None and want_pre:
                        preloaded = _try_prefetch(state, input_path, bs, dw)
                try:
                    t1 = time.time()
                    out, seg, stats = segment_video_file(
                        input_path, output_path, net=net,
                        print_every=0, preloaded=preloaded, **kwargs)
                finally:
                    state.lock.release()
            finally:
                if preloaded is not None:
                    preloaded[1].close()
                with state.meta_lock:
                    state.queue_depth -= 1
            state.record(t1 - t0, time.time() - t0, stats.frames)

            from cut_detection_tpu_torch.segmentation.rle import (
                INVERSE_LAB_ENUM,
            )

            segments = [
                [int(sf), INVERSE_LAB_ENUM[int(tp)]]
                for sf, tp in zip(seg.te["start_frames"],
                                  seg.te["frame_types"])
            ]
            return {
                "output_path": out,
                "segments": segments,
                "stats": {
                    "frames": stats.frames,
                    "batches": stats.batches,
                    "decode_failures": stats.decode_failures,
                    "frames_per_sec": round(stats.frames_per_sec, 2),
                },
            }

        def _do_upload(self):
            """Spool raw request-body bytes to --spool-dir."""
            try:
                length = int(self.headers.get("Content-Length", 0))
            except ValueError:
                self._reply(400, {"error": "bad Content-Length"})
                return
            if length <= 0:
                self._reply(400, {"error": "empty upload"})
                return
            if length > state.max_upload_bytes:
                self._reply(413, {"error": "upload exceeds --max-upload-mb"})
                return
            swept = state.sweep_spool()
            if swept:
                logger.info("spool sweep removed %d expired upload(s)",
                            swept)
            query = urllib.parse.parse_qs(
                urllib.parse.urlparse(self.path).query)
            name = query.get("name", ["upload.mp4"])[-1] or "upload.mp4"
            # Sanitize: basename only, conservative charset.
            name = re.sub(r"[^A-Za-z0-9._-]", "_",
                          os.path.basename(name)) or "upload.mp4"
            os.makedirs(state.spool_dir, exist_ok=True)
            fd, path = tempfile.mkstemp(prefix="", suffix="-" + name,
                                        dir=state.spool_dir)
            remaining = length
            with os.fdopen(fd, "wb") as f:
                while remaining:
                    chunk = self.rfile.read(min(1 << 20, remaining))
                    if not chunk:
                        break
                    f.write(chunk)
                    remaining -= len(chunk)
            if remaining:
                os.unlink(path)
                self._reply(400, {"error": "truncated upload"})
                return
            self._reply(200, {"input_path": path, "bytes": length})

        def _do_reload(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
            except ValueError as e:
                self._reply(400, {"error": f"bad request: {e}"})
                return
            from cut_detection_tpu_torch.models.assembly import (
                load_triplet_or_default,
            )

            precision = req.get("precision", state.precision)
            if precision not in PRECISION_CHOICES:
                self._reply(400, {"error": f"unknown precision "
                                           f"{precision!r}"})
                return
            try:
                # Load + validate OUTSIDE the lock (requests keep being
                # served on the old model), then swap atomically.  The
                # dummy forward catches params-JSON/npz shape mismatches
                # a bare load would miss.
                net, _ = load_triplet_or_default(
                    req.get("model_dir"),
                    req.get("model_name", "init_model"), state.device,
                    precision)
                with torch.inference_mode():
                    net(torch.zeros((1, 36, 64, 3), device=net.device))
            except Exception as e:
                self._reply(400, {"error": f"reload failed: "
                                           f"{type(e).__name__}: {e}"})
                return
            # Warm the serving-shape step too (still outside the lock:
            # in-flight requests keep running on the old model), so the
            # swap doesn't hand the next request a cold step.  Its
            # device execution is ONE serving-shape batch (~ms), so the
            # interference with an in-flight request's device queue is
            # negligible — holding the lock through the setup would
            # instead block every request behind it.
            # Defaults to the server's --no-warmup policy; {"warmup":
            # true/false} overrides.  A warmup failure must NOT discard
            # the already-validated model — the first request just pays
            # the setup instead.
            if req.get("warmup", state.warmup_default):
                try:
                    for mode in _warmup_modes(state):
                        logger.info("Reload warmup (%s) took %.1fs", mode,
                                    _warmup_net(net, transfer=mode))
                except Exception:
                    logger.exception(
                        "reload warmup failed; swapping anyway (first "
                        "request will set up the step)")
            slot = req.get("model", "default")
            with state.lock:
                if slot == "default":
                    state.net = net
                    state.precision = net.precision
                else:
                    state.nets[slot] = net
            logger.info("Reloaded model %r (dir=%s name=%s precision=%s)",
                        slot, req.get("model_dir"),
                        req.get("model_name", "init_model"), net.precision)
            self._reply(200, {"status": "reloaded", "model": slot,
                              "precision": net.precision,
                              "params": net.num_params()})

        def do_POST(self):
            if not self._authorized():
                return
            if self.path.split("?", 1)[0] == "/upload":
                self._do_upload()
                return
            if self.path == "/reload":
                self._do_reload()
                return
            if self.path not in ("/segment", "/segment_batch"):
                self._reply(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                if self.path == "/segment":
                    paths = [req["input_path"]]
                else:
                    paths = list(req["input_paths"])
                    if not paths:
                        raise ValueError("input_paths is empty")
                    if "output_path" in req:
                        raise ValueError(
                            "output_path is not valid for /segment_batch "
                            "(one path would overwrite per video); outputs "
                            "default to <input stem>_segments.csv")
            except (KeyError, ValueError, TypeError) as e:
                self._reply(400, {"error": f"bad request: {e}"})
                return

            def fail():
                with state.meta_lock:
                    state.requests_failed += 1

            if self.path == "/segment":
                try:
                    self._reply(200, self._segment_one(paths[0], req))
                except CapabilityError as e:
                    # 501: the server lacks the capability — distinct
                    # from a malformed request.
                    fail()
                    self._reply(501, {"error": str(e)})
                except ValueError as e:
                    fail()
                    self._reply(400, {"error": str(e)})
                except Exception as e:  # pragma: no cover - defensive
                    logger.exception("segment failed")
                    fail()
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                return

            # Batch pipelining: start video i+1's host decode before
            # video i runs, so its bounded prefetch queue fills while
            # video i holds the card — across a batch, e2e collapses
            # toward max(total decode, total device) instead of the sum.
            pres: dict = {}

            def start_pre(i: int) -> None:
                # Same slot accounting as _segment_one — a prefetch only
                # starts when one of the bounded slots is free, so batch
                # pipelining never stacks decode pipelines at saturation.
                # yuv420 requests can't consume BGR decode-ahead batches,
                # so don't start one (the request decodes to YUV itself).
                if _resolved_transfer(req, state) == "yuv420":
                    return
                if (0 <= i < len(paths) and isinstance(paths[i], str)):
                    handle = _try_prefetch(
                        state, paths[i],
                        batch_size=req.get("batch_size", 128),
                        decode_workers=req.get("decode_workers", 1))
                    if handle is not None:
                        pres[i] = handle

            results = []
            try:
                for i, p in enumerate(paths):
                    start_pre(i + 1)
                    try:
                        results.append(self._segment_one(
                            p, req, allow_output_path=False,
                            preloaded=pres.pop(i, None)))
                    except Exception as e:  # per-video isolation
                        if not isinstance(e, ValueError):
                            logger.exception("segment failed for %s", p)
                        fail()
                        results.append({"error": f"{type(e).__name__}: {e}"})
            finally:
                for pre in pres.values():  # leftovers on early exit
                    pre[1].close()
            self._reply(200, {"results": results})

    return Handler


def make_server(host: str, port: int, precision: str = "float32",
                model_dir: str | None = None,
                model_name: str = "init_model",
                spool_dir: str | None = None,
                max_upload_mb: int = 2048,
                spool_ttl_hours: float = 24.0,
                auth_token: str | None = None,
                extra_models: dict | None = None,
                certfile: str | None = None,
                keyfile: str | None = None,
                client_ca: str | None = None,
                decode_ahead: bool = True,
                warmup: bool = False,
                heartbeat_interval: float = 0.0,
                transfer: str = "bgr",
                device=None):
    """Build (server, state) with the model preloaded on ``device`` (the
    CUDA device by default: ``utils.device.resolve_device``).

    ``certfile``/``keyfile`` enable HTTPS; ``client_ca`` additionally
    demands client certificates signed by that CA (mTLS).  ``warmup``
    builds + runs the serving-shape classify step for every loaded
    model before the server is returned (the CLI enables it by default;
    off here so tests constructing many servers stay fast).
    ``heartbeat_interval`` > 0 starts the device-liveness probe feeding
    ``/healthz`` (the CLI defaults it to 60s; off here for tests).
    """
    if client_ca and not certfile:
        raise ValueError("--client-ca requires --certfile/--keyfile")
    if certfile:
        # Build (and so validate) the TLS context before the expensive
        # model load and the port bind.
        import ssl

        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(certfile, keyfile)
        if client_ca:
            ctx.load_verify_locations(client_ca)
            ctx.verify_mode = ssl.CERT_REQUIRED

    from cut_detection_tpu_torch.models.assembly import (
        load_triplet_or_default,
    )
    from cut_detection_tpu_torch.utils.device import resolve_device

    state = _State()
    state.device = (torch.device(device) if device is not None
                    else resolve_device())
    state.precision = precision
    state.spool_dir = spool_dir or tempfile.mkdtemp(prefix="cutdet_spool_")
    state.max_upload_bytes = max_upload_mb << 20
    state.spool_ttl_s = spool_ttl_hours * 3600.0
    state.auth_token = auth_token
    state.decode_ahead = decode_ahead
    if transfer not in ("auto", "bgr", "yuv420"):
        raise ValueError(f"unknown transfer {transfer!r}")
    if transfer == "auto":
        # Resolve ONCE at startup to a concrete server default (the
        # device/native-lib facts won't change while the daemon runs);
        # /metrics and request defaults then report the real mode.
        from cut_detection_tpu_torch.pipeline import resolve_transfer

        transfer = resolve_transfer("auto", device=state.device)
        logger.info("transfer=auto resolved to %s (server default)",
                    transfer)
    if transfer == "yuv420":
        # Fail at startup, not on the first request: a daemon whose
        # default mode can never work should refuse to boot.
        from cut_detection_tpu_torch.data import native_video

        if not native_video.yuv_available():
            raise ValueError(
                "--transfer yuv420 needs the native decoder with YUV "
                "entry points (make -C native)")
    state.transfer = transfer
    state.net, _ = load_triplet_or_default(model_dir, model_name,
                                           state.device, precision)
    for nm, (mdir, mname) in (extra_models or {}).items():
        state.nets[nm], _ = load_triplet_or_default(mdir, mname,
                                                    state.device, precision)
    state.warmup_default = warmup
    if heartbeat_interval > 0:
        state.heartbeat = _DeviceHeartbeat(interval=heartbeat_interval,
                                           device=state.device)
        state.heartbeat.start()
    server = ThreadingHTTPServer((host, port), _make_handler(state))
    if certfile:
        # do_handshake_on_connect=False defers the TLS handshake to the
        # first read, which happens in the per-request handler thread —
        # a slow or stalled client can't block the accept loop (the
        # handler's rfile timeout bounds stuck handshakes).
        server.socket = ctx.wrap_socket(server.socket, server_side=True,
                                        do_handshake_on_connect=False)
    if warmup:
        # AFTER the bind: a port conflict surfaces immediately, and
        # during the (cold: a kernel build) setup clients get a queued
        # TCP connect instead of connection-refused — so a restart
        # supervisor's health check doesn't kill the daemon in a loop.
        # Both transfer modes when available: a per-request override
        # must not pay the cold setup in-request.
        for nm, net in [("default", state.net)] + sorted(state.nets.items()):
            for mode in _warmup_modes(state):
                logger.info("Warming %r (%s): serving-shape step...",
                            nm, mode)
                logger.info("Warmed %r (%s) in %.1fs", nm, mode,
                            _warmup_net(net, transfer=mode))
    return server, state


def _parse_model_flags(entries) -> dict:
    """--model NAME=DIR[:MODEL_NAME] -> {name: (dir, model_name)}."""
    out = {}
    for e in entries or []:
        if "=" not in e:
            raise ValueError(f"--model expects NAME=DIR[:MODEL_NAME]: {e}")
        name, rest = e.split("=", 1)
        if name == "default":
            raise ValueError(
                "--model name 'default' is reserved (use --model-dir/"
                "--model-name for the default slot)")
        if name in out:
            raise ValueError(f"--model name {name!r} given twice")
        if ":" in rest:
            mdir, mname = rest.rsplit(":", 1)
        else:
            mdir, mname = rest, "init_model"
        out[name] = (mdir, mname)
    return out


def main(args=None) -> None:
    parser = build_parser()
    ns = parser.parse_args(args)
    if ns.data_parallel:
        parser.error("--data-parallel: not yet ported, see ROADMAP.md "
                     "Queue 1 item 5")
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

    server, _ = make_server(ns.host, ns.port, ns.precision,
                            model_dir=ns.model_dir, model_name=ns.model_name,
                            spool_dir=ns.spool_dir,
                            max_upload_mb=ns.max_upload_mb,
                            spool_ttl_hours=ns.spool_ttl_hours,
                            auth_token=ns.auth_token,
                            extra_models=_parse_model_flags(ns.model),
                            certfile=ns.certfile, keyfile=ns.keyfile,
                            client_ca=ns.client_ca,
                            decode_ahead=not ns.no_decode_ahead,
                            warmup=not ns.no_warmup,
                            heartbeat_interval=ns.heartbeat_interval,
                            transfer=ns.transfer, device=device)
    logging.info("Serving on %s:%d", ns.host, ns.port)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
