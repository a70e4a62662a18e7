"""End-to-end inference pipeline of the port: decode -> classify -> segment
-> CSV.

Counterpart of ``cut_detection_tpu/pipeline.py`` (both transfers, at
every precision rung, the smoother on the host or on the device),
mirroring the reference's segment_video.py:20-77:

    decode (host thread or subprocess) -> uint8 NHWC BGR batches (or
    packed planar YUV420, ``transfer="yuv420"``) -> [device] YUV -> BGR
    kernel -> layer-1 kernel on raw pixels (preprocess folded into its
    weights) -> two more block kernels -> pool + FC head -> per-frame
    max / argmax -> one preallocated device score buffer -> one fetch ->
    run-length table -> orphan glue -> adjacent merge -> CSV (the last
    three on the net's device with ``device_glue``).

``transfer="auto"`` picks yuv420 on CUDA when the native YUV decoder is
built and no on-device preprocess is asked for (:func:`resolve_transfer`):
half the bytes to stack and upload.  The decoder resizes in YUV space
where the reference resizes BGR, so yuv420 is held by the accuracy
corpus; ``--transfer bgr`` is the byte-parity path.

With ``device_resize`` the frames decode at source resolution and the
resize moves onto the device: the bit-exact cv2 emulation
(``ops.resize``) ahead of the same folded net, or, with
``pallas_preprocess``, the fused resize + flip + /255 kernel
(``ops.kernels.resize_normalize``) ahead of an unfolded copy of the net,
whose layer 1 then runs the f32 block kernel on RGB in [0, 1].

Batches have one static shape (the last one is zero-padded; a valid
mask drops the padding), and every batch writes its (conf, pred) into a
device buffer sized from the video's frame count, so the loop keeps no
growing list of per-batch results.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import weakref

import numpy as np
import torch

from cut_detection_tpu_torch.data import native_video

# ``batch_frames`` is also this module's public name for the batching that
# ``classify_batches`` expects.
from cut_detection_tpu_torch.data.video import (
    ParallelVideoReader,
    VideoFrameSource,
    batch_frames,
)
from cut_detection_tpu_torch.geometry import reference_resize_dims
from cut_detection_tpu_torch.models.assembly import (
    GluedNet,
    fold_preprocess,
    folded_input,
    load_default_net,
    precompute_rings,
)
from cut_detection_tpu_torch.ops.kernels.resize_normalize import (
    resize_normalize,
)
from cut_detection_tpu_torch.ops.kernels.yuv420_to_bgr import yuv420_to_bgr
from cut_detection_tpu_torch.ops.preprocess import normalize_frames
from cut_detection_tpu_torch.ops.resize import resize_bilinear
from cut_detection_tpu_torch.segmentation.rle import Segmentation
from cut_detection_tpu_torch.utils.profiling import ThroughputMeter

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class PipelineStats:
    frames: int = 0
    batches: int = 0
    decode_failures: int = 0
    frames_per_sec: float = 0.0
    steady_frames_per_sec: float = 0.0


# Reference decode constants: resize width (segment_video.py:28), plus the
# chunk size of parallel decode and the depth of the in-process prefetch.
RESIZE = 256
DECODE_CHUNK_FRAMES = 256
PREFETCH_BATCHES = 2

# Steps memoized per (net, options), keyed weakly on the net so a dropped
# net frees its steps.
_STEP_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def make_classify_step(net: GluedNet, *,
                       device_resize: tuple[int, int] | None = None,
                       pallas_preprocess: bool = False,
                       yuv_dims: tuple[int, int] | None = None):
    """The device step: uint8 NHWC BGR ``[B, H, W, 3]`` on ``net.device``
    -> ``(conf f32 [B], pred int32 [B])`` on the same device.

    ``yuv_dims=(h, w)``: the frames are packed planar YUV420 vectors
    ``[B, yuv420_nbytes(h, w)]`` at model resolution, converted to BGR
    first (``ops.kernels.yuv420_to_bgr``, exact with swscale); it excludes
    ``device_resize`` and ``pallas_preprocess``.

    By default the frames are at model resolution, and the BGR flip and
    /255 are folded into layer 1's weights (``fold_preprocess``), so the
    layer-1 kernel reads the raw pixels.  ``device_resize=(out_h,
    out_w)`` resizes them first, bit-exact with cv2 (``ops.resize``).
    ``pallas_preprocess`` with ``device_resize`` runs the fused resize +
    flip + /255 kernel instead (float bilinear, not bit-exact with cv2)
    and feeds its f32 RGB to an unfolded net.  argmax ties go to the
    first index, like ``torch.max`` in the reference.

    The step runs at the net's precision.  Memoized per (net, options),
    as the JAX step is: nets of different precision, and the folded and
    the unfolded copies, are distinct nets.  Each copy's kernel arguments
    are computed once, here, not in every step (at ``int8_mxu``, at the
    first batch); at ``uint8_chain`` and ``int8_mxu`` its ring constants
    are computed once per input size, at the first batch of that size
    (``assembly.precompute_rings``; layer 1 has a ring of its own at
    ``int8_mxu`` where it reads raw pixels, not after the fused
    preprocess).  The step runs a
    private copy of the net's weights, so later changes to ``net`` do not
    reach it and rings from another net cannot: make a new step instead.
    """
    if yuv_dims is not None and (device_resize is not None
                                 or pallas_preprocess):
        raise ValueError("yuv_dims is mutually exclusive with "
                         "device_resize/pallas_preprocess")
    if device_resize is not None:
        device_resize = tuple(int(d) for d in device_resize)
    if yuv_dims is not None:
        yuv_dims = tuple(int(d) for d in yuv_dims)
    key = (device_resize, bool(pallas_preprocess), yuv_dims)
    per_net = _STEP_CACHE.get(net)
    if per_net is not None and key in per_net:
        return per_net[key]
    fold = not pallas_preprocess
    # The step must not hold a strong reference to its own weak key.
    frozen = GluedNet(net.model_params, net.precision)
    state = net.state_dict()
    frozen.load_state_dict(fold_preprocess(state) if fold else state)
    frozen.to(net.device)
    for layer in frozen.conv.conv_layers:
        layer.freeze()
    ring_cache: dict = {}

    @torch.inference_mode()
    def step(frames_u8: torch.Tensor):
        x = frames_u8
        if yuv_dims is not None:
            x = yuv420_to_bgr(x.contiguous(), *yuv_dims)
        if device_resize is not None and pallas_preprocess:
            x = resize_normalize(x.contiguous(), *device_resize)
        else:
            if device_resize is not None:
                x = resize_bilinear(x, *device_resize, exact=True)
            x = folded_input(x) if fold else normalize_frames(x)
        hw = tuple(x.shape[1:3])
        if hw not in ring_cache:
            ring_cache[hw] = precompute_rings(frozen, *hw, fold=fold)
        logits = frozen(x, ring_cache[hw])
        return logits.amax(dim=1), logits.argmax(dim=1).to(torch.int32)

    _STEP_CACHE.setdefault(net, {})[key] = step
    return step


def resolve_transfer(transfer: str = "auto", *,
                     device: torch.device | None = None,
                     on_device_preprocess: bool = False) -> str:
    """Resolve ``transfer`` ("auto"/"bgr"/"yuv420"), by the JAX package's
    rules (``cut_detection_tpu/pipeline.py:278``).

    "auto" is yuv420, the 1.5 B/px planar upload converted on the card,
    exactly when it can run and pays: the model runs on CUDA (on the CPU
    there is no upload to halve, and bgr keeps byte parity), the native
    decoder has its YUV entry points, and no on-device preprocess is
    asked for (that needs BGR frames at source resolution).  Everything
    else is bgr.  An explicit "yuv420" without the YUV decoder raises.
    The odd-target fallback to bgr is per video (:func:`classify_video`).
    """
    if transfer == "auto":
        if (on_device_preprocess or device is None
                or device.type != "cuda" or not native_video.yuv_available()):
            return "bgr"
        return "yuv420"
    if transfer == "yuv420" and not native_video.yuv_available():
        raise RuntimeError("transfer='yuv420' needs the native decoder with "
                           "YUV entry points (make -C native)")
    if transfer not in ("bgr", "yuv420"):
        raise ValueError(f"unknown transfer mode {transfer!r}")
    return transfer


def _resolve_decode_process(decode_process, device: torch.device) -> bool:
    """Resolve ``decode_process`` ("auto"/True/False): "auto" decodes in a
    subprocess exactly when the model runs on CUDA; on the CPU the
    in-process thread loader is cheaper than a spawn per video."""
    if decode_process == "auto":
        return device.type == "cuda"
    return bool(decode_process)


def available_decoder() -> str | None:
    """The video decoder this machine has: "cv2" when OpenCV imports, else
    "native" when the libav decoder of ``data.native_video`` is
    built, else None."""
    try:
        import cv2  # noqa: F401

        return "cv2"
    except ImportError:
        pass
    return "native" if native_video.available() else None


def _make_source(input_path: str, *, resize: int | None,
                 decode_workers: int, decoder: str, transfer: str = "bgr"):
    """The in-process decode source (cv2 or the native libav decoder);
    ``resize=None`` yields frames at source resolution.  ``yuv420``
    decodes to packed planes at the target size with the native YUV
    decoder, whatever ``decoder`` says."""
    if transfer == "yuv420":
        decoder = "yuv"
    elif decoder == "auto":
        decoder = "native" if native_video.available() else "cv2"
    if decode_workers > 1:
        return ParallelVideoReader(
            input_path, resize=resize, num_threads=decode_workers,
            chunk_frames=DECODE_CHUNK_FRAMES, backend=decoder)
    if decoder == "yuv":
        return native_video.NativeYUVSource(input_path, resize=resize)
    if decoder == "native":
        return native_video.NativeVideoSource(input_path, resize=resize)
    return VideoFrameSource(input_path, resize=resize)


def _video_info(input_path: str) -> dict:
    """The video's info dict: cv2's, as the JAX pipeline reads it, or the
    native decoder's where cv2 is missing."""
    from cut_detection_tpu_torch.data import video

    if video.cv2 is not None:
        cap, info = video.open_video(input_path)
        cap.release()
        return info
    src = native_video.NativeVideoSource(input_path)
    try:
        return src.video_info
    finally:
        src.close()


def _load_cached(cache_path: str, frame_limit, batch_size: int):
    """Scores from a cache written by a run of the same shape, else None.

    A frame-limited run writes a truncated table, and its early break
    keys the kept frame count on the batch size, so both must match;
    a cache without that metadata is never used.
    """
    with np.load(cache_path) as data:
        has_meta = "frame_limit" in data and "batch_size" in data
        cached_limit = int(data["frame_limit"]) if has_meta else None
        cached_batch = int(data["batch_size"]) if has_meta else None
        want_limit = -1 if frame_limit is None else int(frame_limit)
        if has_meta and cached_limit == want_limit and (
                want_limit == -1 or cached_batch == batch_size):
            logger.info("Loaded cached scores from %s", cache_path)
            return data["conf"], data["pred"]
    logger.info(
        "Ignoring score cache %s (%s: cached limit=%s batch=%s, requested "
        "limit=%s batch=%s)", cache_path,
        "frame_limit/batch mismatch" if has_meta
        else "no run-shape metadata", cached_limit, cached_batch,
        -1 if frame_limit is None else frame_limit, batch_size)
    return None


def classify_video(
    input_path: str,
    net: GluedNet | None = None,
    *,
    device=None,
    batch_size: int = 128,
    frame_limit: int | None = None,
    print_every: int = 50,
    decode_workers: int = 1,
    cache_path: str | None = None,
    decoder: str = "cv2",
    decode_process: bool | str = "auto",
    transfer: str = "auto",
    device_resize: bool = False,
    pallas_preprocess: bool = False,
    precision: str = "float32",
) -> tuple[np.ndarray, np.ndarray, PipelineStats]:
    """Decode + classify; return per-frame ``(conf, pred, stats)``.

    The model runs on ``net.device`` at ``net.precision``, or on
    ``device`` at ``precision`` when the default net is loaded here; one
    of ``net`` and ``device`` is required.  Defaults mirror
    segment_video.py: width 256, batch 128, a log line every 50 batches,
    and the ``frame_limit`` break *after* the batch that crosses the
    limit (:53-58).

    With ``device_resize`` or ``pallas_preprocess`` the frames decode at
    source resolution and are resized on the device to the reference's
    size (width 256); see :func:`make_classify_step`.

    ``transfer`` ("auto", "bgr" or "yuv420", :func:`resolve_transfer`):
    under yuv420 the native decoder scales each frame to the target size
    in YUV space and the packed planes (1.5 B/px) cross to the device,
    which converts them to BGR exactly as swscale does.  An odd target
    size falls back to bgr with a warning (swscale interpolates the
    chroma there, which the conversion does not reproduce).
    """
    if cache_path and os.path.isfile(cache_path):
        cached = _load_cached(cache_path, frame_limit, batch_size)
        if cached is not None:
            return cached[0], cached[1], PipelineStats(
                frames=int(cached[0].shape[0]))

    if net is None:
        if device is None:
            raise ValueError("classify_video needs a net or a device")
        net, _ = load_default_net(device, precision)
        logger.info("Loaded default classifier (%s).", precision)
    device = net.device

    on_device_preprocess = device_resize or pallas_preprocess
    if transfer == "yuv420" and on_device_preprocess:
        raise ValueError(
            "transfer='yuv420' can't combine with on-device resize "
            "(YUV frames arrive at model resolution already)")
    asked = transfer
    transfer = resolve_transfer(transfer, device=device,
                                on_device_preprocess=on_device_preprocess)
    if asked == "auto":
        logger.info("transfer=auto resolved to %s", transfer)
    yuv_dims = None
    if transfer == "yuv420":
        info = _video_info(input_path)
        tw, th = reference_resize_dims(info["width"], info["height"], RESIZE)
        if th % 2 or tw % 2:
            logger.warning(
                "transfer='yuv420' needs even target dims; %dx%d is odd — "
                "falling back to the BGR transfer", th, tw)
            transfer = "bgr"
        else:
            yuv_dims = (th, tw)

    resize = None if on_device_preprocess else RESIZE
    if _resolve_decode_process(decode_process, device):
        from cut_detection_tpu_torch.data.shm_loader import ShmDecodeLoader

        # On the CPU, torch.from_numpy would alias a ring slot that the
        # decoder recycles, so take copies.  On CUDA the synchronous
        # host->device copy has left the slot when it returns.
        source = ShmDecodeLoader(
            input_path, batch_size=batch_size, resize=resize,
            decode_workers=decode_workers,
            decode_chunk_frames=DECODE_CHUNK_FRAMES, decoder=decoder,
            copy_out=device.type == "cpu", transfer=transfer)
        batches = source
    else:
        from cut_detection_tpu_torch.data.loader import PrefetchLoader

        source = _make_source(input_path, resize=resize,
                              decode_workers=decode_workers, decoder=decoder,
                              transfer=transfer)
        batches = PrefetchLoader(batch_frames(source, batch_size),
                                 depth=PREFETCH_BATCHES)

    dr = None
    if on_device_preprocess:
        new_w, new_h = reference_resize_dims(source.video_info["width"],
                                             source.video_info["height"],
                                             RESIZE)
        dr = (new_h, new_w)
    conf_np, pred_np, stats = classify_batches(
        batches, net, batch_size=batch_size,
        length=int(source.video_info["length"]), frame_limit=frame_limit,
        print_every=print_every, device_resize=dr,
        pallas_preprocess=pallas_preprocess, yuv_dims=yuv_dims)
    stats.decode_failures = getattr(source, "frames_failed", 0)

    if cache_path:
        # Atomic write: a kill mid-save must leave no half-written cache.
        tmp = cache_path + ".tmp.npz"
        np.savez(tmp, conf=conf_np, pred=pred_np,
                 frame_limit=np.int64(-1 if frame_limit is None
                                      else frame_limit),
                 batch_size=np.int64(batch_size))
        os.replace(tmp, cache_path)
        logger.info("Cached scores to %s", cache_path)
    return conf_np, pred_np, stats


def classify_batches(batches, net: GluedNet, *, batch_size: int = 128,
                     length: int = 0, frame_limit: int | None = None,
                     print_every: int = 50,
                     device_resize: tuple[int, int] | None = None,
                     pallas_preprocess: bool = False,
                     yuv_dims: tuple[int, int] | None = None,
                     ) -> tuple[np.ndarray, np.ndarray, PipelineStats]:
    """The device loop of :func:`classify_video` over decoded batches.

    ``batches`` yields ``(uint8 [batch_size, H, W, 3] BGR, valid)`` as
    ``data.video.batch_frames`` does (``[batch_size, yuv420_nbytes(h,
    w)]`` planes with ``yuv_dims=(h, w)``); ``length`` (the expected
    frame count) sizes the device score buffer.  The batches' ``close()``,
    when they have one, runs on exit.  ``device_resize``,
    ``pallas_preprocess`` and ``yuv_dims`` choose the step
    (:func:`make_classify_step`), which runs at ``net.precision``.
    Returns the valid frames' ``(conf, pred, stats)``.
    """
    device = net.device
    meter = ThroughputMeter(warmup_items=batch_size)
    meter.start()
    valids: list[int] = []
    stats = PipelineStats()
    try:
        step = make_classify_step(net, device_resize=device_resize,
                                  pallas_preprocess=pallas_preprocess,
                                  yuv_dims=yuv_dims)
        # One score buffer on the device, sized from the expected frame
        # count (doubled whenever a container under-reports it).
        n_batches = max(1, -(-length // batch_size))
        if frame_limit is not None:
            n_batches = min(n_batches, frame_limit // batch_size + 1)
        conf_buf = torch.empty(n_batches * batch_size, dtype=torch.float32,
                               device=device)
        pred_buf = torch.empty(n_batches * batch_size, dtype=torch.int32,
                               device=device)
        for i, (batch, valid) in enumerate(batches):
            lo, hi = i * batch_size, (i + 1) * batch_size
            if hi > conf_buf.shape[0]:
                conf_buf = torch.cat([conf_buf, torch.empty_like(conf_buf)])
                pred_buf = torch.cat([pred_buf, torch.empty_like(pred_buf)])
            conf, pred = step(torch.from_numpy(batch).to(device))
            conf_buf[lo:hi] = conf
            pred_buf[lo:hi] = pred
            valids.append(valid)
            meter.update(valid)
            stats.batches += 1
            stats.frames += valid
            if print_every > 0 and i % print_every == print_every - 1:
                logger.info("Scored batch %d (%d frames).", i + 1, hi)
            # Reference early-break semantics (segment_video.py:53-58).
            if frame_limit is not None and hi > frame_limit:
                break
        # One fetch of both vectors; the valid mask drops the padding.
        n = len(valids) * batch_size
        conf_all = conf_buf[:n].cpu().numpy()
        pred_all = pred_buf[:n].cpu().numpy()
    finally:
        if hasattr(batches, "close"):  # PrefetchLoader / ShmDecodeLoader
            batches.close()
    mask = np.zeros((len(valids), batch_size), bool)
    for i, v in enumerate(valids):
        mask[i, :v] = True
    stats.frames_per_sec = meter.rate
    stats.steady_frames_per_sec = meter.steady_rate
    logger.info("Classified %d frames at %.1f fps (steady %.1f fps).",
                stats.frames, stats.frames_per_sec,
                stats.steady_frames_per_sec)
    return (conf_all[mask.ravel()],
            pred_all[mask.ravel()].astype(np.int32), stats)


def _smooth(conf, pred, base_threshold: int, blank_threshold: int, *,
            device: torch.device | None = None) -> Segmentation:
    """Per-frame scores -> smoothed segment table: the host merge loops,
    or with ``device`` the whole smoother on that device
    (``segmentation.device_glue``), which gives the same table."""
    if device is not None:
        from cut_detection_tpu_torch.segmentation.device_glue import (
            device_smooth,
        )

        # The bound comes from a one-pass boundary count, rounded up to a
        # power of two >= 4096 as the JAX pipeline rounds it, so it can
        # never be exceeded.
        pred = np.asarray(pred)
        n_seg = (1 + int(np.count_nonzero(pred[1:] != pred[:-1]))
                 if pred.size else 0)
        logger.info("Found %d initial segments", n_seg)
        max_segments = max(4096, 1 << max(n_seg - 1, 0).bit_length())
        start, typ, active, _, mean, end = device_smooth(
            torch.as_tensor(np.asarray(conf, np.float32), device=device),
            torch.as_tensor(pred.astype(np.int32), device=device),
            base_threshold, blank_threshold, max_segments=max_segments)
        act = active.cpu().numpy()
        starts = start.cpu().numpy()[act].astype(np.int64)
        ends = end.cpu().numpy()[act].astype(np.int64)
        seg = Segmentation(_te={
            "start_frames": starts,
            "frame_types": typ.cpu().numpy()[act].astype(np.int64),
            "end_frames": ends,
            "run_lengths": ends - starts + 1,
            # Post-merge means (bug-compat inflated, as the host table's).
            "score_means": mean.cpu().numpy()[act].astype(np.float32),
        })
        logger.info("Device smoother: %d segments.", len(seg))
        return seg
    seg = Segmentation.from_frame_scores(conf, pred)
    logger.info("Found %d initial segments", len(seg))
    seg.glue_orphans(base_threshold, blank_threshold)
    logger.info("Revised to %d segments through orphan combination.",
                len(seg))
    seg.combine_adjacent_segments()
    logger.info(
        "Revised to %d segments through matching adjacent combination.",
        len(seg))
    return seg


def segment_video_file(
    input_path: str,
    output_path: str | None = None,
    *,
    device=None,
    net: GluedNet | None = None,
    base_threshold: int = 100,
    blank_threshold: int = 10,
    batch_size: int = 128,
    frame_limit: int | None = None,
    print_every: int = 50,
    decode_workers: int = 1,
    cache_path: str | None = None,
    decoder: str = "cv2",
    decode_process: bool | str = "auto",
    transfer: str = "auto",
    device_resize: bool = False,
    pallas_preprocess: bool = False,
    precision: str = "float32",
    device_glue: bool = False,
) -> tuple[str, Segmentation, PipelineStats]:
    """Full pipeline to CSV; returns ``(csv_path, segmentation, stats)``.

    Default output naming (input stem + ``_segments.csv``) and glue
    thresholds follow segment_video.py:71-74, 91-102.  ``precision``
    applies when the default net is loaded here (see
    :func:`classify_video`).  ``device_glue`` runs the smoother on the
    net's device (``segmentation.device_glue``), with the same result as
    the host loops.
    """
    if not os.path.isfile(input_path):
        raise ValueError(f"{input_path} does not exist.")
    conf, pred, stats = classify_video(
        input_path, net, device=device, batch_size=batch_size,
        frame_limit=frame_limit, print_every=print_every,
        decode_workers=decode_workers, cache_path=cache_path,
        decoder=decoder, decode_process=decode_process, transfer=transfer,
        device_resize=device_resize, pallas_preprocess=pallas_preprocess,
        precision=precision)
    glue_device = None
    if device_glue:
        glue_device = net.device if net is not None else torch.device(device)
    seg = _smooth(conf, pred, base_threshold, blank_threshold,
                  device=glue_device)
    if output_path is None:
        output_path = os.path.splitext(input_path)[0] + "_segments.csv"
    logger.info("Writing %d segments to %s", len(seg), output_path)
    seg.write_csv(output_path)
    return output_path, seg, stats
