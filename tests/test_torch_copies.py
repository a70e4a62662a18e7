"""The port's own copies of the JAX package's jax-free modules, each held
to its original on the same input.

The port imports nothing of ``cut_detection_tpu`` (``test_torch_imports``
checks that), so it keeps copies, under the same relative paths, of what
it calls: ``config``, ``checkpoint.io``, ``geometry`` (held by
``tests/test_torch_preprocess.py``), ``utils.logging``,
``utils.profiling``, ``native``, ``data.video`` (with the yuv backend of
``ParallelVideoReader``), ``data.native_video`` (``NativeVideoSource``,
``NativeYUVSource``, ``yuv420_to_bgr24_host``), ``data.loader``,
``data.shm_loader`` (both transfers) and ``cli.evaluate``.  The prod
classifier's files are read by path from the JAX package's directory.
"""

import logging
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import cut_detection_tpu
from cut_detection_tpu import config as jax_config
from cut_detection_tpu import native as jax_native
from cut_detection_tpu.checkpoint import io as jax_io
from cut_detection_tpu.cli import evaluate as jax_evaluate
from cut_detection_tpu.data import loader as jax_loader
from cut_detection_tpu.data import native_video as jax_native_video
from cut_detection_tpu.data import shm_loader as jax_shm
from cut_detection_tpu.data import video as jax_video
from cut_detection_tpu.utils import logging as jax_logging
from cut_detection_tpu.utils import profiling as jax_profiling
from cut_detection_tpu_torch import config, native
from cut_detection_tpu_torch.checkpoint import io
from cut_detection_tpu_torch.cli import evaluate
from cut_detection_tpu_torch.data import loader, native_video, shm_loader, video
from cut_detection_tpu_torch.models import assembly
from cut_detection_tpu_torch.utils import logging as port_logging
from cut_detection_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
CORPUS = os.path.join(REPO, "tests", "eval_corpus")
CLIPS = ["clip.mp4", "clip_odd.mp4"]
PROD_JSON = os.path.join(os.path.dirname(cut_detection_tpu.__file__),
                         "prod_net", "init_model_model_params.json")


def test_config_matches():
    assert config.PRECISION_CHOICES == jax_config.PRECISION_CHOICES
    ours = config.ModelParams.from_json(PROD_JSON)
    theirs = jax_config.ModelParams.from_json(PROD_JSON)
    assert ours.to_dict() == theirs.to_dict()
    for method in ("conv_config", "linear_config"):
        a, b = getattr(ours, method)(), getattr(theirs, method)()
        assert vars(a) == vars(b)
    assert ours.linear_config().layer_sizes() == \
        theirs.linear_config().layer_sizes()


def test_prod_net_is_read_in_place():
    """The port reads the prod classifier from the JAX package's
    directory by path, not from a copy of its own."""
    assert os.path.samefile(assembly._PROD_NET_DIR,
                            os.path.dirname(PROD_JSON))


def test_load_bundle_matches(tmp_path):
    """The prod bundle, and a tree with the empty-dict and empty-list
    markers written by the JAX package's ``save_bundle``."""
    prod = os.path.join(os.path.dirname(PROD_JSON), "init_model.npz")
    tree = {"a": [np.arange(3), {}], "b": [], "c": {"d": np.ones((2, 2))}}
    path = str(tmp_path / "t.npz")
    jax_io.save_bundle(path, tree)
    for p in (prod, path):
        ours, theirs = io.load_bundle(p), jax_io.load_bundle(p)
        fo, ft = jax_io.flatten_tree(ours), jax_io.flatten_tree(theirs)
        assert fo.keys() == ft.keys()
        for k in fo:
            np.testing.assert_array_equal(fo[k], ft[k])
    assert io.load_bundle(path)["b"] == []
    assert io.load_bundle(path)["a"][1] == {}


def test_logging_and_meter_match():
    assert port_logging.LOG_FORMAT == jax_logging.LOG_FORMAT
    ours = profiling.ThroughputMeter(warmup_items=5)
    theirs = jax_profiling.ThroughputMeter(warmup_items=5)
    for n in (2, 3, 4):
        ours.update(n)
        theirs.update(n)
    for m in (ours, theirs):
        assert m.total_items == 9 and m._steady_items == 5
        assert m.rate > 0 and m.steady_rate >= 0
    logging.getLogger(__name__).debug("setup_logging: %s",
                                      port_logging.setup_logging)


@pytest.mark.parametrize("clip", CLIPS)
@pytest.mark.parametrize("resize", [256, None])
def test_decoded_frames_match(clip, resize):
    """The sequential source and the chunk-parallel reader (3 threads,
    64-frame chunks, boundary checks on) give the JAX package's frames
    byte for byte, batched the same way."""
    path = os.path.join(GOLDEN, clip)
    sources = [
        (video.VideoFrameSource(path, resize=resize),
         jax_video.VideoFrameSource(path, resize=resize)),
        (video.ParallelVideoReader(path, resize=resize, num_threads=3,
                                   chunk_frames=64),
         jax_video.ParallelVideoReader(path, resize=resize, num_threads=3,
                                       chunk_frames=64)),
    ]
    for ours, theirs in sources:
        assert ours.video_info == theirs.video_info
        a = list(video.batch_frames(ours, 64))
        b = list(jax_video.batch_frames(theirs, 64))
        assert len(a) == len(b) > 0
        for (xa, va), (xb, vb) in zip(a, b):
            assert va == vb
            np.testing.assert_array_equal(xa, xb)
        assert ours.frames_failed == theirs.frames_failed == 0


def test_native_decoder_matches():
    """The native libav decoder through the port's bindings, sequential
    and after a seek, against the JAX package's.  On ``clip.mp4`` only:
    the JAX package's binding hands the library a buffer exactly as long
    as a BGR frame, which swscale overruns on ``clip_odd.mp4``'s
    426-pixel-wide rows (heap corruption, then an abort).  The port's
    binding pads its buffers (``test_native_bgr_decode_of_unaligned_rows``)."""
    if not (native_video.available() and jax_native_video.available()):
        pytest.skip("native decoder not built")
    path = os.path.join(GOLDEN, "clip.mp4")
    ours = native_video.NativeVideoSource(path, resize=256)
    theirs = jax_native_video.NativeVideoSource(path, resize=256)
    assert ours.video_info == theirs.video_info
    np.testing.assert_array_equal(np.stack(list(ours)),
                                  np.stack(list(theirs)))
    ours = native_video.NativeVideoSource(path)
    theirs = jax_native_video.NativeVideoSource(path)
    ours.seek(37)
    theirs.seek(37)
    np.testing.assert_array_equal(next(ours), next(theirs))
    ours.close()
    theirs.close()


def test_native_bgr_decode_of_unaligned_rows():
    """``clip_odd.mp4`` (426x240: BGR rows of 1278 bytes) through the
    port's ``NativeVideoSource``, in a subprocess because an overrun
    aborts the interpreter: at ``resize=None`` and ``resize=256`` its 200
    frames, and the frames from a seek to 37 on, equal cv2's
    (``VideoFrameSource``) byte for byte, and the process exits 0."""
    if not native_video.available():
        pytest.skip("native decoder not built")
    clip = os.path.join(GOLDEN, "clip_odd.mp4")
    code = textwrap.dedent(f"""
        import numpy as np
        from cut_detection_tpu_torch.data.native_video import (
            NativeVideoSource)
        from cut_detection_tpu_torch.data.video import VideoFrameSource
        for resize in (None, 256):
            ours = np.stack(list(NativeVideoSource({clip!r}, resize)))
            cv = np.stack(list(VideoFrameSource({clip!r}, resize)))
            assert ours.shape[0] == cv.shape[0] == 200, ours.shape
            assert np.array_equal(ours, cv), resize
            src = NativeVideoSource({clip!r}, resize)
            src.seek(37)
            assert np.array_equal(np.stack(list(src)), cv[37:]), resize
            assert src.frames_failed == 0
            print("ok", resize, flush=True)
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split() == ["ok", "None", "ok", "256"]


@pytest.mark.parametrize("clip", CLIPS)
def test_native_yuv_source_matches(clip):
    """``NativeYUVSource`` through the port's binding, sequential and
    after a seek, against the JAX package's: the same vectors byte for
    byte (the YUV entries decode ``clip_odd.mp4`` through either)."""
    if not (native_video.yuv_available()
            and jax_native_video.yuv_available()):
        pytest.skip("native decoder with YUV entry points not built")
    path = os.path.join(GOLDEN, clip)
    ours = native_video.NativeYUVSource(path, resize=256)
    theirs = jax_native_video.NativeYUVSource(path, resize=256)
    assert ours.video_info == theirs.video_info
    assert (ours.out_width, ours.out_height, ours.frame_nbytes) == (
        theirs.out_width, theirs.out_height, theirs.frame_nbytes)
    a, b = np.stack(list(ours)), np.stack(list(theirs))
    assert a.shape[0] == ours.video_info["length"]
    np.testing.assert_array_equal(a, b)
    assert ours.frames_failed == theirs.frames_failed == 0
    ours = native_video.NativeYUVSource(path, resize=None)
    theirs = jax_native_video.NativeYUVSource(path, resize=None)
    ours.seek(37)
    theirs.seek(37)
    np.testing.assert_array_equal(next(ours), next(theirs))
    ours.close()
    theirs.close()


def test_yuv_parallel_reader_matches():
    """``ParallelVideoReader(backend="yuv")`` (3 threads, 64-frame chunks)
    against the JAX package's, batched the same way."""
    if not native_video.yuv_available():
        pytest.skip("native decoder with YUV entry points not built")
    path = os.path.join(GOLDEN, "clip.mp4")
    ours = video.ParallelVideoReader(path, resize=256, num_threads=3,
                                     chunk_frames=64, backend="yuv")
    theirs = jax_video.ParallelVideoReader(path, resize=256, num_threads=3,
                                           chunk_frames=64, backend="yuv")
    assert ours.video_info == theirs.video_info
    assert ours.frame_nbytes == theirs.frame_nbytes
    a = list(video.batch_frames(ours, 64))
    b = list(jax_video.batch_frames(theirs, 64))
    assert len(a) == len(b) == 4
    for (xa, va), (xb, vb) in zip(a, b):
        assert va == vb
        np.testing.assert_array_equal(xa, xb)
    assert ours.frames_failed == theirs.frames_failed == 0


def test_native_library_matches():
    """The merge loops and the resize of the native host library, through
    both packages' bindings, on seeded tables and images."""
    if not (native.available() and jax_native.available()):
        pytest.skip("native library not built")
    rng = np.random.default_rng(4)
    pred = np.repeat(rng.integers(0, 3, 60), rng.integers(1, 40, 60))
    conf = rng.random(pred.size).astype(np.float32)
    from cut_detection_tpu_torch.segmentation.rle import Segmentation

    te = Segmentation.from_frame_scores(conf, pred).te
    for ours, theirs in (
            (native.glue_orphans(te, 20, 5), jax_native.glue_orphans(
                te, 20, 5)),
            (native.combine_adjacent(te), jax_native.combine_adjacent(te))):
        assert ours.keys() == theirs.keys()
        for k in ours:
            np.testing.assert_array_equal(ours[k], theirs[k])
    img = rng.integers(0, 256, (240, 427, 3), dtype=np.uint8)
    np.testing.assert_array_equal(native.resize_bilinear_u8(img, 143, 256),
                                  jax_native.resize_bilinear_u8(img, 143, 256))
    with pytest.raises(ValueError):
        native.resize_bilinear_u8(img, 0, 256)


def test_prefetch_loader_matches():
    items = [np.full((2, 2), i) for i in range(7)]
    ours = list(loader.PrefetchLoader(iter(items), depth=2))
    theirs = list(jax_loader.PrefetchLoader(iter(items), depth=2))
    assert len(ours) == len(theirs) == 7
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)

    def boom():
        yield 1
        raise KeyError("decode failed")

    with pytest.raises(KeyError):
        list(loader.PrefetchLoader(boom()))
    used = loader.PrefetchLoader(iter(items))
    list(used)
    with pytest.raises(RuntimeError, match="single-use"):
        iter(used)
    with pytest.raises(ValueError):
        loader.PrefetchLoader(iter(items), depth=0)


def test_shm_loader_matches():
    """The decode subprocess's batches (copies, as on the CPU) equal the
    JAX package's, 64 frames at a time, and it reports the same video:
    BGR frames, and the yuv420 ring's packed planes (where the native YUV
    decoder is built)."""
    path = os.path.join(GOLDEN, "clip_odd.mp4")
    transfers = ["bgr"] + (["yuv420"] if native_video.yuv_available()
                           else [])
    for transfer in transfers:
        ours = shm_loader.ShmDecodeLoader(path, batch_size=64, copy_out=True,
                                          transfer=transfer)
        a = list(ours)
        theirs = jax_shm.ShmDecodeLoader(path, batch_size=64, copy_out=True,
                                         transfer=transfer)
        b = list(theirs)
        assert ours.video_info == theirs.video_info
        assert ours.frame_hw == theirs.frame_hw == (144, 256)
        assert len(a) == len(b) == 4
        assert a[0][0].shape == ((64, 144, 256, 3) if transfer == "bgr"
                                 else (64, 144 * 256 * 3 // 2)), transfer
        for (xa, va), (xb, vb) in zip(a, b):
            assert va == vb
            np.testing.assert_array_equal(xa, xb)
        assert ours.frames_failed == theirs.frames_failed == 0
    with pytest.raises(ValueError, match="unknown transfer"):
        shm_loader.ShmDecodeLoader(path, transfer="rgb")


@pytest.mark.parametrize("name", ["corpus_a", "corpus_adv", "corpus_nat"])
def test_evaluate_matches(tmp_path, name):
    """``evaluate`` on the corpus truth files against the golden CSVs and
    against each other, with and without a frame count."""
    truth = os.path.join(CORPUS, f"{name}_truth.csv")
    other = os.path.join(CORPUS, "corpus_b_truth.csv")
    for pred in (truth, other, os.path.join(GOLDEN, "ref_segments.csv")):
        for n in (590, None):
            assert evaluate.evaluate(pred, truth, n, tolerance=30) == \
                jax_evaluate.evaluate(pred, truth, n, tolerance=30)
    bad = tmp_path / "bad.csv"
    bad.write_text("0,xyz\n")
    with pytest.raises(SystemExit):
        evaluate.evaluate(str(bad), truth, 10)
    assert evaluate.main([truth, truth, "--num-frames", "590"]) == \
        jax_evaluate.main([truth, truth, "--num-frames", "590"])
