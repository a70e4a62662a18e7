"""The port's own copies of the JAX package's jax-free modules, each held
to its original on the same input.

The port imports nothing of ``cut_detection_tpu`` (``test_torch_imports``
checks that), so it keeps copies, under the same relative paths, of what
it calls: ``config`` (with ``TrainConfig`` and ``ContrastiveConfig``),
``checkpoint.io`` (the reader and the writer), ``checkpoint.convert``'s
``export_torch_state_dicts``, ``version``, ``geometry`` (held by
``tests/test_torch_preprocess.py``), ``utils.logging``,
``utils.profiling``, ``native``, ``data.video`` (with the yuv backend of
``ParallelVideoReader``), ``data.native_video`` (``NativeVideoSource``,
``NativeYUVSource``, ``yuv420_to_bgr24_host``), ``data.frames``,
``data.loader`` (``_collate``, ``iter_batches``, ``PrefetchLoader``),
``data.shm_loader`` (both transfers), ``cli.evaluate``,
``cli.split_video``, ``cli.labelling`` and
``ops.kernels.conv1_stages._strip_rows_for``.  The prod
classifier's files are read by path from the JAX package's directory.
"""

import dataclasses
import json
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
from cut_detection_tpu.checkpoint import convert as jax_convert
from cut_detection_tpu.checkpoint import io as jax_io
from cut_detection_tpu.cli import evaluate as jax_evaluate
from cut_detection_tpu.cli import labelling as jax_labelling
from cut_detection_tpu.cli import split_video as jax_split_video
from cut_detection_tpu.data import frames as jax_frames
from cut_detection_tpu.data import loader as jax_loader
from cut_detection_tpu.data import native_video as jax_native_video
from cut_detection_tpu.data import shm_loader as jax_shm
from cut_detection_tpu.data import video as jax_video
from cut_detection_tpu.utils import logging as jax_logging
from cut_detection_tpu.utils import profiling as jax_profiling
from cut_detection_tpu_torch import config, native
from cut_detection_tpu_torch.checkpoint import convert, io
from cut_detection_tpu_torch.cli import evaluate, labelling, split_video
from cut_detection_tpu_torch.data import (
    frames,
    loader,
    native_video,
    shm_loader,
    video,
)
from cut_detection_tpu_torch.models import assembly
from cut_detection_tpu_torch.utils import logging as port_logging
from cut_detection_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
CORPUS = os.path.join(REPO, "tests", "eval_corpus")
CLIPS = ["clip.mp4", "clip_odd.mp4"]
PROD_JSON = os.path.join(os.path.dirname(cut_detection_tpu.__file__),
                         "prod_net", "init_model_model_params.json")


def test_strip_rows_for_matches():
    """``ops.kernels.conv1_stages._strip_rows_for`` (the profiling
    kernel's strip height) against ``ops/pallas/fused_conv1.py``'s, at
    every pool-aligned height up to 300 and every cap up to 30, and on
    a height it cannot split."""
    from cut_detection_tpu.ops.pallas.fused_conv1 import (
        _strip_rows_for as theirs,
    )
    from cut_detection_tpu_torch.ops.kernels.conv1_stages import (
        _strip_rows_for as ours,
    )

    for h in range(3, 301, 3):
        for cap in range(3, 31):
            assert ours(h, cap) == theirs(h, cap), (h, cap)
    assert ours(144, cap=12) == 12
    for fn in (ours, theirs):
        with pytest.raises(ValueError, match="pool-aligned"):
            fn(7, 3)


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


@pytest.mark.parametrize("name", ["TrainConfig", "ContrastiveConfig"])
def test_train_configs_match(name):
    ours, theirs = getattr(config, name), getattr(jax_config, name)
    assert [(f.name, f.default) for f in dataclasses.fields(ours)] == \
        [(f.name, f.default) for f in dataclasses.fields(theirs)]
    cfg = config.ConvNetConfig(hidden_channels=48, average_pool_size=4)
    assert cfg.feature_size == jax_config.ConvNetConfig(
        hidden_channels=48, average_pool_size=4).feature_size == 768


def test_version_matches():
    """``cut_detection_tpu_torch.__version__`` is its own copy of the JAX
    package's (``version.py``), exported as ``cut_detection_tpu`` exports
    it."""
    import cut_detection_tpu_torch
    from cut_detection_tpu_torch import version

    assert cut_detection_tpu_torch.__version__ == version.__version__ \
        == cut_detection_tpu.__version__
    assert "__version__" in dir(cut_detection_tpu_torch)


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


def test_flatten_and_save_bundle_match(tmp_path):
    """``flatten_tree`` on a tree with every marker, and a bundle written
    by each package's ``save_bundle`` read by the other's
    ``load_bundle``."""
    tree = {"a": [np.arange(3), {}], "b": [], "c": {"d": np.ones((2, 2))},
            "e": (np.float32(2.5),)}
    ours, theirs = io.flatten_tree(tree), jax_io.flatten_tree(tree)
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])
    io.save_bundle(str(tmp_path / "ours.npz"), tree)
    jax_io.save_bundle(str(tmp_path / "theirs.npz"), tree)
    for path in ("ours.npz", "theirs.npz"):
        for reader in (io.load_bundle, jax_io.load_bundle):
            got = jax_io.flatten_tree(reader(str(tmp_path / path)))
            assert got.keys() == theirs.keys()
            for k in got:
                np.testing.assert_array_equal(got[k], theirs[k])


def test_export_torch_state_dicts_matches():
    """The prod bundle through each package's export: the same keys,
    dtypes and values; and the port's state dict back to the bundle
    (``bundle_from_state_dict``, the inverse of ``params_from_jax``)."""
    import torch

    prod = io.load_bundle(os.path.join(os.path.dirname(PROD_JSON),
                                       "init_model.npz"))
    for ours, theirs in zip(convert.export_torch_state_dicts(prod),
                            jax_convert.export_torch_state_dicts(prod)):
        assert list(ours) == list(theirs)
        for k in theirs:
            assert ours[k].dtype == theirs[k].dtype, k
            torch.testing.assert_close(ours[k], theirs[k], rtol=0, atol=0)
    back = convert.bundle_from_state_dict(convert.params_from_jax(prod))
    fo, fp = jax_io.flatten_tree(back), jax_io.flatten_tree(prod)
    assert fo.keys() == fp.keys()
    for k in fp:
        assert fo[k].dtype == fp[k].dtype, k
        np.testing.assert_array_equal(fo[k], fp[k])


def test_frame_datasets_match(tmp_path):
    """``SupervisedFrameDataset`` (labels from the CSV's range starts),
    ``ContrastiveFrameDataset`` (recursive, sorted, capped by ``size``)
    and ``ConcatDataset`` over the same JPEG tree."""
    import cv2

    rng = np.random.default_rng(0)
    sub = tmp_path / "sub"
    sub.mkdir()
    for i in range(7):
        d = sub if i % 2 else tmp_path
        cv2.imwrite(str(d / f"frame_{i:07d}.jpg"),
                    rng.integers(0, 256, (12, 20, 3), dtype=np.uint8))
    (tmp_path / "frames.csv").write_text("0,a22\n3,ez\n5,b\n")
    for size in (None, 4):
        pairs = [
            (frames.SupervisedFrameDataset(str(tmp_path), "frames.csv",
                                           size=size),
             jax_frames.SupervisedFrameDataset(str(tmp_path), "frames.csv",
                                               size=size)),
            (frames.ContrastiveFrameDataset(str(tmp_path), size=size),
             jax_frames.ContrastiveFrameDataset(str(tmp_path), size=size)),
        ]
        pairs.append((frames.ConcatDataset([pairs[0][0], pairs[1][0]]),
                      jax_frames.ConcatDataset([pairs[0][1], pairs[1][1]])))
        for ours, theirs in pairs:
            assert len(ours) == len(theirs)
            for i in range(len(theirs)):
                a, b = ours[i], theirs[i]
                assert a.keys() == b.keys()
                for k in b:
                    np.testing.assert_array_equal(a[k], b[k])
    labels = [frames.SupervisedFrameDataset(str(tmp_path), "frames.csv")[i]
              ["y"] for i in range(7)]
    assert labels == [0, 0, 0, 1, 1, 2, 2]
    with pytest.raises(ValueError):
        frames.ContrastiveFrameDataset(str(tmp_path), ext=".txt")


@pytest.mark.parametrize("shuffle,drop_last,workers",
                         [(False, False, 0), (True, False, 0),
                          (True, True, 2)])
def test_iter_batches_matches(shuffle, drop_last, workers):
    """Same seed, same split indices: the same batches, in the same
    order, through ``_collate`` (scalar items stacked as vectors)."""
    items = [{"x": np.full((2, 3), i, np.uint8), "y": np.int64(i % 3)}
             for i in range(23)]
    idx = np.random.default_rng(1).permutation(23)[:17]
    kw = dict(shuffle=shuffle, drop_last=drop_last, seed=5, indices=idx)
    ours = list(loader.iter_batches(items, 4, num_workers=workers, **kw))
    theirs = list(jax_loader.iter_batches(items, 4, **kw))
    assert len(ours) == len(theirs) == (4 if drop_last else 5)
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        for k in b:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


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


@pytest.fixture(scope="module")
def native_libs():
    """Both native libraries, built through the port's locked path
    (``native.load_built``) before any comparison runs.  Test workers
    that start together in a fresh checkout race to build them, and the
    JAX package's bindings build unlocked and cache a miss for the life
    of the process (``_lib is None and _tried``); where one did, that
    cache is cleared here, so that both packages' bindings load the same
    finished file.  No code of the JAX package changes."""
    native.available()
    native_video.available()
    for binding in (jax_native, jax_native_video):
        if binding._lib is None and binding._tried:
            binding._tried = False


def test_load_built_makes_only_a_missing_library(tmp_path, monkeypatch):
    """``native.load_built`` runs ``make`` only where the library is
    missing (a present one loads at once, in every decode child), tries a
    failed load or a failed ``make`` once more, and gives up at once when
    ``make`` succeeds without the file."""
    monkeypatch.setattr(native, "_RETRY_DELAY_S", 0.0)
    monkeypatch.setattr(native, "BUILD_LOCK", str(tmp_path / ".build.lock"))
    makes, loads = [], []
    fail_make = []

    def run(cmd, **kwargs):
        makes.append(cmd)
        if fail_make:
            raise subprocess.CalledProcessError(2, cmd)

    def cdll(path):
        loads.append(path)
        if len(loads) == 1:
            raise OSError("file too short")
        return "lib"

    monkeypatch.setattr(native.subprocess, "run", run)
    monkeypatch.setattr(native.ctypes, "CDLL", cdll)
    present = tmp_path / "present.so"
    present.write_bytes(b"\x7fELF")
    assert native.load_built(str(present)) == "lib"
    assert makes == [] and loads == [str(present)] * 2
    missing = str(tmp_path / "missing.so")
    assert native.load_built(missing) is None
    assert makes == [["make", "-C", native._NATIVE_DIR]]
    fail_make.append(True)
    assert native.load_built(missing) is None
    assert len(makes) == 3 and len(loads) == 2


def test_native_decoder_matches(native_libs):
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


def test_native_bgr_decode_of_unaligned_rows(native_libs):
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
def test_native_yuv_source_matches(clip, native_libs):
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


def test_yuv_parallel_reader_matches(native_libs):
    """``ParallelVideoReader(backend="yuv")`` (3 threads, 64-frame chunks)
    against the JAX package's, batched the same way."""
    if not (native_video.yuv_available()
            and jax_native_video.yuv_available()):
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


def test_native_library_matches(native_libs):
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


def test_shm_loader_matches(native_libs):
    """The decode subprocess's batches (copies, as on the CPU) equal the
    JAX package's, 64 frames at a time, and it reports the same video:
    BGR frames, and the yuv420 ring's packed planes (where the native YUV
    decoder is built)."""
    path = os.path.join(GOLDEN, "clip_odd.mp4")
    transfers = ["bgr"] + (["yuv420"] if native_video.yuv_available()
                           and jax_native_video.yuv_available() else [])
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


@pytest.fixture(scope="module")
def clip30(tmp_path_factory):
    """A seeded 30-frame 320x180 clip in three colour blocks."""
    import cv2

    path = str(tmp_path_factory.mktemp("clip30") / "clip30.mp4")
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30,
                         (320, 180))
    rng = np.random.default_rng(30)
    for colour in [(40, 120, 40)] * 12 + [(10, 10, 10)] * 6 \
            + [(150, 60, 60)] * 12:
        base = np.full((180, 320, 3), colour, np.uint8)
        wr.write(cv2.add(base, rng.integers(0, 30, (180, 320, 3),
                                            dtype=np.uint8)))
    wr.release()
    return path


def _tree_bytes(path) -> dict:
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("flags", [["--resize", "128"],
                                   ["--decode-workers", "2",
                                    "--max-frames", "25"]])
def test_split_video_matches(tmp_path, clip30, flags, capsys):
    """``split_video`` writes the JAX CLI's JPEG names and bytes, and
    prints its lines, sequentially and with two decode workers."""
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    split_video.main([clip30, str(ours), *flags])
    out_ours = capsys.readouterr().out
    jax_split_video.main([clip30, str(theirs), *flags])
    assert out_ours == capsys.readouterr().out
    got, want = _tree_bytes(ours), _tree_bytes(theirs)
    assert list(got) == [f"frame_{i:07}.jpg" for i in range(
        25 if "--max-frames" in flags else 30)]
    assert got == want


@pytest.fixture
def label_frames(tmp_path):
    import cv2

    rng = np.random.default_rng(0)
    for i in range(10):
        cv2.imwrite(str(tmp_path / f"frame_{i:07}.jpg"),
                    rng.integers(0, 256, (36, 64, 3), dtype=np.uint8))
    return str(tmp_path)


def test_labelling_terminal_app_matches(label_frames, monkeypatch, capsys):
    """``get_labels``, ``write_label`` and the terminal app (a seeded
    session of scripted keys) give the JAX module's ``labels.json`` and
    its output."""
    assert labelling.LABELS == jax_labelling.LABELS
    assert labelling.get_labels(label_frames) == {}
    keys = ["e", "s", "a", "b", "x", "e", "q"]
    results = []
    for mod in (labelling, jax_labelling):
        path = os.path.join(label_frames, "labels.json")
        if os.path.exists(path):
            os.remove(path)
        mod.write_label(label_frames, {}, 9, "B")
        script = iter(keys)
        monkeypatch.setattr("builtins.input", lambda: next(script))
        mod.main([label_frames, "--terminal", "--seed", "4"])
        with open(path, "rb") as f:
            results.append((f.read(), capsys.readouterr().out,
                            mod.get_labels(label_frames)))
    assert results[0] == results[1]
    assert len(results[0][2]) >= 3


def test_labelling_streamlit_app_matches(label_frames, monkeypatch):
    """The streamlit branch, through ``main`` without ``--terminal``, on
    ``tests/test_labelling_ui.py``'s scripted double with the frame draws
    pinned: the same ``labels.json`` and the same page as the JAX module's."""
    from test_labelling_ui import _ScriptedStreamlit

    draws = iter(range(100))
    fixed = type("Rng", (), {"integers": lambda self, n: next(draws) % n})()
    monkeypatch.setattr(np.random, "default_rng", lambda *a, **k: fixed)
    results = []
    for mod in (labelling, jax_labelling):
        path = os.path.join(label_frames, "labels.json")
        if os.path.exists(path):
            os.remove(path)
        draws = iter(range(100))
        st = _ScriptedStreamlit([None, "Endzone", "All-22", "Blank"])
        monkeypatch.setitem(sys.modules, "streamlit", st)
        for _ in range(4):
            st.next_run()
            mod.main([label_frames])
        with open(path, "rb") as f:
            results.append((f.read(), st.rendered))
    assert results[0] == results[1]
    assert json.loads(results[0][0]) == {"0": "EZ", "1": "A22", "2": "B"}
