"""The port's ``yuv420`` transfer on the CPU, against the JAX package and
live swscale.

The conversion (``ops.yuv.yuv420_to_bgr``, the plain version of the
``yuv420_to_bgr`` kernel, which is what a CPU tensor runs) is integer
arithmetic, so every comparison of it is exact: against the JAX op and
its numpy twin, against swscale's own converter through the port's
binding of the native decoder (``yuv420_to_bgr24_host``) on random
images and on the exhaustive probe of all 2^24 (Y, U, V) combinations.
The step on a YUV batch must give exactly what the same step gives on
that batch converted on the host, at every rung, and stay within the
rung's bar of the JAX step with ``yuv_dims`` (float32 1e-4,
``bfloat16_full`` 1e-2, as ``test_torch_precision.py`` holds the BGR
steps).  Tests that need the native decoder's YUV entry points skip
where it is not built; they decide that when they run.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cut_detection_tpu import geometry as jax_geometry
from cut_detection_tpu.models.assembly import load_default_net as jax_default
from cut_detection_tpu.ops import yuv as jax_yuv
from cut_detection_tpu.pipeline import make_classify_step as jax_make_step
from cut_detection_tpu_torch.data import native_video
from cut_detection_tpu_torch.data.video import ParallelVideoReader
from cut_detection_tpu_torch.geometry import yuv420_nbytes
from cut_detection_tpu_torch.models.assembly import load_default_net
from cut_detection_tpu_torch.ops import yuv
from cut_detection_tpu_torch.ops.kernels.yuv420_to_bgr import yuv420_to_bgr
from cut_detection_tpu_torch.pipeline import (
    batch_frames,
    classify_video,
    make_classify_step,
    segment_video_file,
)
# Builds both native libraries through the port's locked path and clears
# a JAX binding's cached miss (see its docstring).
from test_torch_copies import native_libs  # noqa: F401 (a fixture)

T = torch.from_numpy
# tests/test_yuv.py's shapes.
SHAPES = [(144, 256), (36, 64), (90, 160), (192, 256), (146, 254)]
PRECISIONS = ["float32", "bfloat16", "bfloat16_full", "uint8_pool",
              "uint8_chain"]


def _needs_yuv_decoder():
    if not native_video.yuv_available():
        pytest.skip("native decoder with YUV entry points not built")


def _random_planes(rng, h, w):
    cw, ch = (w + 1) // 2, (h + 1) // 2
    return (rng.integers(0, 256, (h, w), dtype=np.uint8),
            rng.integers(0, 256, (ch, cw), dtype=np.uint8),
            rng.integers(0, 256, (ch, cw), dtype=np.uint8))


def _yuv_batch(seed, n, h=144, w=256):
    rng = np.random.default_rng(seed)
    return np.stack([yuv.pack_yuv420(*_random_planes(rng, h, w))
                     for _ in range(n)])


def test_constants_and_layout_match_jax():
    for name in ("LY_COEF", "LY_ROUND", "BU_COEF", "GU_COEF", "GV_COEF",
                 "RV_COEF"):
        assert getattr(yuv, name) == getattr(jax_yuv, name), name
    for h, w in SHAPES + [(143, 256), (1, 1)]:
        assert yuv420_nbytes(h, w) == jax_geometry.yuv420_nbytes(h, w)
    planes = _random_planes(np.random.default_rng(0), 6, 10)
    np.testing.assert_array_equal(yuv.pack_yuv420(*planes),
                                  jax_yuv.pack_yuv420(*planes))


@pytest.mark.parametrize("h,w", SHAPES)
def test_plain_op_matches_jax(h, w):
    """The plain version, its numpy twin and the wrapper on a CPU tensor
    against the JAX op and the JAX numpy twin on a seeded batch of 3:
    max diff 0."""
    batch = _yuv_batch(h * 1000 + w, 3, h, w)
    want = np.asarray(jax_yuv.yuv420_to_bgr(jnp.asarray(batch), h, w))
    np.testing.assert_array_equal(want, jax_yuv.yuv420_to_bgr_np(batch, h, w))
    got = yuv.yuv420_to_bgr(T(batch), h, w)
    assert got.dtype == torch.uint8 and got.shape == (3, h, w, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(yuv.yuv420_to_bgr_np(batch, h, w), want)
    np.testing.assert_array_equal(yuv.yuv420_to_bgr_np(batch[1], h, w),
                                  want[1])
    n = yuv420_to_bgr.launches
    np.testing.assert_array_equal(yuv420_to_bgr(T(batch), h, w).numpy(),
                                  want)
    assert yuv420_to_bgr.launches == n  # the CPU runs the plain version


@pytest.mark.parametrize("h,w", SHAPES)
def test_plain_op_matches_live_swscale(h, w, native_libs):
    """Against swscale's converter through the port's binding (and the
    JAX package's binding of the same library, which ``native_libs``
    readies: in a fresh checkout it may have cached a failed build)."""
    _needs_yuv_decoder()
    from cut_detection_tpu.data import native_video as jax_native_video

    y, u, v = _random_planes(np.random.default_rng(h * 1000 + w), h, w)
    want = native_video.yuv420_to_bgr24_host(y, u, v)
    np.testing.assert_array_equal(
        want, jax_native_video.yuv420_to_bgr24_host(y, u, v))
    got = yuv.yuv420_to_bgr(T(yuv.pack_yuv420(y, u, v)[None]), h, w)
    np.testing.assert_array_equal(got[0].numpy(), want)


def test_random_image_sweep_matches_live_swscale():
    _needs_yuv_decoder()
    rng = np.random.default_rng(7)
    for _ in range(20):
        h = 2 * int(rng.integers(1, 100))
        w = 2 * int(rng.integers(1, 160))
        y, u, v = _random_planes(rng, h, w)
        got = yuv.yuv420_to_bgr(T(yuv.pack_yuv420(y, u, v)[None]), h, w)
        np.testing.assert_array_equal(
            got[0].numpy(), native_video.yuv420_to_bgr24_host(y, u, v),
            err_msg=f"{h}x{w}")


def test_exhaustive_probe_matches_live_swscale():
    """All 2^24 (Y, U, V) combinations: the 4096x4096 probe holds each
    once, and the plain version equals swscale and the numpy twin on
    it, converted in strips of 512 rows (the conversion is local to each
    2x2 block, so a strip is an image of its own)."""
    _needs_yuv_decoder()
    y, u, v = yuv.exhaustive_probe()
    chroma = (u.astype(np.uint32) << 8) | v
    keys = (y.astype(np.uint32) << 16) | np.repeat(np.repeat(chroma, 2, 0),
                                                   2, 1)
    seen = np.zeros(1 << 24, bool)
    seen[keys] = True
    assert keys.size == 1 << 24 and seen.all()  # each combination once
    del keys
    rows = 512
    for top in range(0, 4096, rows):
        ys = y[top:top + rows]
        us, vs = u[top // 2:(top + rows) // 2], v[top // 2:(top + rows) // 2]
        flat = yuv.pack_yuv420(ys, us, vs)
        got = yuv.yuv420_to_bgr(T(flat[None]), rows, 4096)[0].numpy()
        np.testing.assert_array_equal(
            got, native_video.yuv420_to_bgr24_host(ys, us, vs),
            err_msg=f"rows {top}..{top + rows}")
        np.testing.assert_array_equal(got,
                                      yuv.yuv420_to_bgr_np(flat, rows, 4096))


@pytest.mark.parametrize("h,w", [(145, 256), (144, 255), (3, 3)])
def test_odd_dims_rejected(h, w):
    """Odd sizes take swscale's interpolating path: every version
    refuses them, as the JAX op does."""
    flat = torch.zeros((1, yuv420_nbytes(h, w)), dtype=torch.uint8)
    for fn in (yuv.yuv420_to_bgr, yuv420_to_bgr):
        with pytest.raises(ValueError, match="even dims"):
            fn(flat, h, w)
    with pytest.raises(ValueError, match="even dims"):
        yuv.yuv420_to_bgr_np(flat.numpy(), h, w)
    with pytest.raises(ValueError, match="even dims"):
        jax_yuv.yuv420_to_bgr(jnp.zeros(tuple(flat.shape), jnp.uint8), h, w)


def test_wrong_plane_size_rejected():
    with pytest.raises(ValueError, match="takes"):
        yuv420_to_bgr(torch.zeros((2, 100), dtype=torch.uint8), 144, 256)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_step_on_yuv_equals_step_on_host_converted(precision):
    """At every rung the step on a YUV batch gives exactly what the same
    net's step gives on the batch converted on the host."""
    batch = _yuv_batch(11, 4)
    net, _ = load_default_net("cpu", precision)
    conf, pred = make_classify_step(net, yuv_dims=(144, 256))(T(batch))
    bgr = yuv.yuv420_to_bgr_np(batch, 144, 256)
    want_conf, want_pred = make_classify_step(net)(T(bgr))
    assert torch.equal(pred, want_pred)
    assert torch.equal(conf, want_conf)


@pytest.mark.parametrize("precision,tol", [("float32", 1e-4),
                                           ("bfloat16_full", 1e-2)])
def test_step_on_yuv_matches_jax(precision, tol):
    """The step with ``yuv_dims`` against the JAX step with the same
    ``yuv_dims`` on a seeded batch: equal argmax, max logit within
    ``tol``."""
    batch = _yuv_batch(12, 4)
    jnet, _ = jax_default(precision=precision)
    jconf, jpred = (np.asarray(a) for a in jax_make_step(
        jnet, yuv_dims=(144, 256))(jnet.bundle, batch))
    net, _ = load_default_net("cpu", precision)
    conf, pred = make_classify_step(net, yuv_dims=(144, 256))(T(batch))
    np.testing.assert_array_equal(pred.numpy(), jpred)
    np.testing.assert_allclose(conf.numpy(), jconf, rtol=0, atol=tol)


def test_step_yuv_memo_and_exclusions():
    """``yuv_dims`` is part of the memo key and excludes the on-device
    preprocess options, as in the JAX step."""
    net, _ = load_default_net("cpu")
    a = make_classify_step(net, yuv_dims=(144, 256))
    assert make_classify_step(net, yuv_dims=[144, 256]) is a
    assert a is not make_classify_step(net)
    assert a is not make_classify_step(net, yuv_dims=(36, 64))
    for opts in ({"device_resize": (144, 256)}, {"pallas_preprocess": True},
                 {"device_resize": (144, 256), "pallas_preprocess": True}):
        with pytest.raises(ValueError, match="mutually exclusive"):
            make_classify_step(net, yuv_dims=(144, 256), **opts)
        with pytest.raises(ValueError, match="mutually exclusive"):
            jax_make_step(jax_default()[0], yuv_dims=(144, 256), **opts)


def test_yuv_decode_paths_match_host_oracle(synthetic_video):
    """``classify_video`` under yuv420, with the sequential decoder, the
    chunk-parallel one and the decode subprocess, equals the host
    composition of its parts (``NativeYUVSource`` -> ``yuv420_to_bgr_np``
    -> the BGR step) exactly."""
    _needs_yuv_decoder()
    net, _ = load_default_net("cpu")
    src = native_video.NativeYUVSource(synthetic_video, resize=256)
    step = make_classify_step(net)
    confs, preds = [], []
    for batch, valid in batch_frames(src, 32):
        c, p = step(T(yuv.yuv420_to_bgr_np(batch, 144, 256)))
        confs.append(c[:valid].numpy())
        preds.append(p[:valid].numpy())
    want_c, want_p = np.concatenate(confs), np.concatenate(preds)
    for kw in ({"decode_workers": 1, "decode_process": False},
               {"decode_workers": 3, "decode_process": False},
               {"decode_workers": 3, "decode_process": True}):
        conf, pred, stats = classify_video(
            synthetic_video, net, batch_size=32, print_every=0,
            transfer="yuv420", **kw)
        assert stats.frames == 240, kw
        np.testing.assert_array_equal(pred, want_p, err_msg=str(kw))
        np.testing.assert_array_equal(conf, want_c, err_msg=str(kw))


@pytest.mark.parametrize("threads", [1, 3])
def test_yuv_parallel_reader_matches_sequential(synthetic_video, threads):
    """``ParallelVideoReader(backend="yuv")`` reproduces the sequential
    YUV stream byte for byte, and a seek lands on the sequential frame."""
    _needs_yuv_decoder()
    seq = list(native_video.NativeYUVSource(synthetic_video, resize=256))
    par = ParallelVideoReader(synthetic_video, resize=256,
                              num_threads=threads, chunk_frames=64,
                              backend="yuv")
    assert par.frame_nbytes == yuv420_nbytes(144, 256)
    got = list(par)
    assert len(got) == len(seq) == 240 and par.frames_failed == 0
    np.testing.assert_array_equal(np.stack(got), np.stack(seq))
    src = native_video.NativeYUVSource(synthetic_video, resize=256)
    for i in (67, 0, 239, 128):
        src.seek(i)
        np.testing.assert_array_equal(next(src), seq[i], err_msg=f"{i}")
    src.close()


def test_odd_target_height_falls_back_to_bgr(tmp_path, caplog):
    """630x354 -> 256x143: an odd target takes the BGR transfer, with a
    warning, and writes the BGR path's CSV byte for byte (port of
    ``tests/test_yuv.py:test_pipeline_yuv_transfer_odd_height_falls_back``)."""
    _needs_yuv_decoder()
    import cv2

    path = str(tmp_path / "odd.mp4")
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30,
                         (630, 354))
    rng = np.random.default_rng(3)
    base = np.full((354, 630, 3), (40, 120, 40), np.uint8)
    for _ in range(40):
        wr.write(cv2.add(base, rng.integers(0, 30, (354, 630, 3),
                                            dtype=np.uint8)))
    wr.release()
    out_y, out_b = tmp_path / "odd_yuv.csv", tmp_path / "odd_bgr.csv"
    with caplog.at_level(logging.WARNING):
        segment_video_file(path, str(out_y), device="cpu", print_every=0,
                           transfer="yuv420")
    assert "falling back to the BGR transfer" in caplog.text
    segment_video_file(path, str(out_b), device="cpu", print_every=0,
                       transfer="bgr")
    assert out_y.read_bytes() == out_b.read_bytes()


def test_video_info_without_cv2(monkeypatch):
    """Where cv2 is missing the yuv420 path reads the target size from the
    native decoder's info, which is cv2's."""
    _needs_yuv_decoder()
    import os

    from cut_detection_tpu_torch import pipeline
    from cut_detection_tpu_torch.data import video

    clip = os.path.join(os.path.dirname(__file__), "golden", "clip_odd.mp4")
    want = pipeline._video_info(clip)
    monkeypatch.setattr(video, "cv2", None)
    assert pipeline._video_info(clip) == want


@pytest.mark.parametrize("precision", ["float32", "uint8_chain"])
def test_yuv420_transfer_holds_corpus_accuracy(tmp_path, precision):
    """``--cpu --transfer yuv420`` on corpus a, b, c and nat at the JAX
    package's gate for the transfer (``tests/test_eval_corpus.py``:
    ``test_yuv420_transfer_holds_accuracy``): frame accuracy >= 0.99,
    boundary precision and recall >= 0.90 at a 30-frame tolerance."""
    _needs_yuv_decoder()
    import os

    from cut_detection_tpu_torch.cli import segment_video as cli
    from cut_detection_tpu_torch.cli.evaluate import evaluate

    corpus = os.path.join(os.path.dirname(__file__), "eval_corpus")
    for name, n in (("corpus_a", 590), ("corpus_b", 535), ("corpus_c", 540),
                    ("corpus_nat", 590)):
        out = str(tmp_path / f"{name}.csv")
        cli.main([os.path.join(corpus, f"{name}.mp4"), "--cpu", "--transfer",
                  "yuv420", "--precision", precision, "--output_path", out,
                  "--print-every", "0"])
        res = evaluate(out, os.path.join(corpus, f"{name}_truth.csv"), n,
                       tolerance=30)
        assert res["frame_accuracy"] >= 0.99, (name, res)
        assert res["boundary_precision"] >= 0.90, (name, res)
        assert res["boundary_recall"] >= 0.90, (name, res)
