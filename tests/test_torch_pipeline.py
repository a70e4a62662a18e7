"""The port's pipeline and CLI on the CPU, against the golden CSVs and the
JAX pipeline on the same videos.

``--cpu --transfer bgr`` is the byte-parity configuration: its CSVs must
equal ``tests/golden/ref_segments*.csv`` and the JAX CLI's output, with
and without ``--device-resize [--pallas-preprocess]``.
"""

import os

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from cut_detection_tpu.data.video import batch_frames
from cut_detection_tpu.models.assembly import load_default_net as jax_default
from cut_detection_tpu.pipeline import make_classify_step as jax_make_step
from cut_detection_tpu.pipeline import classify_video as jax_classify
from cut_detection_tpu.pipeline import segment_video_file as jax_segment
from cut_detection_tpu.segmentation import glue as jax_glue
from cut_detection_tpu.segmentation.csv_io import (
    write_segments_csv as jax_write_csv,
)
from cut_detection_tpu.segmentation.rle import Segmentation as JaxSegmentation
from cut_detection_tpu_torch.cli import segment_video as cli
from cut_detection_tpu_torch.models.assembly import load_default_net
from cut_detection_tpu_torch.pipeline import (
    _resolve_decode_process,
    available_decoder,
    classify_batches,
    classify_video,
    make_classify_step,
    resolve_transfer,
    segment_video_file,
)
from cut_detection_tpu_torch.segmentation import glue
from cut_detection_tpu_torch.segmentation.csv_io import write_segments_csv
from cut_detection_tpu_torch.segmentation.rle import Segmentation

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
CPU = torch.device("cpu")


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def net():
    return load_default_net(CPU)[0]


@pytest.mark.parametrize("clip,ref", [("clip.mp4", "ref_segments.csv"),
                                      ("clip_odd.mp4",
                                       "ref_segments_odd.csv")])
def test_cli_matches_golden_csv(tmp_path, clip, ref):
    """clip_odd (427x240 -> 256x143) takes floor pooling over an H that 3
    does not divide."""
    out = str(tmp_path / "out.csv")
    got = cli.main([os.path.join(GOLDEN, clip), "--cpu", "--transfer", "bgr",
                    "--output_path", out, "--print-every", "0"])
    assert got == out
    assert _read(out) == _read(os.path.join(GOLDEN, ref))


@pytest.mark.parametrize("flags", [["--device-resize"],
                                   ["--device-resize", "--pallas-preprocess"],
                                   ["--pallas-preprocess"]])
@pytest.mark.parametrize("clip,ref", [("clip.mp4", "ref_segments.csv"),
                                      ("clip_odd.mp4",
                                       "ref_segments_odd.csv")])
def test_cli_on_device_preprocess_matches_golden_csv(tmp_path, clip, ref,
                                                     flags):
    """Frames decode at source resolution (320x180 and 427x240) and are
    resized by the step; ``--pallas-preprocess`` alone implies the
    resize, as in the JAX CLI."""
    out = str(tmp_path / "out.csv")
    cli.main([os.path.join(GOLDEN, clip), "--cpu", "--transfer", "bgr",
              "--output_path", out, "--print-every", "0", *flags])
    assert _read(out) == _read(os.path.join(GOLDEN, ref))


@pytest.mark.parametrize("pallas_preprocess", [False, True])
def test_step_on_device_preprocess_matches_jax(net, pallas_preprocess):
    """The step on 4 seeded 360x640 frames against the JAX step with the
    same options: max logit within 1e-4, 0 argmax flips.  The JAX Pallas
    kernel runs in interpret mode."""
    frames = np.random.default_rng(5).integers(0, 256, (4, 360, 640, 3),
                                               dtype=np.uint8)
    jnet, _ = jax_default()
    jstep = jax_make_step(jnet, device_resize=(144, 256),
                          pallas_preprocess=pallas_preprocess)
    with pltpu.force_tpu_interpret_mode():
        jconf, jpred = (np.asarray(a) for a in jstep(jnet.bundle, frames))
    step = make_classify_step(net, device_resize=(144, 256),
                              pallas_preprocess=pallas_preprocess)
    conf, pred = step(torch.from_numpy(frames))
    np.testing.assert_array_equal(pred.numpy(), jpred)
    np.testing.assert_allclose(conf.numpy(), jconf, rtol=0, atol=1e-4)


def test_step_memo_is_per_option(net):
    """One step per (net, options): the folded and the unfolded nets are
    never shared between options."""
    options = [{}, {"device_resize": (144, 256)},
               {"device_resize": (144, 256), "pallas_preprocess": True},
               {"device_resize": (143, 256)}]
    steps = [make_classify_step(net, **o) for o in options]
    assert len({id(s) for s in steps}) == len(options)
    for o, s in zip(options, steps):
        assert make_classify_step(net, **o) is s
    assert make_classify_step(net, device_resize=[144, 256]) is steps[1]
    other = load_default_net(CPU)[0]
    assert make_classify_step(other) is not steps[0]


def test_step_memo_is_per_precision(net):
    """A float32 net and a bf16 net of the same weights never share a
    memoized step: precision is the net's, and the memo is per net."""
    nets = [net] + [load_default_net(CPU, p)[0]
                    for p in ("bfloat16", "bfloat16_full")]
    for opts in ({}, {"device_resize": (144, 256),
                      "pallas_preprocess": True}):
        steps = [make_classify_step(n, **opts) for n in nets]
        assert len({id(s) for s in steps}) == len(nets)
        for n, s in zip(nets, steps):
            assert make_classify_step(n, **opts) is s
    frames = torch.from_numpy(np.random.default_rng(8).integers(
        0, 256, (2, 36, 64, 3), dtype=np.uint8))
    confs = [make_classify_step(n)(frames)[0] for n in nets]
    assert not torch.equal(confs[0], confs[1])
    assert not torch.equal(confs[0], confs[2])


def test_device_resize_with_decode_subprocess_matches_jax(synthetic_video,
                                                          tmp_path, net):
    """The shared-memory ring carries source-resolution batches."""
    ours, theirs = str(tmp_path / "ours.csv"), str(tmp_path / "jax.csv")
    segment_video_file(synthetic_video, ours, net=net, batch_size=64,
                       print_every=0, decode_process=True, transfer="bgr",
                       device_resize=True)
    jax_segment(synthetic_video, theirs, batch_size=64, print_every=0,
                transfer="bgr", device_resize=True)
    assert _read(ours) == _read(theirs)


@pytest.mark.parametrize("decode_process", [False, True])
def test_segment_video_matches_jax(synthetic_video, tmp_path, net,
                                   decode_process):
    """Same CSV as the JAX pipeline, with in-process decode and with the
    shared-memory decode subprocess (whose ring slots are copied out on
    the CPU)."""
    ours, theirs = str(tmp_path / "ours.csv"), str(tmp_path / "jax.csv")
    segment_video_file(synthetic_video, ours, net=net, batch_size=64,
                       print_every=0, decode_process=decode_process,
                       transfer="bgr")
    jax_segment(synthetic_video, theirs, batch_size=64, print_every=0,
                transfer="bgr")
    assert _read(ours) == _read(theirs)
    assert b"\r\n" in _read(ours)


def test_frame_limit_matches_jax(synthetic_video, tmp_path, net):
    """--frame-limit breaks after the batch that crosses the limit."""
    conf, _, _ = classify_video(synthetic_video, net, batch_size=32,
                                frame_limit=100, print_every=0)
    jconf, _, _ = jax_classify(synthetic_video, batch_size=32,
                               frame_limit=100, print_every=0,
                               transfer="bgr")
    assert conf.shape[0] == jconf.shape[0] == 128
    ours, theirs = str(tmp_path / "ours.csv"), str(tmp_path / "jax.csv")
    segment_video_file(synthetic_video, ours, net=net, batch_size=64,
                       frame_limit=100, print_every=0)
    jax_segment(synthetic_video, theirs, batch_size=64, frame_limit=100,
                print_every=0, transfer="bgr")
    assert _read(ours) == _read(theirs)


def _cache_runs(classify, video, cache):
    """The JAX cache test's sequence of runs: (frames, batches) each."""
    out = []
    for bs, limit in ((32, 40), (32, None), (32, 40), (32, 40), (64, 40),
                      (64, 40)):
        conf, _, stats = classify(video, batch_size=bs, frame_limit=limit,
                                  cache_path=cache, print_every=0)
        out.append((conf.shape[0], stats.batches))
    return out


def test_score_cache_matches_jax(synthetic_video, tmp_path, net):
    """Served from the cache exactly when JAX's would be: same frame
    limit and, for a limited run, the same batch size."""
    ours = _cache_runs(
        lambda *a, **k: classify_video(*a, net=net, **k), synthetic_video,
        str(tmp_path / "ours.npz"))
    theirs = _cache_runs(
        lambda *a, **k: jax_classify(*a, transfer="bgr", **k),
        synthetic_video, str(tmp_path / "jax.npz"))
    assert ours == theirs
    assert [b for _, b in ours][3] == 0  # the repeat came from the cache
    with np.load(tmp_path / "ours.npz") as a, \
            np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        np.testing.assert_array_equal(a["pred"], b["pred"])
        assert int(a["batch_size"]) == int(b["batch_size"])


def test_score_buffer_grows_past_reported_length(net):
    """A container that under-reports its frame count still scores every
    frame (the device buffer doubles)."""
    frames = np.random.default_rng(0).integers(0, 256, (70, 36, 64, 3),
                                               dtype=np.uint8)
    conf, pred, stats = classify_batches(batch_frames(iter(frames), 16),
                                         net, batch_size=16, length=1,
                                         print_every=0)
    ref_conf, ref_pred, _ = classify_batches(
        batch_frames(iter(frames), 16), net, batch_size=16, length=70,
        print_every=0)
    assert stats.batches == 5 and conf.shape == (70,)
    np.testing.assert_array_equal(pred, ref_pred)
    np.testing.assert_array_equal(conf, ref_conf)


def _scores(seed: int, n: int = 600):
    """Piecewise-constant classes with short orphans and noisy scores."""
    rng = np.random.default_rng(seed)
    pred = np.repeat(rng.integers(0, 3, 40), rng.integers(1, 40, 40))[:n]
    conf = rng.normal(5, 2, pred.shape[0]).astype(np.float32)
    return conf, pred


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("backend", ["python", "auto"])
def test_segmentation_matches_jax(tmp_path, seed, backend):
    conf, pred = _scores(seed)
    ours = Segmentation.from_frame_scores(conf, pred)
    theirs = JaxSegmentation.from_frame_scores(conf, pred)
    for seg in (ours, theirs):
        seg.glue_orphans(100, 10, backend=backend)
        seg.combine_adjacent_segments(backend=backend)
    assert ours.te.keys() == theirs.te.keys()
    for k in ours.te:
        np.testing.assert_array_equal(ours.te[k], theirs.te[k])
    ours.write_csv(str(tmp_path / "a.csv"))
    theirs.write_csv(str(tmp_path / "b.csv"))
    assert _read(tmp_path / "a.csv") == _read(tmp_path / "b.csv")


@pytest.mark.parametrize("seed", range(3))
def test_glue_and_csv_match_jax(tmp_path, seed):
    """``Segmentation(logits)`` and the numpy merge loop on their own."""
    logits = np.random.default_rng(seed).normal(0, 1, (200, 3))
    te = Segmentation(logits).te
    assert te.keys() == JaxSegmentation(logits).te.keys()
    a = glue.glue_orphans({k: v.copy() for k, v in te.items()}, 20, 5)
    b = jax_glue.glue_orphans({k: v.copy() for k, v in te.items()}, 20, 5)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    write_segments_csv(str(tmp_path / "a.csv"), [0, 7, 99], ["b", "ez", "a22"])
    jax_write_csv(str(tmp_path / "b.csv"), [0, 7, 99], ["b", "ez", "a22"])
    assert _read(tmp_path / "a.csv") == _read(tmp_path / "b.csv")


def test_transfer_and_decode_process_resolution(monkeypatch):
    """``auto`` is yuv420 exactly on CUDA with the YUV decoder and no
    on-device preprocess, as the JAX package's rules have it on an
    accelerator; an explicit yuv420 without the decoder raises."""
    from cut_detection_tpu_torch.data import native_video

    cuda = torch.device("cuda")
    for yuv_built in (True, False):
        monkeypatch.setattr(native_video, "yuv_available", lambda: yuv_built)
        assert resolve_transfer("auto", device=cuda) == (
            "yuv420" if yuv_built else "bgr")
        for kw in ({"device": CPU}, {},
                   {"device": cuda, "on_device_preprocess": True}):
            assert resolve_transfer("auto", **kw) == "bgr", kw
        assert resolve_transfer("bgr", device=cuda) == "bgr"
        if yuv_built:
            assert resolve_transfer("yuv420", device=CPU) == "yuv420"
        else:
            with pytest.raises(RuntimeError, match="YUV entry points"):
                resolve_transfer("yuv420", device=cuda)
    with pytest.raises(ValueError):
        resolve_transfer("rgb")
    assert _resolve_decode_process("auto", torch.device("cuda")) is True
    assert _resolve_decode_process("auto", CPU) is False
    assert _resolve_decode_process(True, CPU) is True


@pytest.mark.parametrize("cv2_present", [True, False])
@pytest.mark.parametrize("native_built", [True, False])
def test_available_decoder(monkeypatch, cv2_present, native_built):
    """cv2 when it imports, else the native decoder when it is built."""
    import sys

    from cut_detection_tpu_torch.data import native_video

    if not cv2_present:
        monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setattr(native_video, "available", lambda: native_built)
    want = "cv2" if cv2_present else "native" if native_built else None
    assert available_decoder() == want


@pytest.mark.parametrize("flags", [
    ["--precision", "int8_mxu"], ["--device-glue"], ["--profile", "trace_dir"],
])
def test_cli_refuses_unported_flags(tmp_path, flags):
    """The three JAX-CLI options the port once refused now run: each
    writes the JAX CLI's CSV with the same option (and the reference's),
    and ``--profile`` leaves a trace file in its directory."""
    clip = os.path.join(GOLDEN, "clip.mp4")
    out, theirs = str(tmp_path / "out.csv"), str(tmp_path / "jax.csv")
    flags = [str(tmp_path / f) if f == "trace_dir" else f for f in flags]
    cli.main([clip, "--cpu", "--transfer", "bgr", "--output_path", out,
              "--print-every", "0", *flags])
    jax_segment(clip, theirs, print_every=0, transfer="bgr",
                precision=flags[1] if flags[0] == "--precision"
                else "float32", device_glue=flags == ["--device-glue"])
    with open(out, "rb") as f, open(theirs, "rb") as g, open(
            os.path.join(GOLDEN, "ref_segments.csv"), "rb") as r:
        assert f.read() == g.read() == r.read()
    if flags[0] == "--profile":
        traces = os.listdir(flags[1])
        assert len(traces) == 1 and traces[0].endswith(".json")


@pytest.mark.parametrize("clip,ref", [("clip.mp4", "ref_segments.csv"),
                                      ("clip_odd.mp4",
                                       "ref_segments_odd.csv")])
def test_cli_transfer_yuv420_matches_golden_and_jax_csv(tmp_path, clip, ref):
    """``--cpu --transfer yuv420`` (the native YUV decoder, the conversion
    on the device, float32) writes the reference CSV, and the JAX
    pipeline's under ``transfer="yuv420"``, byte for byte."""
    from cut_detection_tpu_torch.data import native_video

    if not native_video.yuv_available():
        pytest.skip("native decoder with YUV entry points not built")
    out, theirs = str(tmp_path / "out.csv"), str(tmp_path / "jax.csv")
    cli.main([os.path.join(GOLDEN, clip), "--cpu", "--transfer", "yuv420",
              "--output_path", out, "--print-every", "0"])
    jax_segment(os.path.join(GOLDEN, clip), theirs, print_every=0,
                transfer="yuv420")
    assert _read(out) == _read(os.path.join(GOLDEN, ref)) == _read(theirs)


@pytest.mark.parametrize("flag", ["--device-resize", "--pallas-preprocess"])
def test_cli_refuses_yuv420_with_on_device_preprocess(capsys, flag):
    """The JAX CLI's parse-time exclusion; the pipeline refuses it too."""
    with pytest.raises(SystemExit) as exc:
        cli.main(["clip.mp4", "--cpu", "--transfer", "yuv420", flag])
    assert exc.value.code == 2
    assert "cannot combine" in capsys.readouterr().err
    with pytest.raises(ValueError, match="can't combine"):
        classify_video(os.path.join(GOLDEN, "clip.mp4"), device=CPU,
                       transfer="yuv420", device_resize=True)


def test_cli_without_cuda_needs_cpu_flag(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        cli.main([os.path.join(GOLDEN, "clip.mp4")])
    assert exc.value.code == 2
    assert "pass --cpu" in capsys.readouterr().err


def test_cli_defaults_match_jax_cli():
    from cut_detection_tpu.cli.segment_video import build_parser as jax_parser

    ours = vars(cli.build_parser().parse_args(["v.mp4"]))
    theirs = vars(jax_parser().parse_args(["v.mp4"]))
    assert ours == theirs
