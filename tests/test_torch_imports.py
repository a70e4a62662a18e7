"""The port imports and runs without jax and without the JAX package.

A machine that runs the port may have no jax at all, and the port keeps
its own copies of what it needs from ``cut_detection_tpu``, so every
module of ``cut_detection_tpu_torch`` (and ``chip_smoke.py``) is imported
in a fresh interpreter where ``import jax`` and ``import
cut_detection_tpu`` both fail, and the CLI segments the golden clip
there, with the decode in-process and in its spawned subprocess.  The
subprocess starts from a fresh import, so the guard reaches it through a
directory first on its path whose ``jax`` and ``cut_detection_tpu``
packages raise on import.
"""

import ast
import json
import os
import subprocess
import sys
import textwrap

import pytest

from tests.torch_threads import TEST_THREADS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCKED = ("jax", "cut_detection_tpu")
_BLOCK = f"""
import sys
for _name in {BLOCKED!r}:
    sys.modules[_name] = None  # any import of it now raises ImportError
"""


def _run(code: str, tmp_path) -> subprocess.CompletedProcess:
    shadow = tmp_path / "blocked"
    for name in BLOCKED:
        (shadow / name).mkdir(parents=True)
        (shadow / name / "__init__.py").write_text(
            f"raise ImportError('{name} is blocked here')\n")
    # The port's tests' thread cap: the suite's six workers share eight
    # cores.
    env = dict(os.environ, OMP_NUM_THREADS=str(TEST_THREADS),
               PYTHONPATH=os.pathsep.join([str(shadow), REPO]))
    return subprocess.run(
        [sys.executable, "-c", _BLOCK + textwrap.dedent(code)],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)


def test_chip_smoke_imports_only_the_port():
    """``chip_smoke.py`` reaches the JAX package only through the port:
    every module it imports is the standard library, numpy, torch or
    ``cut_detection_tpu_torch``."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    assert "cut_detection_tpu_torch" in roots
    assert roots - set(sys.stdlib_module_names) == {
        "numpy", "torch", "cut_detection_tpu_torch"}, roots


def test_port_sources_import_nothing_of_the_jax_package():
    """No port module names ``jax`` or ``cut_detection_tpu`` in an import
    statement, at any depth (a function-level import only runs when it
    is called)."""
    pkg = os.path.join(REPO, "cut_detection_tpu_torch")
    bad = []
    for root, _, files in os.walk(pkg):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
            with open(path) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    mods = [node.module]
                else:
                    continue
                bad += [(path, m) for m in mods
                        if m.split(".")[0] in BLOCKED]
    assert not bad, bad


@pytest.mark.parametrize("decode_process", ["off", "on"])
def test_port_imports_and_runs_without_jax(tmp_path, decode_process):
    """Every port module and ``chip_smoke.py`` import, and the CLI
    segments the golden clip (in-process decode, and the decode
    subprocess) byte for byte, with jax and the JAX package blocked."""
    out = str(tmp_path / "out.csv")
    clip = os.path.join(REPO, "tests", "golden", "clip.mp4")
    proc = _run(f"""
        import importlib, pkgutil
        import cut_detection_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                       pkg.__name__ + ".")]
        assert len(names) >= 30, names
        for name in names:
            importlib.import_module(name)
        sys.path.insert(0, {REPO!r})
        import chip_smoke
        from cut_detection_tpu_torch.cli.segment_video import main
        main([{clip!r}, "--cpu", "--transfer", "bgr", "--output_path",
              {out!r}, "--print-every", "0",
              "--decode-process", {decode_process!r}])
        assert sys.modules["jax"] is None
        assert sys.modules["cut_detection_tpu"] is None
    """, tmp_path)
    assert proc.returncode == 0, proc.stderr
    with open(out, "rb") as f, open(os.path.join(
            REPO, "tests", "golden", "ref_segments.csv"), "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("decode_process", ["off", "on"])
def test_yuv420_transfer_runs_without_jax(tmp_path, decode_process):
    """``--transfer yuv420`` with jax and the JAX package blocked: the
    native YUV decoder in-process and in the spawned decode child, the
    conversion, and the golden clip's CSV byte for byte."""
    from cut_detection_tpu_torch.data import native_video

    if not native_video.yuv_available():
        pytest.skip("native decoder with YUV entry points not built")
    out = str(tmp_path / "out.csv")
    clip = os.path.join(REPO, "tests", "golden", "clip.mp4")
    proc = _run(f"""
        from cut_detection_tpu_torch.cli.segment_video import main
        main([{clip!r}, "--cpu", "--transfer", "yuv420", "--output_path",
              {out!r}, "--print-every", "0",
              "--decode-process", {decode_process!r}])
        assert sys.modules["jax"] is None
        assert sys.modules["cut_detection_tpu"] is None
    """, tmp_path)
    assert proc.returncode == 0, proc.stderr
    with open(out, "rb") as f, open(os.path.join(
            REPO, "tests", "golden", "ref_segments.csv"), "rb") as g:
        assert f.read() == g.read()


def test_int8_device_glue_and_profile_run_without_jax(tmp_path):
    """``--precision int8_mxu --device-glue --profile DIR`` with jax and
    the JAX package blocked: the int8 blocks, the smoother on the device
    and the profiler hook import only the port, and the golden clip's
    CSV is the reference's byte for byte, with a trace file in DIR."""
    out = str(tmp_path / "out.csv")
    trace = str(tmp_path / "trace")
    clip = os.path.join(REPO, "tests", "golden", "clip.mp4")
    proc = _run(f"""
        from cut_detection_tpu_torch.cli.segment_video import main
        main([{clip!r}, "--cpu", "--transfer", "bgr", "--output_path",
              {out!r}, "--print-every", "0", "--decode-process", "off",
              "--precision", "int8_mxu", "--device-glue", "--profile",
              {trace!r}])
        assert sys.modules["jax"] is None
        assert sys.modules["cut_detection_tpu"] is None
    """, tmp_path)
    assert proc.returncode == 0, proc.stderr
    with open(out, "rb") as f, open(os.path.join(
            REPO, "tests", "golden", "ref_segments.csv"), "rb") as g:
        assert f.read() == g.read()
    assert [n for n in os.listdir(trace) if n.endswith(".json")]


def test_parallel_runs_without_jax(tmp_path):
    """``parallel/`` imports only the port: with jax and the JAX package
    blocked, its modules import, the sharded classify step runs over a
    mesh of two CPU entries, and ``initialize`` outside a group is the
    single-process no-op; the tensor-parallel step runs over a model-2
    mesh of four CPU entries."""
    proc = _run("""
        import importlib, os
        for name in ("mesh", "sharding", "distributed", "local_cluster"):
            importlib.import_module("cut_detection_tpu_torch.parallel." + name)
        import numpy as np
        from cut_detection_tpu_torch.models.assembly import load_default_net
        from cut_detection_tpu_torch.parallel import (
            distributed, make_mesh, make_sharded_classify_step)
        net, _ = load_default_net("cpu")
        conf, pred = make_sharded_classify_step(net, make_mesh(["cpu"] * 2))(
            np.zeros((4, 36, 64, 3), np.uint8))
        assert conf.shape == (4,) and pred.shape == (4,)
        mesh = make_mesh(["cpu"] * 4, model_parallel=2)
        assert mesh.shape == {"data": 2, "model": 2}
        conf, pred = make_sharded_classify_step(net, mesh,
                                                tensor_parallel=True)(
            np.zeros((4, 36, 64, 3), np.uint8))
        assert conf.shape == (4,) and pred.shape == (4,)
        for k in ("RANK", "WORLD_SIZE"):
            os.environ.pop(k, None)
        assert distributed.initialize() == 0
        assert distributed.partition_inputs([1, 2, 3]) == [1, 2, 3]
        assert sys.modules["jax"] is None
        assert sys.modules["cut_detection_tpu"] is None
    """, tmp_path)
    assert proc.returncode == 0, proc.stderr


def test_training_clis_run_without_jax(tmp_path):
    """Contrastive pretraining (the fast views), then supervised training
    warm-started from it with ``--export-torch``, and the triplet driving
    the classify step, with jax and the JAX package blocked."""
    import cv2
    import numpy as np

    frames = tmp_path / "frames"
    frames.mkdir()
    rng = np.random.default_rng(0)
    for i in range(12):
        cv2.imwrite(str(frames / f"frame_{i:07d}.jpg"),
                    rng.integers(0, 256, (36, 64, 3), dtype=np.uint8))
    (frames / "frames.csv").write_text("0,a22\n4,ez\n8,b\n")
    models = str(tmp_path / "models")
    net = ["--conv-layers", "2", "--conv-hidden-channels", "8",
           "--linear-layers", "2", "--linear-size", "8", "--epochs", "1",
           "--num-workers", "0", "--model-dir", models, "--cpu"]
    proc = _run(f"""
        import torch
        from cut_detection_tpu_torch.cli import (
            train_contrastive, train_supervised)
        from cut_detection_tpu_torch.models.assembly import (
            load_triplet_or_default)
        from cut_detection_tpu_torch.pipeline import make_classify_step
        net = {net!r}
        train_contrastive.main(["--data-dir", {str(frames)!r},
                                "--output-size", "4", "--batch-size", "4",
                                "--fast-augment"] + net)
        train_supervised.main(["--data-dirs", {str(frames)!r},
                               "--avg-pool-size", "2", "--batch-size", "4",
                               "--load-conv-net", "--export-torch"] + net)
        model, _ = load_triplet_or_default({models!r}, "init_model", "cpu")
        conf, pred = make_classify_step(model)(
            torch.zeros(3, 36, 64, 3, dtype=torch.uint8))
        assert conf.shape == (3,) and pred.shape == (3,)
        assert sys.modules["jax"] is None
        assert sys.modules["cut_detection_tpu"] is None
    """, tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert sorted(os.listdir(models)) == [
        "init_model_classifier_conv.npz", "init_model_classifier_conv.pt",
        "init_model_classifier_linear.npz",
        "init_model_classifier_linear.pt", "init_model_conv.npz",
        "init_model_embed_params.json", "init_model_linear.npz",
        "init_model_model_params.json", "train_state_0000.npz",
        "train_state_meta.json"]


def test_tool_clis_run_without_jax(tmp_path):
    """``doctor --full``, ``split_video``, ``export_model`` (both formats)
    and ``bench_pipeline`` on the CPU with jax and the JAX package
    blocked: their function-level imports reach only the port."""
    clip = os.path.join(REPO, "tests", "golden", "clip.mp4")
    frames = str(tmp_path / "frames")
    proc = _run(f"""
        import json, torch
        from cut_detection_tpu_torch.cli import (
            bench_pipeline, doctor, export_model, split_video)
        try:
            doctor.main(["--full", "--json", "--cpu"])
        except SystemExit as e:
            assert e.code == 0, e.code
        split_video.main([{clip!r}, {frames!r}, "--max-frames", "3"])
        export_model.main(["--use-default-net", "--cpu", "--output",
                           {str(tmp_path / "p.pt2")!r}, "--batch-size", "2",
                           "--height", "36", "--width", "64"])
        export_model.main(["--use-default-net", "--cpu", "--format",
                           "torch", "--output", {str(tmp_path / "t")!r}])
        line = bench_pipeline.bench_classify(1, "float32", 0.0,
                                             device=torch.device("cpu"))
        assert line["value"] > 0
        assert sys.modules["jax"] is None
        assert sys.modules["cut_detection_tpu"] is None
    """, tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.splitlines()[0])["healthy"] is True
    assert sorted(os.listdir(frames)) == [
        f"frame_{i:07}.jpg" for i in range(3)]


def test_scripts_run_without_jax(tmp_path):
    """The scripts' code that the syntax check above cannot see runs with
    jax and the JAX package blocked, at tiny sizes on the CPU:
    ``bench_decode``'s worker subprocess, ``bench_full_game``,
    the corpus writer and ``convert_torch_checkpoint``."""
    proc = _run(f"""
        import json, os, tempfile, torch
        from cut_detection_tpu_torch.checkpoint.convert import (
            convert_torch_checkpoint, export_torch_state_dicts)
        from cut_detection_tpu_torch.checkpoint.io import load_bundle
        from cut_detection_tpu_torch.scripts import (
            bench_decode, bench_full_game, make_eval_corpus)
        from cut_detection_tpu_torch.scripts.bench_clip import (
            make_bench_clip)
        tmp = {str(tmp_path)!r}
        tempfile.tempdir = tmp
        clip = make_bench_clip(os.path.join(tmp, "c.mp4"), 16, w=64, h=36)
        assert bench_decode.run_one("cv2", clip, "1")["frames"] == 16
        make_eval_corpus.write_clip(os.path.join(tmp, "e.mp4"),
                                    [("b", 3, (10, 10, 10))], 0, w=32, h=32)
        os.environ.update(FULL_GAME_FRAMES="20", FULL_GAME_MODES="bgr:float32",
                          FULL_GAME_OUT=os.path.join(tmp, "g.json"))
        assert bench_full_game.main(["--cpu"])["frames"] == 20
        prod = os.path.join({REPO!r}, "cut_detection_tpu", "prod_net")
        conv_sd, lin_sd = export_torch_state_dicts(
            load_bundle(os.path.join(prod, "init_model.npz")))
        torch.save(conv_sd, os.path.join(tmp, "c.pt"))
        torch.save(lin_sd, os.path.join(tmp, "l.pt"))
        convert_torch_checkpoint(
            os.path.join(prod, "init_model_model_params.json"),
            os.path.join(tmp, "c.pt"), os.path.join(tmp, "l.pt"))
        assert sys.modules["jax"] is None
        assert sys.modules["cut_detection_tpu"] is None
    """, tmp_path)
    assert proc.returncode == 0, proc.stderr
