"""The port's workflow and measurement scripts against the JAX package's.

Each entry point under ``cut_detection_tpu_torch/scripts/`` ports one
under ``scripts/``; the JAX scripts are read by path (``importlib``, or
their syntax tree where importing one would run JAX work or write a
cache), unchanged.  Held here on the CPU at small sizes:

- ``make_eval_corpus``: the clip and truth writers write the JAX
  script's bytes, natural and flat; ``pipeline_truth`` is the JAX one;
- ``e2e_workflow_demo``: the JAX script's stages and JSON keys, and the
  held-out CSV the JAX CLI's from the same port-trained triplet;
- ``bench_full_game``: ``_windows`` and ``_flat`` the JAX functions, the
  record's keys the JAX record's, the float32 CSV JAX
  ``segment_video_file``'s, ``yuv420`` run or skipped as the native YUV
  decoder is there or not;
- ``bench_train`` and ``profile_simclr_step``: the JAX keys, finite
  values, and the SimCLR math on ready-made views the step's own loss;
- ``bench_decode``: one pass decodes every frame, ``main``'s keys, and
  worker code that names nothing of the JAX package or of one machine;
- ``convert_torch_checkpoint`` and ``convert_prod_net``: the JAX
  converter's bundle leaf for leaf, the same sidecar, nothing written
  outside the output directory;
- ``derive_yuv_constants``: exit 0 and "0 mismatching bytes", as
  ``tests/test_yuv.py:268-280`` runs the JAX script.
"""

import ast
import hashlib
import importlib.util
import json
import math
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from cut_detection_tpu.checkpoint import convert as jax_convert
from cut_detection_tpu.cli.segment_video import main as jax_segment_cli
from cut_detection_tpu.pipeline import segment_video_file as jax_segment
from cut_detection_tpu_torch.checkpoint.convert import (
    convert_torch_checkpoint,
    export_torch_state_dicts,
)
from cut_detection_tpu_torch.checkpoint.io import load_bundle
from cut_detection_tpu_torch.config import ContrastiveConfig
from cut_detection_tpu_torch.data import native_video
from cut_detection_tpu_torch.scripts import (
    bench_decode,
    bench_full_game,
    bench_train,
    convert_prod_net,
    e2e_workflow_demo,
    make_eval_corpus,
    profile_simclr_step,
)
from cut_detection_tpu_torch.scripts.bench_clip import make_bench_clip
from cut_detection_tpu_torch.train.contrastive import (
    init_contrastive_state,
    make_contrastive_step,
    make_contrastive_update,
)
from tests.torch_threads import two_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
PROD_NET = os.path.join(REPO, "cut_detection_tpu", "prod_net")
CPU = torch.device("cpu")


pytestmark = pytest.mark.usefixtures("two_torch_threads")


def _jax_script(name: str):
    """``scripts/<name>.py`` imported by path, unchanged."""
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tree(name: str) -> ast.Module:
    with open(os.path.join(SCRIPTS, f"{name}.py")) as f:
        return ast.parse(f.read())


def _keys(tree: ast.Module, var: str) -> set:
    """The keys that ``scripts/*.py`` writes into the dict ``var``: those
    of a ``var = {...}`` literal and every ``var[<key>] = ...``, each key
    evaluated with the values its enclosing ``for`` loops over literal
    sequences bind."""
    keys = set()

    def visit(node, env):
        for child in ast.iter_child_nodes(node):
            if (isinstance(child, ast.For)
                    and isinstance(child.iter, (ast.List, ast.Tuple))):
                target = child.target
                names = ([t.id for t in target.elts]
                         if isinstance(target, ast.Tuple) else [target.id])
                for item in child.iter.elts:
                    vals = ast.literal_eval(item)
                    vals = vals if isinstance(target, ast.Tuple) else (vals,)
                    visit(child, {**env, **dict(zip(names, vals))})
                continue
            if isinstance(child, ast.Assign):
                for t in child.targets:
                    if (isinstance(t, ast.Name) and t.id == var
                            and isinstance(child.value, ast.Dict)):
                        keys.update(ast.literal_eval(k)
                                    for k in child.value.keys)
                    if (isinstance(t, ast.Subscript)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == var):
                        expr = ast.Expression(t.slice)
                        keys.add(eval(compile(expr, "<key>", "eval"), {},
                                      dict(env)))
            visit(child, env)

    visit(tree, {})
    return keys


def _dict_literal_keys(tree: ast.Module, predicate) -> set:
    """Keys of the first dict literal for which ``predicate(parent_node)``
    holds of the node that holds it."""
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.Dict) and predicate(node):
                return {ast.literal_eval(k) for k in child.keys}
    raise AssertionError("no such dict literal")


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


# --- make_eval_corpus -------------------------------------------------------

SHORT_BLOCKS = [("a22", 6, (60, 60, 140)), ("b", 4, (10, 10, 10)),
                ("ez", 5, (160, 160, 30))]


def test_eval_corpus_tables_are_the_jax_scripts():
    theirs = _jax_script("make_eval_corpus")
    for name in ("CLIPS", "NATURAL_CLIPS", "NATURAL_AMP", "ADV_1", "ADV_2"):
        assert getattr(make_eval_corpus, name) == getattr(theirs, name)


@pytest.mark.parametrize("natural", [False, True])
def test_eval_corpus_writers_write_the_jax_bytes(tmp_path, natural):
    theirs = _jax_script("make_eval_corpus")
    a, b = str(tmp_path / "ours.mp4"), str(tmp_path / "theirs.mp4")
    truth = make_eval_corpus.write_clip(a, SHORT_BLOCKS, 5, w=96, h=64,
                                        natural=natural)
    assert truth == theirs.write_clip(b, SHORT_BLOCKS, 5, w=96, h=64,
                                      natural=natural)
    assert _read(a) == _read(b)
    make_eval_corpus.write_truth(str(tmp_path / "ours.csv"), truth)
    theirs.write_truth(str(tmp_path / "theirs.csv"), truth)
    assert _read(tmp_path / "ours.csv") == _read(tmp_path / "theirs.csv")


def test_pipeline_truth_is_the_jax_scripts(tmp_path, monkeypatch):
    """The adversarial clip's truth (the float32 pipeline's segmentation)
    on a short clip with a 9-frame near-boundary block between solids.
    The JAX function writes its CSV into the temporary directory."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    theirs = _jax_script("make_eval_corpus")
    blocks = [("a22", 30, make_eval_corpus.A22_1),
              ("adv", 9, make_eval_corpus.ADV_1),
              ("ez", 30, make_eval_corpus.EZ)]
    clip = str(tmp_path / "adv.mp4")
    make_eval_corpus.write_clip(clip, blocks, 3)
    ours = make_eval_corpus.pipeline_truth(clip)
    assert ours == theirs.pipeline_truth(clip)
    assert ours and ours[0][0] == 0


def test_eval_corpus_main_refuses_the_committed_corpus():
    with pytest.raises(SystemExit, match="committed"):
        make_eval_corpus.main([os.path.join(REPO, "tests", "eval_corpus")])


# --- e2e_workflow_demo ------------------------------------------------------


def test_workflow_demo_runs_the_jax_stages_and_keys(tmp_path, monkeypatch,
                                                    capsys):
    """``--cpu --small`` with one epoch each on short blocks: the JAX
    script's stage names and JSON keys (``:168-181``), and the held-out
    CSV is what the JAX CLI writes from the triplet the port trained."""
    assert e2e_workflow_demo.TRAIN_BLOCKS == _jax_script_blocks("TRAIN")
    assert e2e_workflow_demo.EVAL_BLOCKS == _jax_script_blocks("EVAL")
    monkeypatch.setattr(e2e_workflow_demo, "TRAIN_BLOCKS", [
        ("a22", 14, (60, 60, 140)), ("b", 12, (10, 10, 10)),
        ("ez", 14, (160, 160, 30))])
    monkeypatch.setattr(e2e_workflow_demo, "EVAL_BLOCKS", [
        ("ez", 12, (160, 160, 30)), ("a22", 12, (0, 60, 120))])
    work = tmp_path / "work"
    record = e2e_workflow_demo.main([
        "--cpu", "--small", "--contrastive-epochs", "1",
        "--supervised-epochs", "1", "--workdir", str(work)])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == record

    tree = _tree("e2e_workflow_demo")
    stages = {n.args[0].value for n in ast.walk(tree)
              if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
              and n.func.id == "stage"}
    assert set(record["stages_s"]) == stages
    assert set(record) == _dict_literal_keys(
        tree, lambda n: isinstance(n, ast.Call)
        and getattr(n.func, "attr", None) == "dumps")
    assert record["backend"] == "cpu" and record["model"] == "small"
    assert record["eval_frames"] == 24
    assert set(record["scores"]) >= {"frame_accuracy", "boundary_precision",
                                     "boundary_recall"}

    theirs = str(tmp_path / "jax.csv")
    jax_segment_cli(["--cpu", str(work / "eval_game.mp4"), "--output_path",
                     theirs, "--model-dir", str(work / "models"),
                     "--model-name", "demo", "--print-every", "0"])
    assert _read(work / "eval_segments.csv") == _read(theirs)


def _jax_script_blocks(which: str):
    tree = _tree("e2e_workflow_demo")
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and node.targets[0].id == f"{which}_BLOCKS"):
            return ast.literal_eval(node.value)
    raise AssertionError(which)


def test_workflow_demo_needs_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass --cpu"):
        e2e_workflow_demo.main(["--small"])


# --- bench_full_game --------------------------------------------------------


def test_full_game_windows_and_flat_are_the_jax_functions():
    theirs = _jax_script("bench_full_game")
    rng = np.random.default_rng(3)
    for n in (0, 2, 5, 40, 127):
        t = 100.0 + np.cumsum(rng.uniform(0.05, 0.4, n))
        events = [(float(ti), 20 * (i + 1)) for i, ti in enumerate(t)]
        for n_windows in (3, 14):
            ours = bench_full_game._windows(events, 128, 100.0, n_windows)
            assert ours == theirs._windows(events, 128, 100.0, n_windows)
            assert bench_full_game._flat(ours) == theirs._flat(ours)
    flat = [{"frames": i, "fps": 100.0 + i % 3} for i in range(6)]
    steep = [{"frames": i, "fps": 100.0 * (i + 1)} for i in range(6)]
    for windows in (flat, steep, flat[:2]):
        assert bench_full_game._flat(windows) == theirs._flat(windows)


def test_full_game_record_at_300_frames(tmp_path, monkeypatch):
    """``bgr:float32`` and ``bgr:uint8_chain`` at 300 frames on the CPU:
    the JAX record's keys (but ``csv_yuv_equals_bgr``, which needs a
    yuv420 run), each mode's keys the JAX mode's, the float32 CSV JAX
    ``segment_video_file``'s, and every file in the run's directories."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    out = tmp_path / "game.json"
    monkeypatch.setenv("FULL_GAME_FRAMES", "300")
    monkeypatch.setenv("FULL_GAME_OUT", str(out))
    monkeypatch.setenv("FULL_GAME_MODES", "bgr:uint8_chain,bgr:float32")
    monkeypatch.delenv("FULL_GAME_WORKERS", raising=False)
    record = bench_full_game.main(["--cpu"])
    assert json.loads(out.read_text()) == record

    tree = _tree("bench_full_game")
    assert set(record) == _keys(tree, "record") - {"csv_yuv_equals_bgr"}
    mode_keys = _dict_literal_keys(
        tree, lambda n: isinstance(n, ast.Assign)
        and isinstance(n.targets[0], ast.Subscript)
        and n.targets[0].value.id == "runs")
    assert set(record["modes"]) == {"bgr_uint8_chain", "bgr_float32"}
    for mode in record["modes"].values():
        assert set(mode) == mode_keys
        assert mode["frames"] == 300 and mode["decode_failures"] == 0
    assert record["hardware"].startswith("cpu")
    assert record["clip"]["frames"] == 300
    assert (record["transfer"], record["precision"]) == ("bgr", "uint8_chain")
    assert sorted(os.listdir(tmp_path)) == [
        "cutdet_bench_300.mp4", "full_game_300_bgr_float32.csv",
        "full_game_300_bgr_uint8_chain.csv", "game.json"]

    theirs = str(tmp_path / "jax.csv")
    jax_segment(str(tmp_path / "cutdet_bench_300.mp4"), theirs,
                print_every=0, precision="float32", transfer="bgr")
    assert _read(bench_full_game.csv_path(300, "bgr_float32")) == \
        _read(theirs)


def test_full_game_yuv420_and_the_merge(tmp_path, monkeypatch):
    """yuv420 runs exactly where the native YUV decoder is built, and is
    recorded as skipped with its reason elsewhere; a later run at the
    same frame count keeps the earlier modes and recomputes both parity
    flags from the CSVs they left; a run at another frame count starts a
    new record and reads no CSV of the earlier clip.  (float32 modes: the
    flags compare whatever CSVs the uint8_chain keys name.)"""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    out = tmp_path / "game.json"
    monkeypatch.setenv("FULL_GAME_OUT", str(out))
    monkeypatch.setenv("FULL_GAME_FRAMES", "128")
    monkeypatch.setenv("FULL_GAME_MODES", "yuv420:float32,bgr:float32")
    yuv = native_video.yuv_available()
    first = bench_full_game.main(["--cpu"])
    mode = first["modes"]["yuv420_float32"]
    if yuv:
        assert mode["frames"] == 128 and mode["decode_failures"] == 0
        assert first["transfer"] == "yuv420"
    else:
        assert set(mode) == {"skipped"} and "YUV" in mode["skipped"]
        assert first["transfer"] == "bgr"
    assert "csv_parity_bgr" not in first

    # Stand-ins for earlier uint8_chain runs: record entries and CSVs, the
    # float32 runs' own.
    csv = bench_full_game.csv_path
    for transfer in ("bgr", "yuv420") if yuv else ("bgr",):
        first["modes"][f"{transfer}_uint8_chain"] = \
            first["modes"][f"{transfer}_float32"]
        with open(csv(128, f"{transfer}_uint8_chain"), "wb") as f:
            f.write(_read(csv(128, f"{transfer}_float32")))
    out.write_text(json.dumps(first))
    monkeypatch.setenv("FULL_GAME_MODES", "")
    merged = bench_full_game.main(["--cpu"])
    assert merged["modes"] == first["modes"]
    assert merged["csv_parity_bgr"] is True
    if yuv:
        assert merged["csv_yuv_equals_bgr"] == (
            _read(csv(128, "yuv420_float32"))
            == _read(csv(128, "bgr_float32")))
    else:
        assert "csv_yuv_equals_bgr" not in merged

    monkeypatch.setenv("FULL_GAME_FRAMES", "130")
    monkeypatch.setenv("FULL_GAME_MODES", "bgr:float32")
    other = bench_full_game.main(["--cpu"])
    assert set(other["modes"]) == {"bgr_float32"}
    assert "csv_parity_bgr" not in other
    assert other["modes"]["bgr_float32"]["frames"] == 130


# --- bench_train and profile_simclr_step ------------------------------------


def _finite(record: dict) -> None:
    for k, v in record.items():
        assert math.isfinite(v), (k, v)
        if k.endswith(("_ms", "_per_sec")):
            assert v > 0, (k, v)


def test_bench_train_keys_and_values(monkeypatch):
    monkeypatch.setattr(bench_train, "SIMCLR_BATCH", 2)
    monkeypatch.setattr(bench_train, "SIMCLR_HW", (72, 128))
    record = bench_train.main(["2", "1", "--cpu"])
    assert set(record) == _keys(_tree("bench_train"), "out")
    assert record["batch"] == 2 and record["steps"] == 1
    _finite(record)


def test_profile_simclr_step_keys_and_values(monkeypatch):
    monkeypatch.setattr(profile_simclr_step, "HW", (72, 128))
    record = profile_simclr_step.main(["2", "1", "--cpu"])
    assert set(record) == _keys(_tree("profile_simclr_step"), "out")
    assert record["batch"] == 2
    _finite(record)


def test_train_math_on_drawn_views_is_the_step():
    """The profile's ``train_math`` (the update on ready-made views) on
    the views the step draws from the same generator gives the step's
    loss, and the same parameters after it."""
    cfg = ContrastiveConfig(batch_size=2, conv_hidden_channels=8,
                            conv_layers=2)
    x = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (2, 72, 128, 3), dtype=np.uint8))
    a = init_contrastive_state(torch.Generator().manual_seed(0), cfg, CPU)
    b = init_contrastive_state(torch.Generator().manual_seed(0), cfg, CPU)
    _, ma = make_contrastive_step(cfg)(
        a, torch.Generator().manual_seed(9), x)
    views = profile_simclr_step.draw_views(
        cfg, torch.Generator().manual_seed(9), x)
    _, mb = make_contrastive_update(cfg)(b, views)
    assert ma["loss"].item() == mb["loss"].item()
    for pa, pb in zip(a.net.parameters(), b.net.parameters()):
        assert torch.equal(pa, pb)


# --- bench_decode -----------------------------------------------------------


def test_bench_decode_one_pass(tmp_path):
    clip = make_bench_clip(str(tmp_path / "c.mp4"), 32, w=96, h=64)
    got = bench_decode.run_one("cv2", clip, "1")
    assert got["frames"] == 32 and got["fps"] > 0


def test_bench_decode_main_keys(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr(bench_decode, "run_one",
                        lambda backend, clip, threads: {"frames": 8,
                                                        "fps": 10.0})
    monkeypatch.setattr(bench_decode, "run_ab",
                        lambda clip, reps=3: {"bgr_cv2": {}})
    record = bench_decode.main(["8"])
    assert set(record) == _keys(_tree("bench_decode"), "res")
    assert os.listdir(tmp_path) == ["cutdet_bench_8.mp4"]


def test_bench_decode_workers_name_only_the_port():
    for code in (bench_decode.WORKER, bench_decode.WORKER_AB):
        assert "cut_detection_tpu." not in code
        assert "cut_detection_tpu_torch." in code
        assert not re.search(r"[\"']/\w", code)  # no absolute path
        assert "jax" not in code


# --- convert_torch_checkpoint and convert_prod_net --------------------------


def _reference_pair(path) -> tuple[str, str, str]:
    """The bundled prod net written as the reference's ``.pt`` pair and
    sidecar, by the port's ``export_torch_state_dicts``."""
    os.makedirs(path, exist_ok=True)
    conv_sd, lin_sd = export_torch_state_dicts(
        load_bundle(os.path.join(PROD_NET, "init_model.npz")))
    files = (os.path.join(path, "init_model_model_params.json"),
             os.path.join(path, "init_model_classifier_conv.pt"),
             os.path.join(path, "init_model_classifier_linear.pt"))
    with open(os.path.join(PROD_NET, "init_model_model_params.json")) as f:
        sidecar = f.read()
    with open(files[0], "w") as f:
        f.write(sidecar)
    torch.save(conv_sd, files[1])
    torch.save(lin_sd, files[2])
    return files


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree)


def test_convert_torch_checkpoint_matches_jax(tmp_path):
    files = _reference_pair(tmp_path / "ref")
    ours, ours_mp = convert_torch_checkpoint(*files)
    theirs, theirs_mp = jax_convert.convert_torch_checkpoint(*files)
    a, b = dict(_leaves(ours)), dict(_leaves(theirs))
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype == np.float32, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert ours_mp.to_dict() == theirs_mp.to_dict()
    bundled = load_bundle(os.path.join(PROD_NET, "init_model.npz"))
    for k, v in _leaves(bundled):
        np.testing.assert_array_equal(a[k], v, err_msg=k)


def test_convert_torch_checkpoint_checks_the_layer_counts(tmp_path):
    files = _reference_pair(tmp_path / "ref")
    with open(files[0]) as f:
        params = json.load(f)
    params["conv_layers"] = 2
    with open(files[0], "w") as f:
        json.dump(params, f)
    with pytest.raises(ValueError, match="says 2"):
        convert_torch_checkpoint(*files)


def test_convert_prod_net_writes_the_bundle_and_sidecar(tmp_path):
    files = _reference_pair(tmp_path / "ref")
    before = {n: hashlib.sha256(_read(os.path.join(PROD_NET, n))).digest()
              for n in os.listdir(PROD_NET)}
    out = tmp_path / "out"
    convert_prod_net.main(["--reference", str(tmp_path / "ref"),
                           "--out", str(out)])
    assert sorted(os.listdir(out)) == ["init_model.npz",
                                       "init_model_model_params.json"]
    assert sorted(os.listdir(tmp_path)) == ["out", "ref"]
    after = {n: hashlib.sha256(_read(os.path.join(PROD_NET, n))).digest()
             for n in os.listdir(PROD_NET)}
    assert after == before
    _, theirs_mp = jax_convert.convert_torch_checkpoint(*files)
    theirs_mp.to_json(str(tmp_path / "jax.json"))
    assert _read(out / "init_model_model_params.json") == _read(
        tmp_path / "jax.json")
    ours = dict(_leaves(load_bundle(str(out / "init_model.npz"))))
    for k, v in _leaves(jax_convert.convert_torch_checkpoint(*files)[0]):
        np.testing.assert_array_equal(ours[k], v, err_msg=k)
    with pytest.raises(SystemExit, match="bundled net"):
        convert_prod_net.main(["--reference", str(tmp_path / "ref"),
                               "--out", PROD_NET])


# --- derive_yuv_constants ---------------------------------------------------


def test_yuv_derivation_script_verifies_exhaustively():
    """The derivation with its 2^24 sweep, run as ``tests/test_yuv.py``
    runs the JAX script, where the port's native decoder has its YUV
    entry points."""
    if not native_video.yuv_available():
        pytest.skip("native decoder with YUV entry points not built")
    out = subprocess.run(
        [sys.executable, "-m",
         "cut_detection_tpu_torch.scripts.derive_yuv_constants"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "exhaustive 2^24 check: 0 mismatching bytes" in out.stdout
    assert "shipped closed forms match all extracted tables" in out.stdout


def test_yuv_tables_are_the_jax_tables():
    from cut_detection_tpu.ops.yuv import _tables_np
    from cut_detection_tpu_torch.ops.yuv import tables_np

    ours, theirs = tables_np(), _tables_np()
    assert list(ours) == list(theirs)
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])

