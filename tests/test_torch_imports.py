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
import os
import subprocess
import sys
import textwrap

import pytest

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
    env = dict(os.environ,
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
