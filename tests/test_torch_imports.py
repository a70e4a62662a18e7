"""The port imports and runs without jax.

A machine that runs the port may have no jax at all, so every module of
``cut_detection_tpu_torch`` (and ``chip_smoke.py``) is imported in a fresh
interpreter where ``import jax`` fails, and the CLI segments the golden
clip there.
"""

import ast
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCK_JAX = """
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
"""


def _run(code: str, tmp_path) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-c", _BLOCK_JAX + textwrap.dedent(code)],
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


@pytest.mark.parametrize("decode_process", ["off", "on"])
def test_port_imports_and_runs_without_jax(tmp_path, decode_process):
    """Every port module and ``chip_smoke.py`` import, and the CLI
    segments the golden clip (in-process decode, and the decode
    subprocess) byte for byte."""
    out = str(tmp_path / "out.csv")
    clip = os.path.join(REPO, "tests", "golden", "clip.mp4")
    proc = _run(f"""
        import importlib, pkgutil
        import cut_detection_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                       pkg.__name__ + ".")]
        assert len(names) >= 20, names
        for name in names:
            importlib.import_module(name)
        sys.path.insert(0, {REPO!r})
        import chip_smoke
        from cut_detection_tpu_torch.cli.segment_video import main
        main([{clip!r}, "--cpu", "--transfer", "bgr", "--output_path",
              {out!r}, "--print-every", "0",
              "--decode-process", {decode_process!r}])
        assert sys.modules["jax"] is None
    """, tmp_path)
    assert proc.returncode == 0, proc.stderr
    with open(out, "rb") as f, open(os.path.join(
            REPO, "tests", "golden", "ref_segments.csv"), "rb") as g:
        assert f.read() == g.read()
