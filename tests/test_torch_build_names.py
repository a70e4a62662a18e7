"""The kernel library's bindings against its sources, on the CPU.

``ops/kernels/_build.py`` binds each entry point by name with ``ctypes``
and an argument list of its own; nothing but a failed load on the card
would catch a name or an argument count that no longer matches the
``extern "C"`` functions of ``csrc/*.cu``.  These tests read the sources:
every bound name (and ``cutdet_error_string``) is defined exactly once,
with as many parameters as its binding passes, whether written out or
through a macro such as ``CUTDET_CONV_BLOCK(NAME, ...)``.  They also
hold ``chip_smoke.KERNEL_ROWS`` to the tree: each row's source exists and
its ``replaces`` names the ``def`` line of a Pallas kernel (a function of
``cut_detection_tpu/ops/pallas/`` whose module calls ``pl.pallas_call``)
or, for a row of ``chip_smoke.XLA_ROWS``, the ``def`` of the op the JAX
package leaves to XLA (outside ``ops/pallas/``, no ``pallas_call``).
"""

import glob
import os
import re

import pytest

import chip_smoke
from cut_detection_tpu_torch.ops.kernels import _build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXTERN = re.compile(r'extern\s+"C"\s+[\w\s\*]*?\b(\w+)\s*\(([^)]*)\)')
DEFINE = re.compile(r"^\s*#\s*define\s+(\w+)\(([^)]*)\)(.*)$", re.M)
# The library's entry points and their argument counts: the bindings, and
# the error-string helper ``library()`` binds by hand.
BOUND = {**{name: len(args) for name, args in _build._SIGNATURES.items()},
         "cutdet_error_string": 1}


def _arity(params: str) -> int:
    return len([p for p in params.split(",") if p.strip()])


def _definitions() -> dict:
    """``{name: [(file, parameter count), ...]}`` of every ``extern "C"``
    function defined in ``csrc/*.cu``, macro expansions included."""
    found = {}
    for path in sorted(glob.glob(os.path.join(_build.SRC_DIR, "*.cu"))):
        with open(path) as f:
            text = re.sub(r"//[^\n]*", "", f.read()).replace("\\\n", " ")
        macros = {}
        for m in DEFINE.finditer(text):
            ext = EXTERN.search(m.group(3))
            params = [p.strip() for p in m.group(2).split(",")]
            if ext and ext.group(1) in params:
                macros[m.group(1)] = (params.index(ext.group(1)),
                                      _arity(ext.group(2)))
        body = DEFINE.sub("", text)
        for m in EXTERN.finditer(body):
            found.setdefault(m.group(1), []).append(
                (os.path.basename(path), _arity(m.group(2))))
        for macro, (at, arity) in macros.items():
            for m in re.finditer(rf"^\s*{macro}\(([^)]*)\)", body, re.M):
                name = m.group(1).split(",")[at].strip()
                found.setdefault(name, []).append(
                    (os.path.basename(path), arity))
    return found


@pytest.mark.parametrize("name", sorted(BOUND))
def test_entry_point_defined_once_with_its_arity(name):
    defs = _definitions().get(name, [])
    assert len(defs) == 1, f"{name} is defined {len(defs)} times: {defs}"
    assert defs[0][1] == BOUND[name], (
        f"{name} takes {defs[0][1]} arguments in {defs[0][0]}, its binding "
        f"passes {BOUND[name]}")


def test_every_definition_is_bound():
    """No entry point of the sources goes unbound (a renamed binding
    would leave its old definition behind)."""
    assert set(_definitions()) == set(BOUND)


@pytest.mark.parametrize("row", chip_smoke.KERNEL_ROWS, ids=lambda r: r[0])
def test_kernel_row_source_exists(row):
    assert os.path.isfile(os.path.join(ROOT, row[2])), row[2]


@pytest.mark.parametrize("row", chip_smoke.KERNEL_ROWS, ids=lambda r: r[0])
def test_kernel_row_replaces_a_def(row):
    path, line = row[3].rsplit(":", 1)
    with open(os.path.join(ROOT, path)) as f:
        source = f.read()
    text = source.splitlines()[int(line) - 1]
    assert text.startswith("def "), f"{row[3]} is {text!r}"
    pallas = path.startswith("cut_detection_tpu/ops/pallas/") and \
        "pallas_call" in source
    assert pallas != (row[0] in chip_smoke.XLA_ROWS), row


def test_xla_rows_are_kernel_rows():
    assert set(chip_smoke.XLA_ROWS) <= {r[0] for r in chip_smoke.KERNEL_ROWS}
