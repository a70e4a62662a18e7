"""Build and load the port's CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles every source in ``cut_detection_tpu_torch/csrc/`` into
one shared library with a plain C interface, at first use, into
``build/cut_detection_tpu_torch/`` beside the package: one ``nvcc`` per
source, all started together, then one link.  The build is keyed
on a hash of the sources and the flags: a stale library is rebuilt, a
current one is loaded as it is.  The library is bound with ``ctypes``:
each entry point takes its pointers and the CUDA stream as ``c_void_p``
and returns ``cudaGetLastError()`` after its launch.  ``launch`` calls
one with its tensors' device current, on that device's stream.

Nothing here runs when the module is imported; a missing ``nvcc``, a
failed build or a failed load raises.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "cut_detection_tpu_torch")
LIB_NAME = "libcutdet_kernels.so"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-shared",)
BUILD_TIMEOUT_S = 900

_P = ctypes.c_void_p
_I = ctypes.c_int
# Entry point -> argument types (see the extern "C" block of each .cu).
_SIGNATURES = {
    # x, w, bias, scale, offset, out, B, H, W, Cout, stream
    "cutdet_conv1_block": [_P] * 6 + [_I] * 4 + [_P],
    "cutdet_conv1_block_bf16": [_P] * 6 + [_I] * 4 + [_P],
    "cutdet_conv1_block_bf16_xla": [_P] * 6 + [_I] * 4 + [_P],
    # x, w, bias, scale, offset, out, B, H, W, Cin, Cout, stream
    "cutdet_conv_block_f32": [_P] * 6 + [_I] * 5 + [_P],
    "cutdet_conv_block_bf16_out": [_P] * 6 + [_I] * 5 + [_P],
    "cutdet_conv_block_bf16_xla": [_P] * 6 + [_I] * 5 + [_P],
    "cutdet_conv_block_bf16_xla_f32": [_P] * 6 + [_I] * 5 + [_P],
    "cutdet_conv_block_bf16_operands": [_P] * 6 + [_I] * 5 + [_P],
    "cutdet_conv_block_cm_bf16": [_P] * 6 + [_I] * 5 + [_P],
    "cutdet_conv_block_cm_f32": [_P] * 6 + [_I] * 5 + [_P],
    # x, row_idx, row_w, col_idx, col_w, out, B, H, W, out_h, out_w, stream
    "cutdet_resize_normalize": [_P] * 6 + [_I] * 5 + [_P],
    # x, out, B, H, W, stream
    "cutdet_yuv420_to_bgr": [_P] * 2 + [_I] * 3 + [_P],
    # x, w, so, ring, scale, out, B, H, W, Cout, stream
    "cutdet_conv1_block_i8": [_P] * 6 + [_I] * 4 + [_P],
    # x, w, so, ring, scale, out, B, H, W, Cin, Cout, stream
    "cutdet_conv_block_i8": [_P] * 6 + [_I] * 5 + [_P],
    # stage, x, w, out, sink, B, stream
    "cutdet_conv1_stages": [_I] + [_P] * 4 + [_I] + [_P],
}

_lock = threading.Lock()
_lib = None


class BuildInfo:
    """What the last compile did: nvcc's wall time and output (ptxas
    register and spill report).  Empty when ``build()`` found the library
    current."""

    seconds: float = 0.0
    log: str = ""


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(SRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(SRC_DIR, "*.cuh")))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(candidate):
        return candidate
    raise RuntimeError("nvcc not found (put the CUDA toolkit's bin/ on "
                       "PATH or set CUDA_HOME)")


def _lib_path() -> str:
    return os.path.join(BUILD_DIR, LIB_NAME)


def _run_all(cmds: list[list[str]]) -> str:
    """Run ``cmds`` all at once and return their output in order; raise on
    the first that fails.  None is left running on return or on raise."""
    deadline = time.monotonic() + BUILD_TIMEOUT_S
    outs = [tempfile.TemporaryFile(mode="w+", dir=BUILD_DIR) for _ in cmds]
    procs = []
    try:
        for cmd, out in zip(cmds, outs):
            procs.append(subprocess.Popen(cmd, stdout=out,
                                          stderr=subprocess.STDOUT, text=True))
        for cmd, proc, out in zip(cmds, procs, outs):
            rc = proc.wait(timeout=max(deadline - time.monotonic(), 0))
            if rc != 0:
                out.seek(0)
                raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n"
                                   f"{out.read()}")
        text = []
        for out in outs:
            out.seek(0)
            text.append(out.read())
        return "".join(text)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for out in outs:
            out.close()


def build() -> str:
    """Compile ``csrc/*.cu`` into the library unless a current one exists;
    return its path."""
    lib_path = _lib_path()
    stamp = lib_path + ".sha256"
    if os.path.isfile(lib_path) and os.path.isfile(stamp):
        with open(stamp) as f:
            if f.read().strip() == _source_hash():
                return lib_path
    return rebuild()


def rebuild() -> str:
    """Compile ``csrc/*.cu`` into the library whether or not a current one
    exists, and stamp it with the sources' hash; return its path."""
    digest = _source_hash()
    lib_path = _lib_path()
    stamp = lib_path + ".sha256"
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    srcs = [p for p in _sources() if p.endswith(".cu")]
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(src)}."
                         f"{os.getpid()}.o") for src in srcs]
    t0 = time.perf_counter()
    try:
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
                        for src, obj in zip(srcs, objs)])
        log += _run_all([[nvcc, *LINK_FLAGS, "-o", tmp, *objs]])
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    BuildInfo.seconds = time.perf_counter() - t0
    BuildInfo.log = log
    os.replace(tmp, lib_path)
    with open(stamp, "w") as f:
        f.write(digest + "\n")
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.cutdet_error_string.argtypes = [ctypes.c_int]
            lib.cutdet_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def launch(fn, device, *args) -> int:
    """``fn(*args, stream)``: a C entry point launched on ``device``'s
    current stream with ``device`` made the CUDA runtime's current device
    for the call (what ``c10::cuda::CUDAGuard`` does in C++), since the
    entry points read the SM count, set their shared-memory opt-in and
    launch on the current device.  Returns the entry point's code."""
    import torch

    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)


def expect(t, name: str, dtype, shape: tuple, device) -> None:
    """Validate a kernel argument before its pointer crosses the C ABI."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check(rc: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error."""
    if rc != 0:
        msg = library().cutdet_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")
