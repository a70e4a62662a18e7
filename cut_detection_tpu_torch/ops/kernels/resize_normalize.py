"""Fused resize + BGR->RGB + /255 from uint8 BGR: ``csrc/resize_normalize.cu``.

Replaces the Pallas kernel ``fused_resize_normalize``
(``cut_detection_tpu/ops/pallas/preprocess_kernel.py:74``): the float
bilinear resize as ``(R_h @ plane) @ R_w`` per (frame, channel), with /255
folded into ``R_h`` (``_resize_matrices``, the same numpy recipe as
``preprocess_kernel.py:43-57``) and the channel flip in the output index.
Float bilinear, so not bit-exact with cv2 (``ops.resize`` with
``exact=True`` is).

The kernel does not run the matmuls: each row of ``R_h`` and each column
of ``R_w`` holds at most two nonzeros, which the host reads out of the
matrices once per shape (``_taps``) and keeps on the device; one thread
per output (pixel, channel) then sums two taps vertically and two
horizontally.  What bounds it on an H100: memory, ~198 MB per batch of
128 at 1280x720 -> 256x144 (see the .cu header).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cut_detection_tpu_torch.ops.kernels import _build
from cut_detection_tpu_torch.ops.resize import (
    _taps_horizontal,
    _taps_vertical,
)


@functools.lru_cache(maxsize=None)
def _resize_matrices(in_h: int, in_w: int, out_h: int, out_w: int):
    """(R_h [out_h, in_h] with /255 folded in, R_w [in_w, out_w])."""
    yl, yr, cyl, cyr, _, _ = _taps_vertical(in_h, out_h)
    xl, xr, cxl, cxr, _, _ = _taps_horizontal(in_w, out_w)
    rh = np.zeros((out_h, in_h), dtype=np.float32)
    idx = np.arange(out_h)
    # += accumulates the clamped-border case where both taps hit one row.
    np.add.at(rh, (idx, yl), cyl)
    np.add.at(rh, (idx, yr), cyr)
    rh /= 255.0
    rw = np.zeros((in_w, out_w), dtype=np.float32)
    idx = np.arange(out_w)
    np.add.at(rw, (xl, idx), cxl)
    np.add.at(rw, (xr, idx), cxr)
    return rh, rw


def _two_taps(m: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Each row of ``m`` as its <= 2 nonzero (index, weight) pairs, in
    index order, padded with (its first index, 0.0): int32 [n, 2] and
    f32 [n, 2] holding exactly the values ``m`` holds."""
    idx = np.zeros((m.shape[0], 2), np.int32)
    w = np.zeros((m.shape[0], 2), np.float32)
    for r, row in enumerate(m):
        nz = np.flatnonzero(row)
        if not 1 <= nz.size <= 2:
            raise ValueError(f"row {r} has {nz.size} taps, expected 1 or 2")
        idx[r] = nz[[0, -1]]
        w[r, :nz.size] = row[nz]
    return idx, w


@functools.lru_cache(maxsize=None)
def _taps(in_h: int, in_w: int, out_h: int, out_w: int,
          device: torch.device):
    """(row index, row weight, column index, column weight) on ``device``:
    the two taps of each row of ``R_h`` and each column of ``R_w``."""
    rh, rw = _resize_matrices(in_h, in_w, out_h, out_w)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (*_two_taps(rh), *_two_taps(rw.T)))


def resize_normalize_plain(frames_u8: torch.Tensor, out_h: int,
                           out_w: int) -> torch.Tensor:
    """Plain PyTorch version: the dense f32 ``(R_h @ plane) @ R_w`` per
    (frame, channel), then the flip.  uint8 BGR [B, H, W, 3] -> f32 RGB
    [B, out_h, out_w, 3] in [0, 1].  On CUDA the matmuls are full f32
    only while TF32 is off for them (PyTorch's default, which
    ``utils.device.strict_fp32`` keeps)."""
    _, in_h, in_w, _ = frames_u8.shape
    rh, rw = (torch.from_numpy(m).to(frames_u8.device)
              for m in _resize_matrices(in_h, in_w, out_h, out_w))
    planar = frames_u8.permute(0, 3, 1, 2).float()
    out = torch.matmul(torch.matmul(rh, planar), rw)
    return out.flip(1).permute(0, 2, 3, 1).contiguous()


def resize_normalize(frames_u8: torch.Tensor, out_h: int,
                     out_w: int) -> torch.Tensor:
    """Fused preprocess: plain version on the CPU, kernel on CUDA.

    ``frames_u8``: uint8 [B, H, W, 3] BGR NHWC.  Returns f32
    [B, out_h, out_w, 3] RGB in [0, 1].
    """
    if frames_u8.device.type == "cpu":
        return resize_normalize_plain(frames_u8, out_h, out_w)
    if frames_u8.device.type != "cuda":
        raise ValueError(f"resize_normalize: unsupported device "
                         f"{frames_u8.device}")
    if frames_u8.dim() != 4 or frames_u8.shape[3] != 3:
        raise ValueError(f"resize_normalize takes [B, H, W, 3] frames, got "
                         f"{tuple(frames_u8.shape)}")
    if out_h <= 0 or out_w <= 0:
        raise ValueError(f"resize_normalize: bad output size "
                         f"{out_h}x{out_w}")
    b, h, w, _ = frames_u8.shape
    dev = frames_u8.device
    _build.expect(frames_u8, "frames", torch.uint8, (b, h, w, 3), dev)
    out = torch.empty((b, out_h, out_w, 3), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    row_idx, row_w, col_idx, col_w = _taps(h, w, out_h, out_w, dev)
    lib = _build.library()
    rc = _build.launch(
        lib.cutdet_resize_normalize, dev, frames_u8.data_ptr(),
        row_idx.data_ptr(), row_w.data_ptr(), col_idx.data_ptr(),
        col_w.data_ptr(), out.data_ptr(), b, h, w, out_h, out_w)
    _build.check(rc, "resize_normalize launch")
    resize_normalize.launches += 1
    return out


resize_normalize.launches = 0
