"""Planar YUV420 -> BGR24 on the card: ``csrc/yuv420_to_bgr.cu``.

The first operation of the step under the ``yuv420`` transfer: the batch
arrives as packed planes (``[B, yuv420_nbytes(h, w)]`` uint8, half the
bytes of BGR) and leaves as ``[B, h, w, 3]`` uint8 BGR, the input of
layer 1's kernel.  The JAX package computes it in XLA
(``cut_detection_tpu/ops/yuv.py:79``, ``yuv420_to_bgr``), fused into the
step; it is no Pallas kernel.  Its plain PyTorch version
(``ops.yuv.yuv420_to_bgr``) runs a dozen int32 passes over the batch,
where the kernel reads each byte once and writes each once.  What bounds
it on an H100: memory, 21.2 MB a batch of 128 at 144x256, about 0.0063
ms at 3.35 TB/s.  A thread converts a strip of two rows by 16 pixels
(16-byte Y loads, the 8 shared chroma terms once, paired 16-bit
add-and-clamps), stages its 96 bytes in shared memory, and its warp
writes them out as contiguous 16-byte stores; a width or a base address
off 16 takes a scalar route in the same launch (see the .cu header).
At batch 128, 144x256, on an NVIDIA H100 80GB HBM3 at 700 W
(``chip_smoke.py``, calls queued behind a sleep on the card so that the
host stays ahead): 0.0069 ms a call, 0.0097 from cold L2; 0.0072 ms a
batch in the step's trace, where the first design took 0.0170.  This
wrapper takes 0.018-0.029 ms a call on the host, more than the kernel:
calls streamed back to back without that queue run at the host's pace.
Exact: integer arithmetic with the same floors as the plain version.
"""

from __future__ import annotations

import torch

from cut_detection_tpu_torch.geometry import yuv420_nbytes
from cut_detection_tpu_torch.ops.kernels import _build
from cut_detection_tpu_torch.ops.yuv import _check_dims
from cut_detection_tpu_torch.ops.yuv import (
    yuv420_to_bgr as yuv420_to_bgr_plain,
)

__all__ = ["yuv420_to_bgr", "yuv420_to_bgr_plain"]


def yuv420_to_bgr(yuv_flat: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """uint8 ``[B, yuv420_nbytes(h, w)]`` -> uint8 ``[B, h, w, 3]`` BGR:
    the plain version on the CPU, the kernel on CUDA.  Even ``h`` and
    ``w`` only (``ValueError`` otherwise, as the plain version)."""
    if yuv_flat.device.type == "cpu":
        return yuv420_to_bgr_plain(yuv_flat, h, w)
    if yuv_flat.device.type != "cuda":
        raise ValueError(f"yuv420_to_bgr: unsupported device "
                         f"{yuv_flat.device}")
    _check_dims(h, w)
    if h <= 0 or w <= 0 or yuv_flat.dim() != 2:
        raise ValueError(f"yuv420_to_bgr takes [B, n] planes at a positive "
                         f"size, got {tuple(yuv_flat.shape)} at {h}x{w}")
    b = yuv_flat.shape[0]
    dev = yuv_flat.device
    _build.expect(yuv_flat, "planes", torch.uint8,
                  (b, yuv420_nbytes(h, w)), dev)
    if yuv_flat.data_ptr() % 2:
        raise ValueError("yuv420_to_bgr: the planes must start at an even "
                         "address (the kernel reads Y in 2-byte pairs)")
    out = torch.empty((b, h, w, 3), dtype=torch.uint8, device=dev)
    if b == 0:
        return out
    rc = _build.launch(_build.library().cutdet_yuv420_to_bgr, dev,
                       yuv_flat.data_ptr(), out.data_ptr(), b, h, w)
    _build.check(rc, "yuv420_to_bgr launch")
    yuv420_to_bgr.launches += 1
    return out


yuv420_to_bgr.launches = 0
