"""Bilinear resize with bit-exact OpenCV INTER_LINEAR (uint8) parity.

Counterpart of ``cut_detection_tpu/ops/resize.py`` on torch tensors.  The
reference resizes each decoded frame on the host with ``cv2.resize(frame,
(new_w, new_h), interpolation=cv2.INTER_LINEAR)`` (frameID/data.py:220-222);
``--device-resize`` moves that resize onto the card, so it must give the
same bytes.  The recipe, as the JAX module documents it:

- source coords ``src = float32((dst + 0.5) * (in/out) - 0.5)``;
- per-tap coefficients rounded half to even at scale 2^11;
- horizontal taps pinned at the borders, vertical taps clamp the row
  index only and keep the fractional coefficients;
- horizontal pass: int32 ``p_l*c_l + p_r*c_r``;
- vertical pass (cv2's SIMD rounding): ``t >> 4``, a 16-bit multiply-high
  ``(t * c) >> 16`` per tap, then ``(sum + 2) >> 2``.

The JAX module imports ``jax.numpy`` at its top, so the tap tables are a
numpy copy here (pinned equal to the JAX ones by
``tests/test_torch_preprocess.py``).  Plain PyTorch: the JAX package
computes this in XLA, not in a Pallas kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_COEF_BITS = 11          # OpenCV INTER_RESIZE_COEF_BITS
_COEF_SCALE = 1 << _COEF_BITS


def _src_coords(in_size: int, out_size: int) -> np.ndarray:
    """float32 half-pixel-centre source coordinates (cv2 uses float here)."""
    scale = in_size / out_size
    dst = np.arange(out_size, dtype=np.float64)
    return ((dst + 0.5) * scale - 0.5).astype(np.float32)


def _quantize(frac: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(left, right) int coefficients at scale 2^11, round half to even."""
    ql = np.rint((np.float32(1.0) - frac) * _COEF_SCALE).astype(np.int32)
    qr = np.rint(frac * _COEF_SCALE).astype(np.int32)
    return ql, qr


@functools.lru_cache(maxsize=None)
def _taps_horizontal(in_size: int, out_size: int):
    """Horizontal taps: borders pinned (cv2's HResize xmin/xmax handling).
    Returns ``(left, right, w_left, w_right, q_left, q_right)``."""
    src = _src_coords(in_size, out_size)
    left = np.floor(src).astype(np.int64)
    frac = (src - left).astype(np.float32)
    under = left < 0
    left[under] = 0
    frac[under] = 0.0
    over = left >= in_size - 1
    left[over] = max(in_size - 2, 0)
    frac[over] = 1.0
    right = np.minimum(left + 1, in_size - 1)
    ql, qr = _quantize(frac)
    return (left.astype(np.int32), right.astype(np.int32),
            (1.0 - frac).astype(np.float32), frac.astype(np.float32), ql, qr)


@functools.lru_cache(maxsize=None)
def _taps_vertical(in_size: int, out_size: int):
    """Vertical taps: row indices clamped, coefficients NOT pinned, so a
    border row blends a row with itself using fractional weights."""
    src = _src_coords(in_size, out_size)
    sy = np.floor(src).astype(np.int64)
    frac = (src - sy).astype(np.float32)
    left = np.clip(sy, 0, in_size - 1)
    right = np.clip(sy + 1, 0, in_size - 1)
    ql, qr = _quantize(frac)
    return (left.astype(np.int32), right.astype(np.int32),
            (1.0 - frac).astype(np.float32), frac.astype(np.float32), ql, qr)


def _t(a: np.ndarray, device, shape) -> torch.Tensor:
    return torch.from_numpy(a).to(device).reshape(shape)


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int, *,
                    exact: bool | None = None) -> torch.Tensor:
    """Separable bilinear resize of NHWC (or HWC) images.

    ``exact=True`` (the default for uint8) reproduces OpenCV's uint8 SIMD
    INTER_LINEAR bit for bit in int32 and returns uint8; ``exact=False``
    computes in float32 with the same taps and returns float32.

    Rows are gathered first, then columns, both on the input dtype, so a
    full-size uint8 batch is never widened: only the ``out_h`` source rows
    per tap reach int32 (the horizontal pass is per row, so the order does
    not change a value).
    """
    squeeze = x.dim() == 3
    if squeeze:
        x = x[None]
    in_h, in_w = x.shape[1], x.shape[2]
    if exact is None:
        exact = x.dtype == torch.uint8
    dev = x.device
    yl, yr, cyl, cyr, qyl, qyr = _taps_vertical(in_h, out_h)
    xl, xr, cxl, cxr, qxl, qxr = _taps_horizontal(in_w, out_w)
    xl, xr = (torch.from_numpy(a).long().to(dev) for a in (xl, xr))
    col = (1, 1, out_w, 1)
    row = (1, out_h, 1, 1)

    def rows(idx):
        return x.index_select(1, torch.from_numpy(idx).long().to(dev))

    if exact:
        def hpass(r):  # int32 at scale 2^11, <= 255 * 2048
            return (r.index_select(2, xl).int() * _t(qxl, dev, col)
                    + r.index_select(2, xr).int() * _t(qxr, dev, col))

        s0 = hpass(rows(yl)) >> 4          # <= 32640, int16 range
        s1 = hpass(rows(yr)) >> 4
        acc = (((s0 * _t(qyl, dev, row)) >> 16)
               + ((s1 * _t(qyr, dev, row)) >> 16))  # mulhi_epi16 pair
        out = ((acc + 2) >> 2).clamp_(0, 255).to(torch.uint8)
    else:
        def hpass(r):
            return (r.index_select(2, xl).float() * _t(cxl, dev, col)
                    + r.index_select(2, xr).float() * _t(cxr, dev, col))

        out = (hpass(rows(yl)) * _t(cyl, dev, row)
               + hpass(rows(yr)) * _t(cyr, dev, row))
    return out[0] if squeeze else out
