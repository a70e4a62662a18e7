"""Planar YUV420 -> BGR24, exact with swscale's same-size converter.

Port of ``cut_detection_tpu/ops/yuv.py``.  The ``yuv420`` transfer
uploads the codec's 4:2:0 planes (1.5 B/px) where ``bgr`` uploads 3 B/px,
and converts on the device.  The reference's frames come from cv2's
``VideoCapture.read``, which is swscale; the native decoder is swscale
too and byte-identical to cv2, so the conversion reproduces swscale's
unscaled yuv420p -> bgr24 converter exactly (derived from, and tested
against, ``native_video.yuv420_to_bgr24_host``):

- chroma is upsampled nearest within each 2x2 luma block;
- each channel is a sum of per-plane integer tables, then clipped:
      B = clip8(ly[Y] + bu[U])
      G = clip8(ly[Y] + gu[U] + gv[V])
      R = clip8(ly[Y] + rv[V])
  with the closed forms (16.16 fixed point; ``>>`` floors, as numpy's,
  torch's int32 ``bitwise_right_shift`` and CUDA's ``>>`` on ``int`` do):
      ly[y] = (76309 * (y - 16) + 512) >> 16
      bu[u] = (132201 * (u - 128)) >> 16
      gu[u] = (-25671 * (u - 128)) >> 16
      gv[v] = (-53279 * (v - 128)) >> 16
      rv[v] = (104597 * (v - 128)) >> 16
  All 2^24 (Y, U, V) combinations agree with swscale: one 4096x4096
  image holds each once (``exhaustive_probe``).

Even dimensions only: for odd ones swscale takes its generic scaler,
whose chroma upsample interpolates; the pipeline falls back to the BGR
transfer there.  ``yuv420_to_bgr`` is the plain PyTorch version of the
kernel ``ops.kernels.yuv420_to_bgr``; ``yuv420_to_bgr_np`` its numpy
twin, the host's reference.
"""

from __future__ import annotations

import numpy as np
import torch

from cut_detection_tpu_torch.geometry import yuv420_nbytes

# Fixed-point constants (16.16) of the closed forms above.
LY_COEF, LY_ROUND = 76309, 512
BU_COEF = 132201
GU_COEF = -25671
GV_COEF = -53279
RV_COEF = 104597


def tables_np() -> dict[str, np.ndarray]:
    """The five 256-entry int64 tables of the closed forms above, by name
    (``ly``, ``bu``, ``gu``, ``gv``, ``rv``): what
    ``scripts/derive_yuv_constants`` holds against live swscale."""
    i = np.arange(256, dtype=np.int64)
    return {
        "ly": (LY_COEF * (i - 16) + LY_ROUND) >> 16,
        "bu": (BU_COEF * (i - 128)) >> 16,
        "gu": (GU_COEF * (i - 128)) >> 16,
        "gv": (GV_COEF * (i - 128)) >> 16,
        "rv": (RV_COEF * (i - 128)) >> 16,
    }


def _check_dims(h: int, w: int) -> None:
    if h % 2 or w % 2:
        raise ValueError(
            f"yuv420_to_bgr supports even dims only, got {h}x{w} "
            "(odd sizes take swscale's interpolating generic path; "
            "use the BGR transfer there)")


def pack_yuv420(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Concatenate tight planes into the flat layout the conversion takes."""
    return np.concatenate([np.ascontiguousarray(y).reshape(-1),
                           np.ascontiguousarray(u).reshape(-1),
                           np.ascontiguousarray(v).reshape(-1)])


def exhaustive_probe() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(Y, U, V) planes of one 4096x4096 image holding every (Y, U, V)
    combination once: each 2x2 luma block shares one (U, V) pair, and
    its four Y values are a base and base + 1, + 2, + 3, the base
    stepping by 4 over the 64 tiles of 256x256 chroma pairs
    (``scripts/derive_yuv_constants.py``'s probe)."""
    cu, cv = np.meshgrid(np.arange(256, dtype=np.uint8),
                         np.arange(256, dtype=np.uint8), indexing="ij")
    u = np.tile(cu, (8, 8))
    v = np.tile(cv, (8, 8))
    bi, bj = np.meshgrid(np.arange(2048), np.arange(2048), indexing="ij")
    base = (((bi // 256) * 8 + (bj // 256)) * 4).astype(np.uint8)
    y = np.empty((4096, 4096), np.uint8)
    y[0::2, 0::2] = base
    y[0::2, 1::2] = base + 1
    y[1::2, 0::2] = base + 2
    y[1::2, 1::2] = base + 3
    return y, u, v


def yuv420_to_bgr(yuv_flat: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """uint8 ``[B, yuv420_nbytes(h, w)]`` planar YUV420 -> uint8
    ``[B, h, w, 3]`` BGR, in int32 on ``yuv_flat``'s device.

    The chroma terms are computed per chroma sample and then upsampled,
    which is the same arithmetic as upsampling first.
    """
    _check_dims(h, w)
    if yuv_flat.dim() != 2 or yuv_flat.shape[1] != yuv420_nbytes(h, w):
        raise ValueError(f"yuv420_to_bgr takes [B, {yuv420_nbytes(h, w)}] "
                         f"at {h}x{w}, got {tuple(yuv_flat.shape)}")
    ch, cw = h // 2, w // 2
    ysz, csz = h * w, ch * cw
    x = yuv_flat.to(torch.int32)
    y = x[:, :ysz].reshape(-1, h, w)
    u = x[:, ysz:ysz + csz].reshape(-1, ch, cw) - 128
    v = x[:, ysz + csz:].reshape(-1, ch, cw) - 128
    ly = (LY_COEF * (y - 16) + LY_ROUND) >> 16

    def up(c):
        return c.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)

    b = ly + up((BU_COEF * u) >> 16)
    g = ly + up(((GU_COEF * u) >> 16) + ((GV_COEF * v) >> 16))
    r = ly + up((RV_COEF * v) >> 16)
    return torch.stack([b, g, r], dim=-1).clamp_(0, 255).to(torch.uint8)


def yuv420_to_bgr_np(yuv_flat: np.ndarray, h: int, w: int) -> np.ndarray:
    """Numpy twin of :func:`yuv420_to_bgr` (copy of the JAX package's),
    for ``[B, n]`` or one ``[n]`` vector."""
    if h % 2 or w % 2:
        raise ValueError(f"yuv420_to_bgr_np supports even dims only, "
                         f"got {h}x{w}")
    cw, ch = (w + 1) // 2, (h + 1) // 2
    ysz, csz = h * w, cw * ch
    yuv_flat = np.asarray(yuv_flat)
    squeeze = yuv_flat.ndim == 1
    if squeeze:
        yuv_flat = yuv_flat[None]
    y = yuv_flat[:, :ysz].reshape(-1, h, w).astype(np.int64)
    u = yuv_flat[:, ysz:ysz + csz].reshape(-1, ch, cw).astype(np.int64)
    v = yuv_flat[:, ysz + csz:].reshape(-1, ch, cw).astype(np.int64)
    u = np.repeat(np.repeat(u, 2, axis=1), 2, axis=2)[:, :h, :w]
    v = np.repeat(np.repeat(v, 2, axis=1), 2, axis=2)[:, :h, :w]
    ly = (LY_COEF * (y - 16) + LY_ROUND) >> 16
    out = np.stack([
        np.clip(ly + ((BU_COEF * (u - 128)) >> 16), 0, 255),
        np.clip(ly + ((GU_COEF * (u - 128)) >> 16)
                + ((GV_COEF * (v - 128)) >> 16), 0, 255),
        np.clip(ly + ((RV_COEF * (v - 128)) >> 16), 0, 255),
    ], axis=-1).astype(np.uint8)
    return out[0] if squeeze else out
