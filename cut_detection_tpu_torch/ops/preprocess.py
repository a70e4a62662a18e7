"""Device-side frame preprocessing.

Counterpart of ``cut_detection_tpu/ops/preprocess.py``.  The reference
converts each decoded frame on the host: BGR uint8 HWC -> float32 CHW ->
channel flip (BGR->RGB) -> /255 (frameID/data.py:224-228).  Here frames
cross to the card as uint8 and the flip and scale (and, with
``--device-resize``, the resize) run there.  Layout stays NHWC.
"""

from __future__ import annotations

import torch

from cut_detection_tpu_torch.ops.resize import resize_bilinear


def to_unit(frames_u8: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32 in [0, 1], ``x / 255`` as one IEEE division on
    every device (as ``x.astype(f32) / 255.0`` in the JAX package): CUDA
    divides by a Python scalar as a product with its reciprocal."""
    return frames_u8.float() / torch.tensor(255.0,
                                            device=frames_u8.device)


def normalize_frames(frames_u8_bgr: torch.Tensor) -> torch.Tensor:
    """uint8 BGR NHWC -> float32 RGB NHWC in [0, 1]: the reference's
    ``torch.flip(t.permute(2,0,1), (0,)) / 255`` in NHWC."""
    return frames_u8_bgr.flip(-1).float() / 255.0


def preprocess_u8_batch(frames_u8_bgr: torch.Tensor, out_h: int | None = None,
                        out_w: int | None = None, *,
                        exact: bool = True) -> torch.Tensor:
    """[resize ->] BGR flip -> float /255.

    With ``out_h``/``out_w`` the frames are resized first (``exact=True``
    is bit-identical to cv2's uint8 INTER_LINEAR); without them they are
    taken to be at model resolution already.
    """
    if (out_h is None) != (out_w is None):
        raise ValueError(
            f"out_h and out_w must be given together, got "
            f"out_h={out_h}, out_w={out_w}")
    x = frames_u8_bgr
    if out_h is not None:
        x = resize_bilinear(x, out_h, out_w, exact=exact)
    return normalize_frames(x)
