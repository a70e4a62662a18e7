"""Batched image augmentation on the frames' device (the SimCLR pipeline).

Counterpart of ``cut_detection_tpu/train/augment.py``.  The reference
applies torchvision transforms twice per image in host workers
(learn_contrasts.py:48-56, frameID/data.py:86-93): RandomAffine(+-15 deg,
translate 0.2, scale 1-1.4) -> ColorJitter(0.4, 0.4, 0.4) ->
RandomResizedCrop((144, 256), scale (0.5, 1), ratio (1.77, 1.78)).  Here
the host ships one uint8 batch and both views are made where the batch
lies.

Each op is split in two, as in the JAX module:

- a **sampler** draws the per-image parameters from a CPU
  ``torch.Generator`` (``affine_params``, ``color_jitter_params``,
  ``resized_crop_params``; a few floats an image);
- an **apply** function maps the batch with them on its own device
  (``affine_transform`` over ``_gather_nearest``, ``resized_crop`` over
  ``_gather_bilinear``, ``_composed_view``, ``apply_color_jitter``).  The
  angle's cosine and sine and the scale's inverse are computed beside
  the parameters, on the CPU, so one seed gives the same views on the
  CPU and on the card.

The rules are torchvision's (v0.10, the reference's pin) and the JAX
module's, parameter for parameter: angle ~ U(-d, d) degrees, rotation
about ((size - 1) / 2), translations rounded half to even to **integer**
pixels, scale ~ U(lo, hi), zero fill and nearest sampling for the affine
(``torch.round``, as ``jnp.round``); jitter factors ~ U(max(0, 1 - v), 1
+ v) applied in one of the 6 orders per image, each op torchvision's
``_blend`` clamped to [0, 1], grayscale weights (0.2989, 0.587, 0.114);
the crop's 10 tries of integer boxes (area ~ U(s_lo, s_hi) * A, log-uniform
aspect, w / h = round(sqrt(.))), the first that fits, offsets uniform over
0..limit inclusive, else the center-crop fallback, and a bilinear resample
with half-pixel centers and edge clamping to the crop box.

Documented divergences, the JAX module's own (``augment.py:44-47``): the
random stream differs (only the distributions match), and a nearest
sample coordinate within an ulp of .5 may round the other way where the
cosine, the sine or a fused multiply-add differ by an ulp.

``fast_simclr_augment`` composes the affine and the crop into one
4-tap gather at crop resolution (spatially exact), with the JAX module's
divergences from moving the jitter after the resample: the clip order,
and a contrast mean taken from the un-jittered affine image on a
stride-4 subgrid.
"""

from __future__ import annotations

import math

import torch

from cut_detection_tpu_torch.ops.preprocess import to_unit

# The 6 orders of (brightness, contrast, saturation), indexed as the JAX
# module's lax.switch branches.
JITTER_ORDERS = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1),
                 (2, 1, 0))
VIEW_SIZE = (144, 256)


# --- samplers (CPU generator) ----------------------------------------------

def _uniform(gen: torch.Generator, shape, lo: float, hi: float):
    return torch.empty(shape).uniform_(lo, hi, generator=gen)


def affine_params(gen: torch.Generator, batch: int, img_w: int, img_h: int,
                  *, degrees: float = 15.0,
                  translate: tuple[float, float] = (0.2, 0.2),
                  scale: tuple[float, float] = (1.0, 1.4)):
    """``RandomAffine.get_params``, batched: ``(angles_rad, tx, ty,
    scales)``, f32 [B] on the CPU; translations rounded to integers."""
    angles = _uniform(gen, batch, -degrees, degrees) * (math.pi / 180.0)
    max_dx = translate[0] * img_w
    max_dy = translate[1] * img_h
    tx = torch.round(_uniform(gen, batch, -max_dx, max_dx))
    ty = torch.round(_uniform(gen, batch, -max_dy, max_dy))
    scales = _uniform(gen, batch, scale[0], scale[1])
    return angles, tx, ty, scales


def color_jitter_params(gen: torch.Generator, batch: int, *,
                        brightness: float = 0.4, contrast: float = 0.4,
                        saturation: float = 0.4):
    """``ColorJitter.get_params``, batched: the brightness, contrast and
    saturation factors (f32 [B]) and each image's order, an index into
    ``JITTER_ORDERS`` (int64 [B])."""
    fb = _uniform(gen, batch, max(0.0, 1 - brightness), 1 + brightness)
    fc = _uniform(gen, batch, max(0.0, 1 - contrast), 1 + contrast)
    fs = _uniform(gen, batch, max(0.0, 1 - saturation), 1 + saturation)
    order = torch.randint(0, len(JITTER_ORDERS), (batch,), generator=gen)
    return fb, fc, fs, order


def crop_boxes(area_frac, log_ratio, offset_u, img_h: int, img_w: int, *,
               ratio: tuple[float, float] = (1.77, 1.78)):
    """The deterministic half of ``resized_crop_params``: 10 candidate
    boxes an image (``area_frac`` and ``log_ratio``, [B, 10], already in
    their ranges) and two uniforms in [0, 1) an image for the offsets
    (``offset_u``, [B, 2]) -> int64 ``(i, j, ch, cw)``.  The first
    candidate that fits wins; its offsets take every value of 0..limit
    with equal odds; with none, torchvision's center crop."""
    batch = area_frac.shape[0]
    ta = area_frac * float(img_h * img_w)
    aspect = torch.exp(log_ratio)
    ws = torch.round(torch.sqrt(ta * aspect)).long()
    hs = torch.round(torch.sqrt(ta / aspect)).long()
    valid = (0 < ws) & (ws <= img_w) & (0 < hs) & (hs <= img_h)
    first = valid.int().argmax(dim=1)  # the first True (ties: first index)
    any_valid = valid.any(dim=1)
    rows = torch.arange(batch)
    w_sel, h_sel = ws[rows, first], hs[rows, first]

    # The center-crop fallback (static given the input shape and band).
    in_ratio = img_w / img_h
    if in_ratio < ratio[0]:
        fw, fh = img_w, int(round(img_w / ratio[0]))
    elif in_ratio > ratio[1]:
        fw, fh = int(round(img_h * ratio[1])), img_h
    else:
        fw, fh = img_w, img_h
    fi, fj = (img_h - fh) // 2, (img_w - fw) // 2

    cw = torch.where(any_valid, w_sel, fw)
    ch = torch.where(any_valid, h_sel, fh)
    i_lim, j_lim = img_h - ch, img_w - cw
    i_rand = torch.minimum((offset_u[:, 0].double() * (i_lim + 1)).long(),
                           i_lim)
    j_rand = torch.minimum((offset_u[:, 1].double() * (j_lim + 1)).long(),
                           j_lim)
    i = torch.where(any_valid, i_rand, fi)
    j = torch.where(any_valid, j_rand, fj)
    return i, j, ch, cw


def resized_crop_params(gen: torch.Generator, batch: int, img_h: int,
                        img_w: int, *,
                        scale: tuple[float, float] = (0.5, 1.0),
                        ratio: tuple[float, float] = (1.77, 1.78)):
    """``RandomResizedCrop.get_params``, batched: int64 ``(i, j, ch, cw)``
    = (row, col, height, width) [B] on the CPU (``crop_boxes``)."""
    area_frac = _uniform(gen, (batch, 10), scale[0], scale[1])
    log_ratio = _uniform(gen, (batch, 10), math.log(ratio[0]),
                         math.log(ratio[1]))
    offset_u = torch.rand((batch, 2), generator=gen)
    return crop_boxes(area_frac, log_ratio, offset_u, img_h, img_w,
                      ratio=ratio)


def view_params(gen: torch.Generator, batch: int, img_h: int, img_w: int):
    """One view's ``(affine, jitter, crop)`` parameters, drawn in that
    order: both augment paths take the same draws."""
    return (affine_params(gen, batch, img_w, img_h),
            color_jitter_params(gen, batch),
            resized_crop_params(gen, batch, img_h, img_w))


# --- apply functions (the frames' device) ----------------------------------

def _col(t, device) -> torch.Tensor:
    """A per-image parameter [B] as f32 [B, 1, 1] on ``device``."""
    return torch.as_tensor(t).to(device=device,
                                 dtype=torch.float32).reshape(-1, 1, 1)


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as one IEEE division on every device: CUDA divides by a
    Python scalar as a product with its reciprocal."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def _grayscale(x):
    """ITU-R 601 luma, torchvision's rgb_to_grayscale weights."""
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    return 0.2989 * r + 0.587 * g + 0.114 * b


def _affine_coeffs(angle, tx, ty, scale, device):
    """(cos, sin, 1/scale, tx, ty), each [B, 1, 1] on ``device``, computed
    where the parameters lie."""
    angle, scale = torch.as_tensor(angle), torch.as_tensor(scale)
    return tuple(_col(t, device) for t in (
        torch.cos(angle), torch.sin(angle), 1.0 / scale, tx, ty))


def _affine_source(py, px, h: int, w: int, coeffs):
    """Source coordinates for output points ``(py, px)``: undo the
    translation, then rotate by -angle and divide by the scale about the
    ((size - 1) / 2) center (the JAX module's ``_affine_source``)."""
    cos, sin, inv, tx, ty = coeffs
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    x_rel = (px - cx) - tx
    y_rel = (py - cy) - ty
    xs = (cos * x_rel + sin * y_rel) * inv + cx
    ys = (-sin * x_rel + cos * y_rel) * inv + cy
    return ys, xs


def _affine_grid(h: int, w: int, coeffs, step: int = 1):
    """``_affine_source`` on every ``step``-th row and column of the full
    output grid: (ys, xs), [B, ceil(h/step), ceil(w/step)]."""
    dev = coeffs[0].device
    yy = torch.arange(0, h, step, dtype=torch.float32, device=dev)
    xx = torch.arange(0, w, step, dtype=torch.float32, device=dev)
    return _affine_source(yy[None, :, None], xx[None, None, :], h, w, coeffs)


def _batch_index(img, like):
    return torch.arange(img.shape[0], device=img.device).reshape(
        -1, *([1] * (like.dim() - 1)))


def _gather_nearest(img, ys, xs):
    """Nearest sample of ``img`` [B, H, W, C] at ``(ys, xs)`` [B, h, w],
    rounded half to even, zero outside; keeps the dtype (uint8 in, uint8
    out: nearest sampling commutes with the /255)."""
    h, w = img.shape[1], img.shape[2]
    yi = torch.round(ys).long()
    xi = torch.round(xs).long()
    valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
    out = img[_batch_index(img, yi), yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
    return torch.where(valid[..., None], out,
                       torch.zeros((), dtype=img.dtype, device=img.device))


def _gather_bilinear(img, ys, xs):
    """Bilinear sample of float ``img`` [B, H, W, C] at ``(ys, xs)`` [B, h,
    w], the taps clamped to the edge."""
    h, w = img.shape[1], img.shape[2]
    y0 = torch.floor(ys).long().clamp(0, h - 1)
    x0 = torch.floor(xs).long().clamp(0, w - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    x1 = (x0 + 1).clamp(0, w - 1)
    fy = (ys - y0.float()).clamp(0.0, 1.0)[..., None]
    fx = (xs - x0.float()).clamp(0.0, 1.0)[..., None]
    bi = _batch_index(img, y0)
    p00, p01 = img[bi, y0, x0], img[bi, y0, x1]
    p10, p11 = img[bi, y1, x0], img[bi, y1, x1]
    top = p00 * (1 - fx) + p01 * fx
    bot = p10 * (1 - fx) + p11 * fx
    return top * (1 - fy) + bot * fy


def affine_transform(img, angle, tx, ty, scale):
    """Rotation about the center, scale and translation of each image of
    ``img`` [B, H, W, C] with [B] parameters: nearest sampling, zero fill
    (RandomAffine's default interpolation)."""
    h, w = img.shape[1], img.shape[2]
    ys, xs = _affine_grid(h, w, _affine_coeffs(angle, tx, ty, scale,
                                               img.device))
    return _gather_nearest(img, ys, xs)


def _crop_rows(i, ch, n: int, device):
    """Sample positions of one axis of a crop box resized to ``n``:
    half-pixel centers, clamped to the box; [B, n]."""
    unit = _div(torch.arange(n, dtype=torch.float32, device=device) + 0.5,
                float(n))
    i = torch.as_tensor(i).to(device=device, dtype=torch.float32)[:, None]
    ch = torch.as_tensor(ch).to(device=device, dtype=torch.float32)[:, None]
    return torch.minimum(torch.maximum(i + unit * ch - 0.5, i), i + ch - 1)


def resized_crop(img, i, j, ch, cw, size: tuple[int, int] = VIEW_SIZE):
    """Crop box -> bilinear resize of float ``img`` [B, H, W, C]
    (align_corners=False, torchvision's ``F.resized_crop``)."""
    out_h, out_w = size
    ys = _crop_rows(i, ch, out_h, img.device)[:, :, None]
    xs = _crop_rows(j, cw, out_w, img.device)[:, None, :]
    return _gather_bilinear(img, ys.expand(-1, out_h, out_w),
                            xs.expand(-1, out_h, out_w))


def apply_color_jitter(x, fb, fc, fs, order, contrast_mean=None):
    """Brightness, contrast and saturation of float ``x`` [B, H, W, 3] in
    [0, 1], each image in its order (``JITTER_ORDERS[order]``).  Each op is
    ``clip(x * f + (1 - f) * ref, 0, 1)`` with ``ref`` 0 (brightness: the
    same value as ``clip(x * f)``), the image's mean gray (contrast) or
    its gray (saturation).  ``contrast_mean`` [B] replaces contrast's own
    mean (the fast path's)."""
    dev = x.device
    ops = torch.tensor(JITTER_ORDERS)[torch.as_tensor(order).cpu()].to(dev)
    factors = torch.stack([torch.as_tensor(f) for f in (fb, fc, fs)],
                          dim=1).to(dev, torch.float32)
    for k in range(3):
        op = ops[:, k]
        f = factors.gather(1, op[:, None]).reshape(-1, 1, 1, 1)
        gray = _grayscale(x)
        mean = (gray.mean(dim=(1, 2)) if contrast_mean is None
                else _col(contrast_mean, dev)[:, 0, 0])
        op = op.reshape(-1, 1, 1)
        ref = torch.where(op == 0, 0.0,
                          torch.where(op == 1, mean.reshape(-1, 1, 1), gray))
        x = torch.clamp(x * f + (1 - f) * ref[..., None], 0.0, 1.0)
    return x


def _composed_view(img, angle, tx, ty, scale, i, j, ch, cw,
                   size: tuple[int, int] = VIEW_SIZE):
    """Affine then resized crop of uint8 ``img`` [B, H, W, C] as one
    4-tap gather at crop resolution: the crop's bilinear taps, mapped
    through the affine and nearest-sampled from the raw pixels (spatially
    exact; each tap becomes f32 in [0, 1])."""
    h, w = img.shape[1], img.shape[2]
    out_h, out_w = size
    ry = _crop_rows(i, ch, out_h, img.device)[:, :, None]
    rx = _crop_rows(j, cw, out_w, img.device)[:, None, :]
    y0 = torch.floor(ry).long().clamp(0, h - 1)
    x0 = torch.floor(rx).long().clamp(0, w - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    x1 = (x0 + 1).clamp(0, w - 1)
    fy = (ry - y0.float()).clamp(0.0, 1.0)[..., None]
    fx = (rx - x0.float()).clamp(0.0, 1.0)[..., None]
    coeffs = _affine_coeffs(angle, tx, ty, scale, img.device)

    def tap(py, px):
        sy, sx = _affine_source(py.float(), px.float(), h, w, coeffs)
        return to_unit(_gather_nearest(img, sy, sx))

    p00, p01 = tap(y0, x0), tap(y0, x1)
    p10, p11 = tap(y1, x0), tap(y1, x1)
    top = p00 * (1 - fx) + p01 * fx
    bot = p10 * (1 - fx) + p11 * fx
    return top * (1 - fy) + bot * fy


def _check_u8(x_u8) -> None:
    if x_u8.dtype != torch.uint8:
        # Float input would be normalized twice and saturate the
        # jitter's clip.
        raise TypeError(f"augmentation takes uint8 frames, got {x_u8.dtype}")


def simclr_view(x_u8, params, size: tuple[int, int] = VIEW_SIZE):
    """The reference's transform pipeline on ``view_params``' draws:
    nearest affine on the raw uint8 frames, then f32, jitter, resized
    crop."""
    _check_u8(x_u8)
    affine, jitter, crop = params
    x = to_unit(affine_transform(x_u8, *affine))
    x = apply_color_jitter(x, *jitter)
    return resized_crop(x, *crop, size)


def fast_simclr_view(x_u8, params, size: tuple[int, int] = VIEW_SIZE):
    """The composed fast path on ``view_params``' draws: the contrast mean
    of the un-jittered affine image from a stride-4 subgrid, the composed
    gather, then the jitter."""
    _check_u8(x_u8)
    affine, jitter, crop = params
    h, w = x_u8.shape[1], x_u8.shape[2]
    ys, xs = _affine_grid(h, w, _affine_coeffs(*affine, x_u8.device), step=4)
    means = _grayscale(to_unit(_gather_nearest(x_u8, ys, xs))).mean(dim=(1, 2))
    views = _composed_view(x_u8, *affine, *crop, size)
    return apply_color_jitter(views, *jitter, contrast_mean=means)


def simclr_augment(gen: torch.Generator, x_u8,
                   size: tuple[int, int] = VIEW_SIZE):
    """One augmented view of uint8 RGB frames [B, H, W, 3] -> f32 [B,
    *size, 3], the parameters drawn from ``gen``."""
    _check_u8(x_u8)
    b, h, w = x_u8.shape[:3]
    return simclr_view(x_u8, view_params(gen, b, h, w), size)


def fast_simclr_augment(gen: torch.Generator, x_u8,
                        size: tuple[int, int] = VIEW_SIZE):
    """``simclr_augment`` through the composed gather (the same draws)."""
    _check_u8(x_u8)
    b, h, w = x_u8.shape[:3]
    return fast_simclr_view(x_u8, view_params(gen, b, h, w), size)


def simclr_two_views(gen: torch.Generator, x_u8,
                     size: tuple[int, int] = VIEW_SIZE):
    """Two independent views concatenated along the batch, [2B, ...]
    (frameID/data.py:86-93, learn_contrasts.py:105)."""
    return torch.cat([simclr_augment(gen, x_u8, size),
                      simclr_augment(gen, x_u8, size)], dim=0)


def fast_simclr_two_views(gen: torch.Generator, x_u8,
                          size: tuple[int, int] = VIEW_SIZE):
    """``simclr_two_views`` through the composed gather
    (``ContrastiveConfig.fast_augment``)."""
    return torch.cat([fast_simclr_augment(gen, x_u8, size),
                      fast_simclr_augment(gen, x_u8, size)], dim=0)
