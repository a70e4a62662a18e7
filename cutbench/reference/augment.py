"""Plain PyTorch reference of the SimCLR views.

The published pipeline (play4honor/Cut-Detection ``learn_contrasts.py``,
torchvision 0.10): RandomAffine(+-15 deg, translate 0.2, scale 1-1.4,
nearest, zero fill) -> ColorJitter(0.4, 0.4, 0.4) ->
RandomResizedCrop((144, 256), scale (0.5, 1), ratio (1.77, 1.78),
bilinear).  Each view's parameters are drawn for the whole batch from a
CPU ``torch.Generator`` in this order: the affine's angle, x and y
translation and scale; the jitter's three factors and each image's order
of the three ops; the crop's 10 candidate areas and log aspect ratios an
image and two offset uniforms.  Given the same generator state the
benchmark's reference and the program see the same draws; everything
after the draws is worked out here.
"""

from __future__ import annotations

import math

import torch

OUT = (144, 256)
ORDERS = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))
GRAY = (0.2989, 0.587, 0.114)


def _u(gen, shape, lo, hi):
    return torch.empty(shape).uniform_(lo, hi, generator=gen)


def draw(gen: torch.Generator, b: int, h: int, w: int) -> dict:
    """One view's parameters for a batch of ``b`` images of ``h`` x ``w``."""
    angle = _u(gen, b, -15.0, 15.0) * (math.pi / 180.0)
    tx = torch.round(_u(gen, b, -0.2 * w, 0.2 * w))
    ty = torch.round(_u(gen, b, -0.2 * h, 0.2 * h))
    scale = _u(gen, b, 1.0, 1.4)
    factors = torch.stack([_u(gen, b, 0.6, 1.4) for _ in range(3)], dim=1)
    order = torch.randint(0, 6, (b,), generator=gen)
    area = _u(gen, (b, 10), 0.5, 1.0)
    log_ratio = _u(gen, (b, 10), math.log(1.77), math.log(1.78))
    offset = torch.rand((b, 2), generator=gen)
    return {"angle": angle, "tx": tx, "ty": ty, "scale": scale,
            "factors": factors, "order": order,
            "box": _boxes(area, log_ratio, offset, h, w)}


def _boxes(area, log_ratio, offset, h, w):
    """RandomResizedCrop's box: the first of the 10 candidates that fits,
    with offsets uniform over every position; else the centre crop."""
    rows = []
    for a_row, r_row, off in zip(area.tolist(), log_ratio.tolist(),
                                 offset.double().tolist()):
        box = None
        for a, r in zip(a_row, r_row):
            target = torch.tensor(a, dtype=torch.float32) * float(h * w)
            aspect = torch.exp(torch.tensor(r, dtype=torch.float32))
            cw = int(torch.round(torch.sqrt(target * aspect)))
            ch = int(torch.round(torch.sqrt(target / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                i = min(int(off[0] * (h - ch + 1)), h - ch)
                j = min(int(off[1] * (w - cw + 1)), w - cw)
                box = (i, j, ch, cw)
                break
        if box is None:
            ratio = w / h
            if ratio < 1.77:
                cw, ch = w, int(round(w / 1.77))
            elif ratio > 1.78:
                cw, ch = int(round(h * 1.78)), h
            else:
                cw, ch = w, h
            box = ((h - ch) // 2, (w - cw) // 2, ch, cw)
        rows.append(box)
    return torch.tensor(rows, dtype=torch.int64)


def _affine(x_u8, prm):
    """Nearest-neighbour inverse mapping about the image centre, zero
    outside; uint8 in and out."""
    b, h, w, _ = x_u8.shape
    dev = x_u8.device
    col = lambda t: t.to(dev, torch.float32).reshape(b, 1, 1)  # noqa: E731
    cos, sin = col(torch.cos(prm["angle"])), col(torch.sin(prm["angle"]))
    inv = col(1.0 / prm["scale"])
    tx, ty = col(prm["tx"]), col(prm["ty"])
    yy = torch.arange(h, dtype=torch.float32, device=dev).reshape(1, h, 1)
    xx = torch.arange(w, dtype=torch.float32, device=dev).reshape(1, 1, w)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    xr = (xx - cx) - tx
    yr = (yy - cy) - ty
    xs = torch.round((cos * xr + sin * yr) * inv + cx).long()
    ys = torch.round((-sin * xr + cos * yr) * inv + cy).long()
    inside = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    n = torch.arange(b, device=dev).reshape(b, 1, 1)
    out = x_u8[n, ys.clamp(0, h - 1), xs.clamp(0, w - 1)]
    return out * inside[..., None].to(out.dtype)


def _jitter(x, prm):
    """Brightness, contrast, saturation, each image in its own order; each
    op blends toward 0, the mean gray or the gray and clips to [0, 1]."""
    b = x.shape[0]
    dev = x.device
    factors = prm["factors"].to(dev)
    steps = torch.tensor(ORDERS, device=dev)[prm["order"].to(dev)]
    wr, wg, wb = GRAY
    for k in range(3):
        op = steps[:, k]
        f = factors[torch.arange(b, device=dev), op].reshape(b, 1, 1, 1)
        gray = wr * x[..., 0] + wg * x[..., 1] + wb * x[..., 2]
        mean = gray.mean(dim=(1, 2)).reshape(b, 1, 1)
        sel = op.reshape(b, 1, 1)
        ref = torch.where(sel == 0, torch.zeros_like(gray),
                          torch.where(sel == 1, mean.expand_as(gray), gray))
        x = torch.clamp(x * f + (1 - f) * ref[..., None], 0.0, 1.0)
    return x


def _axis(start, length, n, dev):
    """Sample positions of one axis of a box resized to ``n``: pixel
    centres, clamped to the box; [B, n]."""
    centres = (torch.arange(n, dtype=torch.float32, device=dev) + 0.5) / \
        torch.tensor(float(n), device=dev)
    s = start.to(dev, torch.float32)[:, None]
    ln = length.to(dev, torch.float32)[:, None]
    return torch.minimum(torch.maximum(s + centres * ln - 0.5, s),
                         s + ln - 1)


def _crop(x, box):
    """Bilinear resize of each image's box to ``OUT``, taps clamped to the
    image."""
    b, h, w, _ = x.shape
    dev = x.device
    ys = _axis(box[:, 0], box[:, 2], OUT[0], dev)[:, :, None].expand(
        b, *OUT)
    xs = _axis(box[:, 1], box[:, 3], OUT[1], dev)[:, None, :].expand(
        b, *OUT)
    y0 = torch.floor(ys).long().clamp(0, h - 1)
    x0 = torch.floor(xs).long().clamp(0, w - 1)
    y1, x1 = (y0 + 1).clamp(0, h - 1), (x0 + 1).clamp(0, w - 1)
    fy = (ys - y0.float()).clamp(0, 1)[..., None]
    fx = (xs - x0.float()).clamp(0, 1)[..., None]
    n = torch.arange(b, device=dev).reshape(b, 1, 1)
    top = x[n, y0, x0] * (1 - fx) + x[n, y0, x1] * fx
    bottom = x[n, y1, x0] * (1 - fx) + x[n, y1, x1] * fx
    return top * (1 - fy) + bottom * fy


def view(x_u8: torch.Tensor, prm: dict) -> torch.Tensor:
    """uint8 NHWC RGB originals -> float32 NHWC view in [0, 1]."""
    x = _affine(x_u8, prm).float() / 255.0
    return _crop(_jitter(x, prm), prm["box"])


def two_views(gen: torch.Generator, x_u8: torch.Tensor) -> torch.Tensor:
    """The two views of a batch, concatenated along the batch, as NCHW
    network input."""
    b, h, w, _ = x_u8.shape
    views = [view(x_u8, draw(gen, b, h, w)) for _ in range(2)]
    return torch.cat(views, dim=0).permute(0, 3, 1, 2)
