"""Derive and certify ``ops/yuv.py``'s fixed-point tables from live swscale.

Port of ``scripts/derive_yuv_constants.py``, with its printed lines and
exit code.  It probes swscale's same-size yuv420p -> bgr24 converter
through the native decoder library (``native/libcutdet_decoder.so``'s
``vd_yuv420_to_bgr24``, the swscale build cv2 uses, loaded by
``data.native_video``) to:

1. confirm nearest 2x2 chroma upsampling,
2. extract the additive integer tables ly / bu / gu / gv / rv per channel,
3. fit the ``(coef * i + round) >> 16`` closed forms, print the feasible
   rounding bands and hold the extracted tables against the port's
   (``ops.yuv.tables_np``),
4. verify all 2^24 (Y, U, V) combinations against the port's numpy twin
   ``ops.yuv.yuv420_to_bgr_np`` on one 4096x4096 image
   (``ops.yuv.exhaustive_probe``).

Exit 0 means the shipped constants reproduce this swscale exactly.  It
needs the native decoder with its YUV entry points (the libav headers);
it is host work, and no card is used.

    python -m cut_detection_tpu_torch.scripts.derive_yuv_constants
"""

from __future__ import annotations

import sys

import numpy as np


class DerivationError(RuntimeError):
    """swscale no longer has the structure the shipped tables assume."""


def _check(ok, what: str) -> None:
    if not ok:
        raise DerivationError(what)


def _extract_additive(M):
    """M[c, y] = clip8(ly[y] + cc[c]); recover the integer tables."""
    cc = np.full(256, 10**9, np.int64)
    ly = np.full(256, 10**9, np.int64)
    interior = (M > 0) & (M < 255)
    cc[128] = 0
    ly[interior[128]] = M[128][interior[128]]
    for _ in range(8):
        known = ly < 10**8
        for c in range(256):
            if cc[c] < 10**8:
                m2 = interior[c] & ~known
                ly[m2] = M[c][m2] - cc[c]
            else:
                m = interior[c] & known
                if m.any():
                    cc[c] = M[c][m][0] - ly[m][0]
        known = ly < 10**8
        if known.all() and (cc < 10**8).all():
            break
    _check((ly < 10**8).all() and (cc < 10**8).all(),
           "the additive tables could not be recovered")
    _check((np.clip(ly[None, :] + cc[:, None], 0, 255) == M).all(),
           "the channel is not clip8(ly[y] + c[chroma])")
    return ly, cc


def _fit_band(table, center_coef, base_idx):
    """All (coef, round) with (coef*(i-base)+r)>>16 == table, near center."""
    i = np.arange(256)
    fits = []
    for a in range(center_coef - 60, center_coef + 61):
        base = a * (i - base_idx)
        lo = ((table << 16) - base).max()
        hi = (((table + 1) << 16) - base - 1).min()
        if lo <= hi:
            fits.append((a, int(lo), int(hi)))
    return fits


def main() -> int:
    from cut_detection_tpu_torch.data.native_video import (
        yuv420_to_bgr24_host as conv,
    )
    from cut_detection_tpu_torch.ops.yuv import (
        exhaustive_probe,
        pack_yuv420,
        tables_np,
        yuv420_to_bgr_np,
    )

    # 1. chroma upsampling: one chroma sample colours its 2x2 block.
    y = np.full((4, 4), 128, np.uint8)
    u = np.array([[0, 255], [255, 0]], np.uint8)
    v = np.full((2, 2), 128, np.uint8)
    blk = conv(y, u, v)[..., 0]
    _check((blk[:2, :2] == blk[0, 0]).all()
           and (blk[2:, 2:] == blk[2, 2]).all(),
           "chroma is not upsampled nearest within 2x2 blocks")
    print("chroma upsample: nearest 2x2 confirmed")

    # 2. per-channel table extraction from (Y x chroma) sweeps.
    Y = np.tile(np.arange(256, dtype=np.uint8), (512, 2))
    crm = np.arange(256, dtype=np.uint8)[:, None].repeat(256, 1)
    mid = np.full((256, 256), 128, np.uint8)
    oU = conv(Y, crm, mid)
    oV = conv(Y, mid, crm)
    ly_b, bu = _extract_additive(oU[::2, :256, 0].astype(np.int64))
    ly_g, gu = _extract_additive(oU[::2, :256, 1].astype(np.int64))
    ly_r, rv = _extract_additive(oV[::2, :256, 2].astype(np.int64))
    _, gv = _extract_additive(oV[::2, :256, 1].astype(np.int64))
    _check(np.array_equal(ly_b, ly_g) and np.array_equal(ly_b, ly_r),
           "the channels do not share one luma table")
    print("shared luma table confirmed; additive structure exact")

    # 3. closed forms.
    for name, tab, center, base in (("ly", ly_b + 0, 76309, 16),
                                    ("bu", bu, 132201, 128),
                                    ("gu", gu, -25671, 128),
                                    ("gv", gv, -53279, 128),
                                    ("rv", rv, 104597, 128)):
        fits = _fit_band(tab, center, base)
        print(f"{name}: feasible (coef, r_lo, r_hi) bands: {fits[:3]}"
              f"{' ...' if len(fits) > 3 else ''}")
        _check(fits, f"no affine form for {name} — swscale changed?")
    shipped = tables_np()
    for name, tab in (("ly", ly_b), ("bu", bu), ("gu", gu), ("gv", gv),
                      ("rv", rv)):
        _check(np.array_equal(shipped[name], tab),
               f"shipped {name} table no longer matches live swscale")
    print("shipped closed forms match all extracted tables")

    # 4. exhaustive 2^24 verification against the shipped numpy twin.
    py, pu, pv = exhaustive_probe()
    want = conv(py, pu, pv)
    got = yuv420_to_bgr_np(pack_yuv420(py, pu, pv), 4096, 4096)
    bad = int((got != want).sum())
    print(f"exhaustive 2^24 check: {bad} mismatching bytes")
    return 0 if bad == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
