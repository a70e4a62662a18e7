"""The port's on-device preprocess on the CPU, against the JAX package.

- ``ops.resize``: the tap tables equal the JAX ones; ``exact=True`` is
  bit-identical to cv2 and to the JAX function (the cases of
  ``tests/test_resize.py`` plus a seeded sweep of 10 sizes);
  ``exact=False`` is within 1e-5 of JAX (pixel values up to 255, where
  one f32 ulp is 1.5e-5: the two sum in the same order).
- ``ops.kernels.resize_normalize``: its matrices equal K5's
  ``_resize_matrices``, its two-tap tables hold exactly the matrices'
  values, and its plain version is within 1e-6 of the Pallas kernel
  ``fused_resize_normalize`` under ``pltpu.force_tpu_interpret_mode()``
  (both are dense f32 matmuls of [0, 1] values; only the order of the
  two nonzero products differs).  The CUDA kernel is held to the plain
  version on the card by ``tests/test_torch_cuda.py``.
- ``ops.preprocess``: ``normalize_frames`` and ``preprocess_u8_batch``
  equal the JAX functions exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from cut_detection_tpu.ops import preprocess as jax_preprocess
from cut_detection_tpu.ops import resize as jax_resize
from cut_detection_tpu.ops.pallas import preprocess_kernel as jax_k5
from cut_detection_tpu_torch import geometry
from cut_detection_tpu_torch.ops import preprocess, resize
from cut_detection_tpu_torch.ops.kernels import resize_normalize as k5

cv2 = pytest.importorskip("cv2")

T = torch.from_numpy

# (in_w, in_h, out_w, out_h): the cases of tests/test_resize.py.
CASES = [
    (1280, 720, 256, 144),
    (1920, 1080, 256, 144),
    (640, 360, 256, 144),
    (854, 480, 256, 143),
    (100, 77, 256, 197),
    (60, 50, 256, 144),
    (640, 360, 251, 113),
    (640, 360, 137, 77),
    (33, 17, 99, 55),
]


def _sweep(n: int = 10, seed: int = 2024):
    rng = np.random.default_rng(seed)
    return [tuple(int(v) for v in (rng.integers(8, 1400), rng.integers(8, 800),
                                   rng.integers(4, 600), rng.integers(4, 500)))
            for _ in range(n)]


SWEEP = _sweep()


def _image(in_w, in_h, batch=None):
    rng = np.random.default_rng(in_w * 31 + in_h)
    shape = (in_h, in_w, 3) if batch is None else (batch, in_h, in_w, 3)
    return rng.integers(0, 256, size=shape, dtype=np.uint8)


@pytest.mark.parametrize("in_w,in_h,out_w,out_h", CASES + SWEEP)
def test_tap_tables_match_jax(in_w, in_h, out_w, out_h):
    for ours, theirs in ((resize._taps_horizontal(in_w, out_w),
                          jax_resize._taps_horizontal(in_w, out_w)),
                         (resize._taps_vertical(in_h, out_h),
                          jax_resize._taps_vertical(in_h, out_h))):
        assert len(ours) == len(theirs) == 6
        for a, b in zip(ours, theirs):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    for a, b in zip(k5._resize_matrices(in_h, in_w, out_h, out_w),
                    jax_k5._resize_matrices(in_h, in_w, out_h, out_w)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("in_w,in_h,out_w,out_h", CASES + SWEEP)
def test_exact_resize_matches_cv2_and_jax(in_w, in_h, out_w, out_h):
    img = _image(in_w, in_h)
    ref = cv2.resize(img, (out_w, out_h), interpolation=cv2.INTER_LINEAR)
    ours = resize.resize_bilinear(T(img), out_h, out_w, exact=True)
    assert ours.dtype == torch.uint8
    np.testing.assert_array_equal(ours.numpy(), ref)
    theirs = np.asarray(jax_resize.resize_bilinear(img, out_h, out_w,
                                                   exact=True))
    np.testing.assert_array_equal(ours.numpy(), theirs)


def test_exact_resize_batched_matches_cv2():
    batch = _image(640, 360, batch=4)
    ours = resize.resize_bilinear(T(batch), 144, 256).numpy()
    assert ours.shape == (4, 144, 256, 3)
    for i in range(4):
        np.testing.assert_array_equal(
            ours[i], cv2.resize(batch[i], (256, 144),
                                interpolation=cv2.INTER_LINEAR))


@pytest.mark.parametrize("in_w,in_h,out_w,out_h", CASES[:4] + CASES[-3:])
def test_float_resize_matches_jax(in_w, in_h, out_w, out_h):
    img = _image(in_w, in_h, batch=2)
    ours = resize.resize_bilinear(T(img), out_h, out_w, exact=False)
    theirs = np.asarray(jax_resize.resize_bilinear(img, out_h, out_w,
                                                   exact=False))
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=1e-5)


def _pallas_k5(frames, out_h, out_w):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jax_k5.fused_resize_normalize(jnp.asarray(frames),
                                                        out_h, out_w))


@pytest.mark.parametrize("in_h,in_w,out_h,out_w", [(360, 640, 144, 256),
                                                   (77, 100, 55, 77)])
def test_resize_normalize_plain_matches_pallas(in_h, in_w, out_h, out_w):
    frames = np.random.default_rng(0).integers(0, 256, (2, in_h, in_w, 3),
                                               dtype=np.uint8)
    want = _pallas_k5(frames, out_h, out_w)
    got = k5.resize_normalize_plain(T(frames), out_h, out_w)
    assert got.shape == want.shape == (2, out_h, out_w, 3)
    assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_resize_normalize_channel_flip():
    """A pure-blue BGR frame comes out as (0, 0, 1) RGB, as from K5."""
    frames = np.zeros((1, 36, 64, 3), dtype=np.uint8)
    frames[..., 0] = 255
    got = k5.resize_normalize_plain(T(frames), 18, 32).numpy()
    np.testing.assert_allclose(got[..., 2], 1.0, atol=1e-5)
    np.testing.assert_allclose(got[..., :2], 0.0, atol=1e-5)
    np.testing.assert_allclose(got, _pallas_k5(frames, 18, 32), atol=1e-6)


@pytest.mark.parametrize("in_h,in_w,out_h,out_w", [
    (720, 1280, 144, 256), (360, 640, 144, 256), (77, 100, 55, 77),
    (17, 33, 55, 99), (240, 427, 143, 256)])
def test_two_taps_hold_the_matrix_values(in_h, in_w, out_h, out_w):
    """The kernel's tables rebuild ``R_h`` and ``R_w`` exactly, border
    rows whose two taps clamp to one source row included."""
    rh, rw = k5._resize_matrices(in_h, in_w, out_h, out_w)
    for m in (rh, rw.T):
        idx, w = k5._two_taps(m)
        assert idx.dtype == np.int32 and w.dtype == np.float32
        rebuilt = np.zeros_like(m)
        np.add.at(rebuilt, (np.arange(m.shape[0])[:, None], idx), w)
        np.testing.assert_array_equal(rebuilt, m)
    if out_h > in_h:  # an upscale clamps both taps of its border rows
        yl, yr = resize._taps_vertical(in_h, out_h)[:2]
        assert (yl == yr).any()


def test_resize_normalize_on_cpu_takes_the_plain_version():
    frames = T(_image(64, 36, batch=2))
    before = k5.resize_normalize.launches
    torch.testing.assert_close(k5.resize_normalize(frames, 18, 32),
                               k5.resize_normalize_plain(frames, 18, 32),
                               rtol=0, atol=0)
    assert k5.resize_normalize.launches == before == 0


def test_normalize_frames_matches_jax():
    bgr = np.random.default_rng(0).integers(0, 256, (2, 9, 11, 3),
                                            dtype=np.uint8)
    ours = preprocess.normalize_frames(T(bgr))
    assert ours.dtype == torch.float32
    np.testing.assert_array_equal(
        ours.numpy(), np.asarray(jax_preprocess.normalize_frames(bgr)))


@pytest.mark.parametrize("size,exact", [(None, True), ((144, 256), True),
                                        ((144, 256), False)])
def test_preprocess_u8_batch_matches_jax(size, exact):
    raw = np.random.default_rng(1).integers(0, 256, (2, 360, 640, 3),
                                            dtype=np.uint8)
    args = size or (None, None)
    ours = preprocess.preprocess_u8_batch(T(raw), *args, exact=exact).numpy()
    theirs = np.asarray(jax_preprocess.preprocess_u8_batch(raw, *args,
                                                           exact=exact))
    if exact:
        np.testing.assert_array_equal(ours, theirs)
    else:  # 1e-5 on pixels of 255, divided by 255
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-7)
    with pytest.raises(ValueError, match="together"):
        preprocess.preprocess_u8_batch(T(raw), 144, None)


def test_reference_resize_dims_is_the_shared_rule():
    """The port's copy of the size rule (``geometry``) gives the JAX
    package's sizes over a sweep of source sizes and targets."""
    rng = np.random.default_rng(3)
    sizes = [(1280, 720), (1920, 1080), (427, 240), (854, 480), (3, 3)]
    sizes += [tuple(int(v) for v in rng.integers(3, 4000, 2))
              for _ in range(200)]
    for w, h in sizes:
        for target in (256, 128, 97):
            assert geometry.reference_resize_dims(w, h, target) \
                == jax_resize.reference_resize_dims(w, h, target), (w, h)
    assert geometry.reference_resize_dims(1280, 720, 256) == (256, 144)
    assert geometry.reference_resize_dims(427, 240, 256) == (256, 143)
