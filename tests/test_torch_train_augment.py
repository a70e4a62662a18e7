"""The port's augmentation against the JAX package's, on the CPU.

Each apply function runs on parameters that the JAX package's samplers
drew (from the same keys its ``simclr_augment`` splits), on the same
numpy-seeded frames.  Tolerances, measured on the CPU and stated:

- nearest sampling (``affine_transform``, ``_composed_view`` and the
  whole pipelines): equal except at most 0.1% of the pixels, where a
  sample coordinate within an ulp of .5 rounds the other way (the cosine
  and sine of the two libraries differ by an ulp);
- bilinear sampling (``_gather_bilinear``, ``resized_crop``) and the
  jitter (``apply_color_jitter``, with and without the fast path's fixed
  contrast mean): within 1e-6.

The samplers are held to their contracts: ranges, integer translations,
the first fitting box of 10 and the center-crop fallback on crafted
draws, offsets over 0..limit inclusive, and one seed giving one stream.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cut_detection_tpu.train import augment as jax_augment
from cut_detection_tpu_torch.train import augment

B, H, W = 8, 36, 64
SIZE = (18, 32)


def _frames(seed=0, b=B, h=H, w=W):
    rng = np.random.default_rng(seed)
    # Smooth colour ramps plus noise: neighbouring pixels differ, so a
    # wrong tap shows.
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    base = np.stack([yy * 5, xx * 3, (yy + xx) * 2], -1) % 200
    noise = rng.integers(0, 56, (b, h, w, 3))
    return (base[None] + noise).astype(np.uint8)


def _jax_jitter_params(key, b):
    """The factors and orders ``jax_augment.color_jitter(key, ...)`` draws
    (its own key split, reproduced)."""
    kb, kc, ks, ko = jax.random.split(key, 4)
    fb, fc, fs = (jax.random.uniform(k, (b,), minval=0.6, maxval=1.4)
                  for k in (kb, kc, ks))
    order = jax.random.randint(ko, (b,), 0, 6)
    return tuple(torch.from_numpy(np.array(t)) for t in (fb, fc, fs, order))


def _jax_view_params(key, b, h, w):
    """The draws of ``jax_augment.simclr_augment(key, ...)`` and
    ``fast_simclr_augment(key, ...)``, as the port's ``view_params``
    returns them."""
    k1, k2, k3 = jax.random.split(key, 3)
    affine = jax_augment.affine_params(k1, b, w, h)
    crop = jax_augment.resized_crop_params(k3, b, h, w)
    to_t = lambda ts: tuple(torch.from_numpy(np.array(t)) for t in ts)
    return to_t(affine), _jax_jitter_params(k2, b), to_t(crop)


def _nearest_bar(ours, theirs):
    """Equal but at most 0.1% of the pixels (any channel 1e-6 apart)."""
    ours, theirs = np.asarray(ours, np.float32), np.asarray(theirs,
                                                            np.float32)
    assert ours.shape == theirs.shape
    off = np.abs(ours - theirs).max(axis=-1) > 1e-6
    assert off.mean() <= 1e-3, f"{off.sum()} of {off.size} pixels differ"


def test_affine_nearest_matches():
    x = _frames(1)
    angles, tx, ty, scales = jax_augment.affine_params(
        jax.random.PRNGKey(1), B, W, H)
    theirs = jax.jit(jax.vmap(
        lambda img, a, u, v, s: jax_augment.affine_transform(
            img, a, (u, v), s)))(jnp.asarray(x), angles, tx, ty, scales)
    ours = augment.affine_transform(
        torch.from_numpy(x), *(torch.from_numpy(np.array(t))
                               for t in (angles, tx, ty, scales)))
    assert ours.dtype == torch.uint8
    _nearest_bar(ours.numpy(), theirs)
    # Zero fill reaches the output (rotations and translations uncover it).
    assert (ours.numpy() == 0).all(axis=-1).any()


def test_gather_bilinear_matches():
    """Coordinates inside, on and beyond the edges (the taps clamp)."""
    rng = np.random.default_rng(2)
    img = rng.random((B, H, W, 3), dtype=np.float32)
    ys = rng.uniform(-3, H + 3, (B, 10, 12)).astype(np.float32)
    xs = rng.uniform(-3, W + 3, (B, 10, 12)).astype(np.float32)
    theirs = jax.jit(jax.vmap(jax_augment._gather_bilinear))(img, ys, xs)
    ours = augment._gather_bilinear(*map(torch.from_numpy, (img, ys, xs)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-6)


def test_resized_crop_matches():
    rng = np.random.default_rng(3)
    img = rng.random((B, H, W, 3), dtype=np.float32)
    i, j, ch, cw = jax_augment.resized_crop_params(jax.random.PRNGKey(3), B,
                                                   H, W)
    # Op by op: XLA's fused compile of it contracts products and sums
    # into fused multiply-adds, 3.2e-6 from the written sequence here.
    theirs = jax.vmap(lambda im, a, b, c, d: jax_augment.resized_crop(
        im, a, b, c, d, SIZE))(img, i, j, ch, cw)
    ours = augment.resized_crop(torch.from_numpy(img),
                                *(torch.from_numpy(np.array(t))
                                  for t in (i, j, ch, cw)), SIZE)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-6)


@pytest.mark.parametrize("fixed_mean", [False, True])
def test_color_jitter_matches(fixed_mean):
    """Every image in its drawn order: against ``color_jitter`` (which
    draws the same factors from the key), on a batch large enough that
    all 6 orders occur."""
    b = 48
    rng = np.random.default_rng(4)
    x = rng.random((b, 6, 10, 3), dtype=np.float32)
    key = jax.random.PRNGKey(5)
    params = _jax_jitter_params(key, b)
    assert set(params[3].tolist()) == set(range(6))
    mean = rng.random(b, dtype=np.float32) if fixed_mean else None
    theirs = jax.jit(jax_augment.color_jitter)(key, jnp.asarray(x),
                                               contrast_mean=mean)
    ours = augment.apply_color_jitter(
        torch.from_numpy(x), *params,
        contrast_mean=None if mean is None else torch.from_numpy(mean))
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-6)


def test_composed_view_matches():
    x = _frames(6)
    (affine, _, crop) = _jax_view_params(jax.random.PRNGKey(6), B, H, W)
    theirs = jax.jit(jax.vmap(lambda img, a, u, v, s, i, j, c, d:
                              jax_augment._composed_view(
                                  img, a, (u, v), s, i, j, c, d, SIZE)))(
        jnp.asarray(x), *(jnp.asarray(t.numpy()) for t in (*affine, *crop)))
    ours = augment._composed_view(torch.from_numpy(x), *affine, *crop, SIZE)
    _nearest_bar(ours.numpy(), theirs)


@pytest.mark.parametrize("fast", [False, True])
def test_pipelines_match(fast):
    """The whole view, affine -> jitter -> crop (or the composed path),
    on ``simclr_augment``'s (``fast_simclr_augment``'s) own draws."""
    x = _frames(7)
    key = jax.random.PRNGKey(7)
    jfn = (jax_augment.fast_simclr_augment if fast
           else jax_augment.simclr_augment)
    theirs = jfn(key, jnp.asarray(x), SIZE)
    fn = augment.fast_simclr_view if fast else augment.simclr_view
    ours = fn(torch.from_numpy(x), _jax_view_params(key, B, H, W), SIZE)
    assert ours.dtype == torch.float32 and ours.shape == (B, *SIZE, 3)
    _nearest_bar(ours.numpy(), theirs)


def test_fast_path_is_spatially_exact():
    """With the jitter at identity the composed gather equals the exact
    path bit for bit (the JAX module's claim, on the port)."""
    x = torch.from_numpy(_frames(8))
    affine, _, crop = augment.view_params(torch.Generator().manual_seed(8),
                                          B, H, W)
    identity = (torch.ones(B), torch.ones(B), torch.ones(B),
                torch.zeros(B, dtype=torch.long))
    params = (affine, identity, crop)
    torch.testing.assert_close(augment.fast_simclr_view(x, params, SIZE),
                               augment.simclr_view(x, params, SIZE),
                               rtol=0, atol=0)


# --- the samplers -----------------------------------------------------------

def test_affine_params_contract():
    gen = torch.Generator().manual_seed(9)
    angles, tx, ty, scales = augment.affine_params(gen, 4096, W, H)
    assert angles.abs().max() <= np.deg2rad(15.0) + 1e-6
    assert angles.min() < -0.2 and angles.max() > 0.2
    for t, lim in ((tx, 0.2 * W), (ty, 0.2 * H)):
        assert torch.equal(t, torch.round(t)), "translations are integers"
        assert t.abs().max() <= round(lim)
        assert t.min() == -round(lim) and t.max() == round(lim)
    assert scales.min() >= 1.0 and scales.max() < 1.4
    again = augment.affine_params(torch.Generator().manual_seed(9), 4096, W,
                                  H)
    other = augment.affine_params(torch.Generator().manual_seed(10), 4096,
                                  W, H)
    assert all(torch.equal(a, b) for a, b in zip((angles, tx, ty, scales),
                                                 again))
    assert not torch.equal(angles, other[0])


def test_color_jitter_params_contract():
    fb, fc, fs, order = augment.color_jitter_params(
        torch.Generator().manual_seed(11), 4096)
    for f in (fb, fc, fs):
        assert f.min() >= 0.6 and f.max() < 1.4
    assert order.dtype == torch.long
    assert sorted(set(order.tolist())) == list(range(6))
    assert augment.JITTER_ORDERS == ((0, 1, 2), (0, 2, 1), (1, 0, 2),
                                     (1, 2, 0), (2, 0, 1), (2, 1, 0))


def test_crop_boxes_first_fit_and_fallback():
    """Crafted draws: candidate 0 too large (area 1.3 A), candidate 1
    fits; none fits (every area 2 A) gives the center crop, for an image
    inside, above and below the ratio band; offsets span 0..limit."""
    log_r = torch.full((1, 10), np.log(1.775), dtype=torch.float32)
    area = torch.full((1, 10), 2.0)
    area[0, 1], area[0, 2] = 0.5, 0.8
    area[0, 0] = 1.3
    i, j, ch, cw = augment.crop_boxes(area, log_r, torch.zeros(1, 2), H, W)
    want_w = round(float(np.sqrt(0.5 * H * W * 1.775)))
    want_h = round(float(np.sqrt(0.5 * H * W / 1.775)))
    assert (int(cw), int(ch), int(i), int(j)) == (want_w, want_h, 0, 0)
    # The last offset is reachable: a draw just under 1.
    top = torch.full((1, 2), 1.0 - 2.0 ** -24)
    i, j, ch, cw = augment.crop_boxes(area, log_r, top, H, W)
    assert int(i) == H - int(ch) and int(j) == W - int(cw)

    none = torch.full((1, 10), 2.0)
    for h, w, want in ((36, 64, (36, 64)),      # 1.778: inside the band
                       (48, 64, (36, 64)),      # 1.333: too tall
                       (20, 64, (20, 36))):     # 3.2: too wide
        i, j, ch, cw = augment.crop_boxes(none, log_r, torch.rand(1, 2), h,
                                          w)
        fh, fw = want
        assert (int(ch), int(cw)) == (fh, fw), (h, w)
        assert (int(i), int(j)) == ((h - fh) // 2, (w - fw) // 2)


def test_resized_crop_params_contract():
    i, j, ch, cw = augment.resized_crop_params(
        torch.Generator().manual_seed(12), 4096, H, W)
    assert all(t.dtype == torch.long for t in (i, j, ch, cw))
    assert (i >= 0).all() and (j >= 0).all()
    assert (i + ch <= H).all() and (j + cw <= W).all()
    area = (ch * cw).double() / (H * W)
    assert area.min() > 0.4 and area.max() <= 1.0
    # Offsets reach both ends of their range.
    assert (i == 0).any() and (i == H - ch).any()
    again = augment.resized_crop_params(torch.Generator().manual_seed(12),
                                        4096, H, W)
    assert all(torch.equal(a, b) for a, b in zip((i, j, ch, cw), again))


@pytest.mark.parametrize("fast", [False, True])
def test_two_views_deterministic_per_seed(fast):
    fn = augment.fast_simclr_two_views if fast else augment.simclr_two_views
    x = torch.from_numpy(_frames(13, b=4))
    a = fn(torch.Generator().manual_seed(1), x, SIZE)
    b = fn(torch.Generator().manual_seed(1), x, SIZE)
    c = fn(torch.Generator().manual_seed(2), x, SIZE)
    assert a.shape == (8, *SIZE, 3) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a[:4], a[4:])  # the two views differ
    assert a.min() >= 0.0 and a.max() <= 1.0
    with pytest.raises(TypeError, match="uint8"):
        fn(torch.Generator(), x.float(), SIZE)
