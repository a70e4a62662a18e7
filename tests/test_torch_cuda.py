"""The port's CUDA kernels and its main path on the card.

Every test here needs a CUDA device and skips without one.  The module
imports no jax, so it runs on a machine that has none; there, skip the
repository's ``conftest.py`` (which imports jax):

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: 1e-4 for f32 block kernels against their plain versions (f32
summation order only); one bf16 ulp of the pooled activation for the
bf16 instance, since summation order may move a value across a bf16
rounding boundary; 1e-5 for the resize + normalize kernel on outputs in
[0, 1] (two-tap sums against the plain version's dense matmuls).
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from cut_detection_tpu_torch.models.assembly import (
    fold_preprocess,
    load_default_net,
)
from cut_detection_tpu_torch.ops.kernels.conv1_block import (
    conv1_block,
    conv1_block_plain,
)
from cut_detection_tpu_torch.ops.kernels.conv_block import (
    conv_block,
    conv_block_plain,
)
from cut_detection_tpu_torch.ops.kernels.resize_normalize import (
    resize_normalize,
    resize_normalize_plain,
)
from cut_detection_tpu_torch.ops.resize import resize_bilinear
from cut_detection_tpu_torch.pipeline import batch_frames, classify_batches

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
T = torch.from_numpy

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cut_detection_tpu_torch.utils.device import strict_fp32

    strict_fp32()
    return torch.device("cuda")


def _layer1_args(dev):
    net, _ = load_default_net(dev)
    _, bias, scale, offset = net.conv.conv_layers[0].kernel_args()
    kernel = (fold_preprocess(net.state_dict())
              ["conv.conv_layers.0.conv.weight"].permute(2, 3, 1, 0)
              .contiguous())
    return kernel, bias, scale, offset


def _block_args(rng, dev, cin=48, cout=48):
    k = rng.normal(0, 0.1, (3, 3, cin, cout)).astype(np.float32)
    bias = rng.normal(0, 0.1, cout).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    offset = rng.normal(0, 0.1, cout).astype(np.float32)
    return [T(a).to(dev) for a in (k, bias, scale, offset)]


@pytest.mark.parametrize("h,w", [(144, 256), (143, 256), (3, 3)])
def test_conv1_block_kernel(cuda_dev, h, w):
    x = T(np.random.default_rng(h).integers(0, 256, (4, h, w, 3),
                                            dtype=np.uint8)).to(cuda_dev)
    args = (x, *_layer1_args(cuda_dev))
    n = conv1_block.launches
    got = conv1_block(*args)
    torch.cuda.synchronize()
    assert conv1_block.launches == n + 1
    assert got.shape == (4, h // 3, (w - 3) // 3 + 1, 48)
    torch.testing.assert_close(got, conv1_block_plain(*args), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("h,w,cin", [(48, 85, 48), (16, 28, 48),
                                     (10, 9, 8), (144, 256, 3)])
@pytest.mark.parametrize("bf16", [False, True])
def test_conv_block_kernel(cuda_dev, h, w, cin, bf16):
    rng = np.random.default_rng(h)
    x = T(rng.normal(0, 1, (4, h, w, cin)).astype(np.float32)).to(cuda_dev)
    k, bias, scale, offset = _block_args(rng, cuda_dev, cin=cin)
    if bf16:
        x, k = x.to(torch.bfloat16), k.to(torch.bfloat16)
    n = conv_block.launches
    got = conv_block(x, k, bias, scale, offset, bf16=bf16)
    want = conv_block_plain(x, k, bias, scale, offset, bf16=bf16)
    torch.cuda.synchronize()
    assert conv_block.launches == n + 1
    if bf16:  # one bf16 ulp of the pooled activation m (y = m*s + t)
        bound = 2.0 ** -7 * (want - offset).abs() * 1.001 + 1e-5
        assert bool(((got - want).abs() <= bound).all())
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("in_h,in_w,out_h,out_w", [
    (720, 1280, 144, 256), (240, 427, 143, 256), (77, 100, 55, 77),
    (17, 33, 55, 99)])
def test_resize_normalize_kernel(cuda_dev, in_h, in_w, out_h, out_w):
    x = T(np.random.default_rng(in_w).integers(
        0, 256, (4, in_h, in_w, 3), dtype=np.uint8)).to(cuda_dev)
    n = resize_normalize.launches
    got = resize_normalize(x, out_h, out_w)
    torch.cuda.synchronize()
    assert resize_normalize.launches == n + 1
    assert got.shape == (4, out_h, out_w, 3)
    torch.testing.assert_close(got, resize_normalize_plain(x, out_h, out_w),
                               rtol=0, atol=1e-5)


def test_exact_resize_on_card_matches_cpu(cuda_dev):
    """The int32 cv2 emulation gives the same bytes on the card."""
    x = T(np.random.default_rng(2).integers(0, 256, (4, 720, 1280, 3),
                                            dtype=np.uint8))
    got = resize_bilinear(x.to(cuda_dev), 144, 256, exact=True)
    assert torch.equal(got.cpu(), resize_bilinear(x, 144, 256, exact=True))


def test_wrappers_reject_bad_arguments(cuda_dev):
    rng = np.random.default_rng(0)
    k, bias, scale, offset = _block_args(rng, cuda_dev)
    x = torch.zeros(2, 9, 12, 48, device=cuda_dev)
    with pytest.raises(TypeError):
        conv_block(x.double(), k, bias, scale, offset)
    with pytest.raises(ValueError):
        conv_block(x.transpose(1, 2), k, bias, scale, offset)
    with pytest.raises(ValueError):
        conv_block(x, k, bias.cpu(), scale, offset)
    with pytest.raises(TypeError):
        conv1_block(x[..., :3].contiguous(), *_layer1_args(cuda_dev))
    with pytest.raises(TypeError):
        resize_normalize(x[..., :3].contiguous(), 4, 4)
    frames = torch.zeros(2, 9, 12, 3, dtype=torch.uint8, device=cuda_dev)
    with pytest.raises(ValueError):
        resize_normalize(frames.transpose(1, 2), 4, 4)


def test_slice_on_card_matches_cpu(cuda_dev):
    """The pipeline's device loop on the card against the same loop on
    the CPU (plain versions): identical classes, conf within 1e-4, and
    one layer-1 plus two mid-stack launches per batch."""
    frames = np.random.default_rng(1).integers(0, 256, (40, 144, 256, 3),
                                               dtype=np.uint8)

    def run(dev):
        net, _ = load_default_net(dev)
        return classify_batches(batch_frames(iter(frames), 16), net,
                                batch_size=16, length=40, print_every=0)

    cpu_conf, cpu_pred, _ = run(torch.device("cpu"))
    c1, cb = conv1_block.launches, conv_block.launches
    conf, pred, stats = run(cuda_dev)
    assert stats.batches == 3
    assert (conv1_block.launches - c1, conv_block.launches - cb) == (3, 6)
    np.testing.assert_array_equal(pred, cpu_pred)
    np.testing.assert_allclose(conf, cpu_conf, rtol=0, atol=1e-4)


@pytest.mark.parametrize("pallas_preprocess", [False, True])
def test_on_device_preprocess_on_card_matches_cpu(cuda_dev,
                                                  pallas_preprocess):
    """Raw 360x640 frames resized by the step on the card against the
    same step on the CPU: identical classes, conf within 1e-4, and the
    launches per batch of each path (exact: layer 1 on uint8 plus two
    mid-stack blocks; fused: the resize kernel plus three f32 blocks)."""
    frames = np.random.default_rng(3).integers(0, 256, (40, 360, 640, 3),
                                               dtype=np.uint8)

    def run(dev):
        net, _ = load_default_net(dev)
        return classify_batches(batch_frames(iter(frames), 16), net,
                                batch_size=16, length=40, print_every=0,
                                device_resize=(144, 256),
                                pallas_preprocess=pallas_preprocess)

    cpu_conf, cpu_pred, _ = run(torch.device("cpu"))
    before = (resize_normalize.launches, conv1_block.launches,
              conv_block.launches)
    conf, pred, stats = run(cuda_dev)
    after = (resize_normalize.launches, conv1_block.launches,
             conv_block.launches)
    assert stats.batches == 3
    assert tuple(a - b for a, b in zip(after, before)) == (
        (3, 0, 9) if pallas_preprocess else (0, 3, 6))
    np.testing.assert_array_equal(pred, cpu_pred)
    np.testing.assert_allclose(conf, cpu_conf, rtol=0, atol=1e-4)


@pytest.mark.parametrize("flags", [[], ["--device-resize"],
                                   ["--device-resize", "--pallas-preprocess"]])
@pytest.mark.parametrize("clip,ref", [("clip.mp4", "ref_segments.csv"),
                                      ("clip_odd.mp4",
                                       "ref_segments_odd.csv")])
def test_cli_on_card_matches_golden_csv(cuda_dev, tmp_path, clip, ref,
                                        flags):
    if importlib.util.find_spec("cv2") is None:
        pytest.skip("needs cv2 to decode the golden clips")
    from cut_detection_tpu_torch.cli.segment_video import main

    out = str(tmp_path / "out.csv")
    main([os.path.join(GOLDEN, clip), "--transfer", "bgr", "--output_path",
          out, "--print-every", "0", *flags])
    with open(out, "rb") as f, open(os.path.join(GOLDEN, ref), "rb") as g:
        assert f.read() == g.read()
