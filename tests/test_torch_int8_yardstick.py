"""``chip_smoke.py``'s int8 library yardstick, on the CPU.

On the card ``chip_smoke.i8_kernels`` times ``torch._int_mm`` of
``i8_im2col``'s GEMM beside the int8 block kernels.  These tests hold that
GEMM to the conv it stands for: its int32 sums, summed here in int64 with
numpy, equal ``ops.nn.conv2d_same_i8_plain``'s (exact) at the K the
cuBLASLt GEMM needs, 9 * Cin padded to a multiple of 8.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from cut_detection_tpu_torch.ops.nn import conv2d_same_i8_plain


@pytest.mark.parametrize("cin,h,w", [(3, 7, 10), (12, 4, 4), (48, 6, 5)])
def test_i8_im2col_gemm_equals_the_conv(cin, h, w):
    rng = np.random.default_rng(cin)
    x = torch.from_numpy(rng.integers(-128, 128, (2, h, w, cin),
                                      dtype=np.int8))
    k = torch.from_numpy(rng.integers(-127, 128, (3, 3, cin, 8),
                                      dtype=np.int8))
    cols, wmat = chip_smoke.i8_im2col(x, k)
    kk = -(-9 * cin // 8) * 8
    assert cols.shape == (2 * h * w, kk) and wmat.shape == (kk, 8)
    assert cols.dtype == wmat.dtype == torch.int8
    sums = cols.numpy().astype(np.int64) @ wmat.numpy().astype(np.int64)
    want = conv2d_same_i8_plain(x, k).reshape(-1, 8).numpy()
    np.testing.assert_array_equal(sums, want)
