"""NHWC neural-net ops with the JAX package's numerics (float32 only).

Counterpart of ``cut_detection_tpu/ops/nn.py``.  Layouts match it at every
public function so the tests compare like with like:

- activations ``[B, H, W, C]``;
- conv kernels HWIO ``[3, 3, C_in, C_out]``;
- linear weights ``[in, out]``.

Internally the convolution and pooling run on NCHW views through
``torch.nn.functional``.  Float32 on CUDA needs TF32 off
(``utils.device.strict_fp32``): the JAX package forces
``Precision.HIGHEST`` for the same reason (its ``ops/nn.py:42-58``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

# torch BatchNorm default eps (both 1d and 2d variants).
BN_EPS = 1e-5


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def conv2d_same(x, kernel, bias=None):
    """3x3 'same' convolution, NHWC x HWIO -> NHWC (zero padding 1)."""
    out = F.conv2d(_nchw(x), kernel.permute(3, 2, 0, 1), bias, padding=1)
    return _nhwc(out)


def max_pool(x, window: int = 3, stride: int | None = None):
    """Max pooling, floor mode (trailing rows/cols that don't fill a
    window are dropped), NHWC."""
    if stride is None:
        stride = window
    return _nhwc(F.max_pool2d(_nchw(x), window, stride, ceil_mode=False))


@functools.lru_cache(maxsize=None)
def _adaptive_pool_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Averaging matrix ``P[i, j] = 1/len(bin_i)`` for j in bin ``i``.

    Bin ``i`` covers ``[floor(i*in/out), ceil((i+1)*in/out))`` — bins may
    overlap (5 -> 4 reuses interior rows), as in ``AdaptiveAvgPool2d``.
    """
    mat = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        start = (i * in_size) // out_size
        end = -((-(i + 1) * in_size) // out_size)  # ceil
        mat[i, start:end] = 1.0 / (end - start)
    return mat


@functools.lru_cache(maxsize=None)
def _pool_matrix_on(in_size: int, out_size: int,
                    device: torch.device) -> torch.Tensor:
    # Cached per device: a fresh host->device copy per batch would
    # synchronise the stream every step.
    return torch.tensor(_adaptive_pool_matrix(in_size, out_size),
                        device=device)


def adaptive_avg_pool(x, out_size: int):
    """``AdaptiveAvgPool2d(out_size)`` on NHWC input, as two small matmuls
    (rows, then columns) — the matrix form of the JAX package."""
    ph = _pool_matrix_on(x.shape[1], out_size, x.device)
    pw = _pool_matrix_on(x.shape[2], out_size, x.device)
    x = torch.einsum("bhwc,oh->bowc", x, ph)
    return torch.einsum("bhwc,ow->bhoc", x, pw)


def flatten_nchw_order(x):
    """Flatten NHWC activations to ``[B, C*H*W]`` in torch's NCHW order,
    the order the linear head's weights are laid out against."""
    return _nchw(x).reshape(x.shape[0], -1)


def bn_scale_offset(mean, var, gamma, beta, eps: float = BN_EPS):
    """Eval-mode BN as an affine: ``s = gamma * rsqrt(var + eps)``,
    ``t = beta - mean * s``."""
    s = gamma * torch.rsqrt(var + eps)
    return s, beta - mean * s


def batch_norm_infer(x, mean, var, gamma, beta, eps: float = BN_EPS):
    """Eval-mode batch norm with running statistics: ``x * s + t``.
    Broadcasts over leading dims (NHWC and ``[B, F]``)."""
    s, t = bn_scale_offset(mean, var, gamma, beta, eps)
    return x * s + t


def linear(x, weight, bias=None):
    """``nn.Linear`` with weights stored ``[in, out]``."""
    out = x @ weight
    if bias is not None:
        out = out + bias
    return out
