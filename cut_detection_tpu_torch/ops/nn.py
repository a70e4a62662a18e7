"""NHWC neural-net ops with the JAX package's numerics.

Counterpart of ``cut_detection_tpu/ops/nn.py``.  Layouts match it at every
public function so the tests compare like with like:

- activations ``[B, H, W, C]``;
- conv kernels HWIO ``[3, 3, C_in, C_out]``;
- linear weights ``[in, out]``.

Internally the convolution and pooling run on NCHW views through
``torch.nn.functional``.  Float32 on CUDA needs TF32 off
(``utils.device.strict_fp32``): the JAX package forces
``Precision.HIGHEST`` for the same reason (its ``ops/nn.py:42-58``).

``compute_dtype`` follows the JAX package's precision contract
(``ops/nn.py:34-70, 248-265``): ``"bfloat16"`` and ``"bfloat16_full"``
round the operands to bf16 and accumulate in f32.  A product of two bf16
values is exact in f32, so rounding, then multiplying in f32, is what a
bf16 matrix unit with f32 accumulation computes.
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


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (nearest even), as float32."""
    return t.to(torch.bfloat16).float()


def conv2d_same(x, kernel, bias=None, *, compute_dtype=None):
    """3x3 'same' convolution, NHWC x HWIO -> NHWC (zero padding 1).

    ``compute_dtype=None``: float32 throughout.  ``"bfloat16"``: bf16
    operands, f32 accumulation and an f32 result.  ``"bfloat16_full"``:
    the same, with the accumulator rounded to bf16 and the bias added in
    bf16, as the JAX op does (a bf16 result).
    """
    if compute_dtype is not None:
        x, kernel = bf16_round(x.float()), bf16_round(kernel.float())
    full = compute_dtype == "bfloat16_full"
    out = F.conv2d(_nchw(x), kernel.permute(3, 2, 0, 1),
                   None if full else bias, padding=1)
    out = _nhwc(out)
    if full:
        out = out.to(torch.bfloat16)
        if bias is not None:
            out = out + bias.to(torch.bfloat16)
    return out


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


def bn_scale_offset(mean, var, gamma, beta, eps: float = BN_EPS, *,
                    rsqrt: bool = True):
    """Eval-mode BN as an affine: ``s = gamma * rsqrt(var + eps)``,
    ``t = beta - mean * s``.  ``rsqrt=False`` gives the Pallas kernels'
    ``s = gamma / sqrt(var + eps)`` (``fused_conv1.py:207``,
    ``fused_block_pm.py:136``)."""
    s = gamma * torch.rsqrt(var + eps) if rsqrt else gamma / torch.sqrt(
        var + eps)
    return s, beta - mean * s


def bn_affine(x, s, t):
    """``x * s + t`` with ``s`` and ``t`` (f32) cast to ``x``'s dtype
    first, as the JAX op does (``ops/nn.py:201-214``): on a bf16 ``x`` the
    product and the sum are each rounded to bf16."""
    return x * s.to(x.dtype) + t.to(x.dtype)


def batch_norm_infer(x, mean, var, gamma, beta, eps: float = BN_EPS):
    """Eval-mode batch norm with running statistics: ``x * s + t``, in
    ``x``'s dtype (``bn_affine``).  Broadcasts over leading dims (NHWC and
    ``[B, F]``)."""
    s, t = bn_scale_offset(mean, var, gamma, beta, eps)
    return bn_affine(x, s, t)


def linear(x, weight, bias=None, *, compute_dtype=None):
    """``nn.Linear`` with weights stored ``[in, out]``; an f32 result.
    With a ``compute_dtype`` the operands are rounded to bf16 first."""
    if compute_dtype is not None:
        x, weight = bf16_round(x), bf16_round(weight)
    out = x @ weight
    if bias is not None:
        out = out + bias
    return out


def quantize_kernel_i8(kernel):
    """Per-output-channel symmetric int8 weight quantization
    (``cut_detection_tpu/ops/nn.py:94-106``): ``kernel ~= k_i8 * scale``
    with ``scale = max(amax / 127, 1e-12)`` per output channel (the last
    axis), ``k_i8 = clip(rint(kernel / scale), -127, 127)``.  Both
    divisions take a tensor divisor: torch divides by a Python scalar as
    a product with its reciprocal, which is not always the quotient the
    JAX op rounds to.  Returns ``(k_i8 int8, scale f32)``."""
    kernel = kernel.float()
    amax = kernel.abs().amax(dim=tuple(range(kernel.dim() - 1)))
    scale = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-12)
    k_i8 = torch.clamp(torch.round(kernel / scale), -127.0, 127.0)
    return k_i8.to(torch.int8), scale


def conv2d_same_i8_plain(x_i8, kernel_i8):
    """3x3 'same' convolution of int8 operands with exact int32 sums, NHWC
    x HWIO -> NHWC (``cut_detection_tpu/ops/nn.py:73-91``).

    Zero-padded im2col columns ``[H*W, 9*Cin]`` against the kernel as
    ``[9*Cin, Cout]``, in float64, then cast to int32.  Every product and
    partial sum is an integer of magnitude at most ``9 * Cin * 128 * 127``
    (7,022,592 at 48 channels, below 2^24), so the result is exact in any
    summation order on either device.  ``F.conv2d`` is no substitute: on
    int8 it returns int8 (it wraps), and an f32 convolution may take a
    Winograd or FFT algorithm, which is not exact.  The columns take 72
    times the input's bytes: callers pass a few frames at a time.
    """
    b, h, w, cin = x_i8.shape
    cout = kernel_i8.shape[-1]
    # F.unfold orders a column (c, ky, kx): the kernel likewise.
    wmat = kernel_i8.permute(2, 0, 1, 3).reshape(9 * cin, cout).double()
    cols = F.unfold(_nchw(x_i8).double(), 3, padding=1)  # [B, 9*Cin, H*W]
    sums = cols.transpose(1, 2) @ wmat                    # [B, H*W, Cout]
    return sums.reshape(b, h, w, cout).to(torch.int32)
