"""Mid-stack CNN block: ``csrc/conv_block.cu``.

conv3x3 (zero pad 1) + bias -> ReLU -> maxpool 3x3/3 (floor, any H) ->
eval-BN affine.  One CUDA source for two Pallas kernels:

- ``conv_block`` replaces ``fused_conv_block_pm``
  (``cut_detection_tpu/ops/pallas/fused_block_pm.py:112``), NHWC in and
  out;
- ``fused_conv_block`` replaces ``fused_conv_block``
  (``cut_detection_tpu/ops/pallas/fused_conv_block.py:130``, K4), with its
  signature and defaults: channel-major inside the kernel, bf16 or f32
  out (the ``cm_bf16`` and ``cm_f32`` instances).  The NHWC <->
  channel-major permutes its ``channel_major_in`` and ``nhwc_out`` ask
  for run in torch, where the JAX wrapper has XLA run them; a permute of
  the kernel's own output is a view, so a chain of NHWC calls copies
  only its first input.

``conv_block`` has five instances, chosen by ``compute_dtype`` (the JAX
package's precision names), ``out_dtype`` and, at ``"bfloat16_full"``,
``numerics``:

- ``f32`` (``None``): true f32 operands and accumulation — the float32
  path (layers 2 and 3 of the prod net, and layer 1 of an unfolded net);
- ``bf16_operands`` (``"bfloat16"``): the ``bfloat16`` rung's block
  (``layers.py:109-123``) — f32 input and weights rounded to bf16 as the
  kernel reads them, f32 accumulation, f32 activations never rounded;
- ``bf16_xla`` (``"bfloat16_full"``, ``numerics="xla"``): the JAX
  package's ``bfloat16_full`` rung as XLA computes it (``ops/nn.py:34-70,
  201-214``) — bf16 operands, f32 accumulation, then a bf16 rounding
  after every op: the accumulator, its sum with the bias, the BN's
  product and its sum, with the BN's ``s``, ``t`` rounded to bf16 — the
  port's layers 1 (unfolded) and 2 at that rung;
- ``bf16_xla_f32`` (the same, f32 out): XLA's numerics with the last
  rounding left out, as XLA computes the block whose BN sum it fuses into
  the head's f32 read (the compiled JAX step keeps that sum in f32) — the
  port's layer 3 at that rung;
- ``bf16_out`` (``"bfloat16_full"``, ``numerics="pallas"``): the Pallas
  kernel's numerics — bf16 operands, f32 accumulation, ``relu(acc +
  bias)`` rounded to bf16 before the pool, the BN in f32, bf16 output
  (its default ``out_dtype``) — the bench's K3 graphs.

The plain version also takes ``"bfloat16_full"`` Pallas numerics with an
f32 output (the Pallas kernel's ``out_dtype=float32``), which no path
runs and no kernel instance has.

What bounds it on an H100: see the .cu header.  The bf16-operand
instances run an implicit GEMM on the tensor cores (``wgmma``); ``f32``
runs register-blocked FMAs on the CUDA cores.

``scale`` and ``offset`` are the BN affine, computed by the caller: the
float32, ``bfloat16`` and ``bf16_xla`` paths use ``ops.nn.bn_scale_offset``
(``gamma * rsqrt``, as ``batch_norm_infer``); the Pallas kernels compute
``gamma / sqrt`` (``rsqrt=False``).

``conv_block.launches`` counts every launch of the kernel, by either
wrapper; ``conv_block.instance_launches`` counts them by instance name.
"""

from __future__ import annotations

import torch

from cut_detection_tpu_torch.ops import nn
from cut_detection_tpu_torch.ops.kernels import _build

# (compute_dtype, out_dtype, numerics) -> (instance name, dtype of x and
# kernel).  ``numerics`` names XLA's or the Pallas kernels' roundings at
# ``"bfloat16_full"`` and is None at the rungs where the two agree.
INSTANCES = {
    (None, torch.float32, None): ("f32", torch.float32),
    ("bfloat16", torch.float32, None): ("bf16_operands", torch.float32),
    ("bfloat16_full", torch.bfloat16, "xla"): ("bf16_xla", torch.bfloat16),
    ("bfloat16_full", torch.float32, "xla"): ("bf16_xla_f32",
                                              torch.bfloat16),
    ("bfloat16_full", torch.bfloat16, "pallas"): ("bf16_out",
                                                  torch.bfloat16),
}
NUMERICS = ("xla", "pallas")
# fused_conv_block's out_dtype -> its channel-major instance.
CM_INSTANCES = {torch.bfloat16: "cm_bf16", torch.float32: "cm_f32"}


def key(compute_dtype, out_dtype=torch.float32, numerics="pallas"):
    """The ``INSTANCES`` key of a combination: ``numerics`` counts only at
    ``"bfloat16_full"``."""
    if numerics not in NUMERICS:
        raise ValueError(f"numerics must be one of {NUMERICS}, got "
                         f"{numerics!r}")
    return (compute_dtype, out_dtype,
            numerics if compute_dtype == "bfloat16_full" else None)


def instance(compute_dtype, out_dtype=torch.float32, numerics="pallas"):
    """(instance name, dtype of x and kernel) of a combination; raise for
    one that has no kernel."""
    try:
        return INSTANCES[key(compute_dtype, out_dtype, numerics)]
    except KeyError:
        raise ValueError(f"conv_block has no instance for compute_dtype="
                         f"{compute_dtype!r}, out_dtype={out_dtype}, "
                         f"numerics={numerics!r}") from None


def conv_block_plain(x, kernel, bias, scale, offset, *, compute_dtype=None,
                     out_dtype=torch.float32, numerics="pallas"):
    """Plain PyTorch version: NHWC [B,H,W,Cin] -> [B, H//3, (W-3)//3+1,
    Cout] in ``out_dtype``.  With a ``compute_dtype`` the operands are
    rounded to bf16, and a product of two bf16 values is exact in f32, so
    the f32 convolution accumulates exactly what the kernel accumulates.
    At ``"bfloat16_full"`` the Pallas numerics round the post-ReLU
    activation to bf16; XLA's run the port's own ops, which round after
    every op as XLA does: ``conv2d_same``'s bf16 accumulator and bias sum,
    then the ReLU, the pool and the BN affine on bf16."""
    key(compute_dtype, out_dtype, numerics)
    if compute_dtype == "bfloat16_full" and numerics == "xla":
        z = torch.relu(nn.conv2d_same(x, kernel, bias,
                                      compute_dtype="bfloat16_full"))
        m = nn.max_pool(z, 3)
        if out_dtype == torch.bfloat16:
            return nn.bn_affine(m, scale, offset)
        # The product rounded to bf16, the sum kept in f32.
        return (m * scale.to(m.dtype)).float() + nn.bf16_round(offset)
    conv_dtype = None if compute_dtype is None else "bfloat16"
    z = torch.relu(nn.conv2d_same(x.float(), kernel.float(), bias,
                                  compute_dtype=conv_dtype))
    if compute_dtype == "bfloat16_full":
        z = nn.bf16_round(z)
    return (nn.max_pool(z, 3) * scale + offset).to(out_dtype)


def conv_block(x, kernel, bias, scale, offset, *, compute_dtype=None,
               out_dtype=torch.float32, numerics="pallas"):
    """The fused mid-stack block: plain version on the CPU, kernel on CUDA.

    ``x``: NHWC [B, H, W, Cin] (H, W >= 3) and ``kernel``: HWIO [3, 3,
    Cin, Cout], both f32, or both bf16 at ``"bfloat16_full"``; ``bias``,
    ``scale``, ``offset``: f32 [Cout].
    """
    name, dtype = instance(compute_dtype, out_dtype, numerics)
    if x.device.type == "cpu":
        return conv_block_plain(x, kernel, bias, scale, offset,
                                compute_dtype=compute_dtype,
                                out_dtype=out_dtype, numerics=numerics)
    if x.dim() != 4:
        raise ValueError(f"conv_block takes NHWC [B, H, W, C], got "
                         f"{tuple(x.shape)}")
    b, h, w, cin = x.shape
    return _launch(name, x, kernel, bias, scale, offset, dtype, out_dtype,
                   b, h, w, cin, channel_major=False)


def _launch(name, x, kernel, bias, scale, offset, dtype, out_dtype, b, h, w,
            cin, *, channel_major: bool):
    """Validate, allocate the output ([B, Hp, Wp, Cout], or [B, Cout, Hp,
    Wp] for a channel-major instance) and launch instance ``name``."""
    if x.device.type != "cuda":
        raise ValueError(f"conv_block: unsupported device {x.device}")
    if h < 3 or w < 3:
        raise ValueError(f"conv_block needs H, W >= 3, got {h}x{w}")
    cout = kernel.shape[-1]
    if cout > 128:
        raise ValueError(f"conv_block supports up to 128 output channels, "
                         f"got {cout}")
    dev = x.device
    _build.expect(x, "x", dtype,
                  (b, cin, h, w) if channel_major else (b, h, w, cin), dev)
    _build.expect(kernel, "kernel", dtype, (3, 3, cin, cout), dev)
    for pname, t in (("bias", bias), ("scale", scale), ("offset", offset)):
        _build.expect(t, pname, torch.float32, (cout,), dev)
    hp, wp = h // 3, (w - 3) // 3 + 1
    out = torch.empty((b, cout, hp, wp) if channel_major
                      else (b, hp, wp, cout), dtype=out_dtype, device=dev)
    if b == 0:
        return out
    fn = getattr(_build.library(), f"cutdet_conv_block_{name}")
    rc = _build.launch(fn, dev, x.data_ptr(), kernel.data_ptr(),
                       bias.data_ptr(), scale.data_ptr(), offset.data_ptr(),
                       out.data_ptr(), b, h, w, cin, cout)
    _build.check(rc, "conv_block launch")
    conv_block.launches += 1
    conv_block.instance_launches[name] += 1
    return out


conv_block.launches = 0
conv_block.instance_launches = {
    name: 0 for name in [n for n, _ in INSTANCES.values()]
    + list(CM_INSTANCES.values())}


def _k4_affine(gamma, beta, mean, var):
    """K4's BN affine: ``s = gamma / sqrt(var + eps)`` and ``t = beta -
    mean * s``, in f32 (``fused_conv_block.py:171-172``)."""
    return nn.bn_scale_offset(mean.float(), var.float(), gamma.float(),
                              beta.float(), rsqrt=False)


def fused_conv_block_plain(x, kernel, bias, gamma, beta, mean, var, *,
                           out_dtype=torch.bfloat16, nhwc_out: bool = True,
                           channel_major_in: bool = False):
    """Plain PyTorch version of ``fused_conv_block``: the ``bfloat16_full``
    plain block (bf16 operands, f32 accumulation, ``relu(acc + bias)``
    rounded to bf16, pool, K4's BN affine) between the layout permutes."""
    xn = x.permute(0, 2, 3, 1) if channel_major_in else x
    s, t = _k4_affine(gamma, beta, mean, var)
    out = conv_block_plain(xn.to(torch.bfloat16), kernel.to(torch.bfloat16),
                           bias.float(), s, t, compute_dtype="bfloat16_full",
                           out_dtype=out_dtype, numerics="pallas")
    return out if nhwc_out else out.permute(0, 3, 1, 2)


def fused_conv_block(x, kernel, bias, gamma, beta, mean, var, *,
                     out_dtype=torch.bfloat16, nhwc_out: bool = True,
                     channel_major_in: bool = False):
    """K4: one CNNLayer (conv + ReLU + maxpool3 + BN) for C_in >= 8, at
    ``bfloat16_full`` numerics, with the JAX wrapper's signature: plain
    version on the CPU, the kernel on CUDA.

    ``x``: NHWC [B, H, W, C_in], or channel-major [B, C_in, H, W] with
    ``channel_major_in`` (explicit: W == C_in is ambiguous), any float
    dtype (rounded to bf16); H need not divide by 3.  ``kernel``: HWIO
    [3, 3, C_in, C_out] (rounded to bf16); ``bias``, ``gamma``, ``beta``,
    ``mean``, ``var``: [C_out].  Returns [B, H//3, (W-3)//3 + 1, C_out]
    when ``nhwc_out`` (a view of the kernel's channel-major output), else
    [B, C_out, H//3, (W-3)//3 + 1], in ``out_dtype`` (bf16 or f32).
    """
    if out_dtype not in CM_INSTANCES:
        raise ValueError(f"fused_conv_block has no instance for out_dtype="
                         f"{out_dtype}")
    if x.dim() != 4:
        raise ValueError(f"fused_conv_block takes a 4-d x, got "
                         f"{tuple(x.shape)}")
    cin = kernel.shape[2]
    if x.shape[1 if channel_major_in else 3] != cin:
        raise ValueError(f"x {tuple(x.shape)} does not have C_in={cin} "
                         f"({'channel-major' if channel_major_in else 'NHWC'})")
    if cin < 8:
        raise ValueError(f"fused_conv_block needs C_in >= 8, got {cin}")
    if x.device.type == "cpu":
        return fused_conv_block_plain(
            x, kernel, bias, gamma, beta, mean, var, out_dtype=out_dtype,
            nhwc_out=nhwc_out, channel_major_in=channel_major_in)
    xcm = (x if channel_major_in else x.permute(0, 3, 1, 2))
    xcm = xcm.to(torch.bfloat16).contiguous()
    b, _, h, w = xcm.shape
    s, t = _k4_affine(gamma, beta, mean, var)
    out = _launch(CM_INSTANCES[out_dtype], xcm,
                  kernel.to(torch.bfloat16).contiguous(),
                  bias.float().contiguous(), s.contiguous(), t.contiguous(),
                  torch.bfloat16, out_dtype, b, h, w, cin,
                  channel_major=True)
    return out.permute(0, 2, 3, 1) if nhwc_out else out
