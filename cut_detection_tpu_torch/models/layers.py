"""Building-block layers: the CNN block and the FC block.

Counterpart of ``cut_detection_tpu/models/layers.py:55-226, 283-323``.
Reference order (frameID/net.py:33-40, 62-68):

- ``ConvBlock``: conv3x3 (pad 1) -> ReLU -> maxpool 3/3 -> BatchNorm2d;
- ``FCBlock``: linear -> ReLU -> BatchNorm1d for hidden layers, linear
  alone for the final layer (net.py:164-167).

Parameters sit in ``nn.Conv2d`` / ``nn.Linear`` / ``nn.BatchNorm*``
holders so the state dict has the reference's own keys; the forward
passes never call those modules — the conv block runs one fused kernel.
Activations are NHWC, as in the JAX package.

Each block also has a train forward, ``forward_train``: differentiable
PyTorch ops (``ops.nn.conv2d_same``, ``max_pool``, ``batch_norm_train``)
that return the activation and the block's new BN running statistics,
which the caller applies (``GluedNet.apply_bn_stats``); ``init_weights``
draws the JAX package's initial values from a ``torch.Generator``.  The
train forward runs at float32 (``compute_dtype=None``) or at
``"bfloat16_full"``, the per-op bf16 contract that JAX's mixed-precision
training runs (``cut_detection_tpu/train/supervised.py:39-60``): bf16
activations, with BN statistics in f32.

``compute_dtype`` is the net's precision rung, as in the JAX blocks:
``None`` (float32), ``"bfloat16"`` (bf16 operands, f32 activations),
``"bfloat16_full"`` (bf16 operands and activations, at XLA's numerics
as the JAX rung computes them: the ``bf16_xla`` kernel instances), or
one of the
quantized rungs, which the JAX package computes in XLA and the port in
plain PyTorch (no Pallas kernel lies behind them):

- ``"uint8_pool"`` (``layers.py:95-106``): XLA's ``bfloat16_full`` conv
  (``ops.nn.conv2d_same``: the accumulator rounded to bf16, then the bias
  added in bf16), ReLU, the activation quantized to uint8 codes with a
  per-channel scale from the BN statistics, max pool on the codes (it
  commutes with the monotonic quantization), dequantize, BN, bf16 out;
- ``"uint8_chain"`` (``layers.py:178-220``): the same codes, but the
  dequantize + BN affine is not applied: it goes to the next block, whose
  conv takes the codes with the affine's scale folded into its weights and
  adds the affine's offset as an input-independent constant term, the
  *ring* (``const_conv_ring``).  ``FrameConvNet`` runs the chain;
- ``"int8_mxu"`` (``layers.py:229-280``): ``uint8_chain``'s chain with the
  codes stored as int8 (shifted by -128, the shift folded into the
  pending affine's offset) and the conv run as int8 x int8 -> int32 with
  per-output-channel weight scales (``ops.nn.quantize_kernel_i8``): the
  ``conv1_block_i8`` and ``conv_block_i8`` kernels on the card
  (``ops.kernels.conv_block_i8``).
"""

from __future__ import annotations

import torch
from torch import nn

from cut_detection_tpu_torch.ops.kernels.conv1_block import conv1_block
from cut_detection_tpu_torch.ops.kernels.conv_block import conv_block
from cut_detection_tpu_torch.ops.kernels.conv_block_i8 import (
    conv1_block_i8,
    conv_block_i8,
    quantize_pool_i8,
)
from cut_detection_tpu_torch.ops.nn import (
    BN_EPS,
    batch_norm_infer,
    batch_norm_train,
    bf16_round,
    bn_scale_offset,
    conv2d_same,
    linear,
    max_pool,
    quantize_kernel_i8,
)

# The reference's max-pool window and stride (frameID/net.py:90-120); the
# ring walk of assembly.precompute_rings steps the shapes with it.
POOL_WINDOW = 3
# The compute dtypes of the train forward: float32, and the bf16 mixed
# precision that TrainConfig(compute_dtype="bfloat16") selects.
TRAIN_DTYPES = (None, "bfloat16_full")


@torch.no_grad()
def _init_uniform(t: torch.Tensor, fan_in: int, generator) -> None:
    """U(+-1/sqrt(fan_in)) from ``generator`` (a CPU ``torch.Generator``),
    torch's default Conv2d / Linear bound for weights and biases and the
    JAX package's (``layers.py:55-75, 283-300``)."""
    bound = (1.0 / fan_in) ** 0.5
    t.copy_(torch.empty(t.shape).uniform_(-bound, bound, generator=generator))


@torch.no_grad()
def _init_bn(bn) -> None:
    """gamma 1, beta 0, running mean 0 and variance 1."""
    bn.weight.fill_(1.0)
    bn.bias.zero_()
    bn.running_mean.zero_()
    bn.running_var.fill_(1.0)
    bn.num_batches_tracked.zero_()


def _check_train_dtype(compute_dtype) -> None:
    if compute_dtype not in TRAIN_DTYPES:
        raise ValueError(f"a block trains at float32 or bfloat16_full, not "
                         f"{compute_dtype!r}")


def conv_quantize_scale(mean, var):
    """Per-channel uint8 scale of a block's post-ReLU activation, from the
    checkpoint's BN running statistics: ``(mean + 8 sigma) / 255`` covers
    the pre-pool distribution's tail, so no calibration pass is needed."""
    # Rounded as XLA rounds it, one f32 operation at a time: the square
    # root taken in f64 and rounded once (torch's vectorised f32 sqrt on
    # the CPU is not always correctly rounded), and a tensor divisor
    # (torch divides by a Python scalar as a product with its reciprocal).
    # Either would put a channel's scale one ulp off.
    mean, var = mean.float(), var.float()
    sigma = torch.sqrt((var + BN_EPS).double()).float()
    scale = (mean + 8.0 * sigma) / torch.full_like(mean, 255.0)
    return torch.clamp(scale, min=1e-12)


def quantize_pool_u8(z, scale):
    """f32 post-ReLU activation -> uint8 codes ``clip(rint(z / scale), 0,
    255)``, max-pooled.  ``torch.round`` rounds half to even, as
    ``jnp.rint``; the codes are pooled as exact f32 integers."""
    q = torch.clamp(torch.round(z / scale), 0.0, 255.0)
    return max_pool(q, POOL_WINDOW).to(torch.uint8)


def const_conv_ring(b, kernel, bias, h: int, w: int,
                    compute_dtype="bfloat16_full"):
    """``conv2d_same(b * 1[1, h, w, :], kernel, bias)`` without the full
    canvas: for a 3x3 'same' conv of a constant canvas every interior row
    is the same, only the top and bottom rows see the zero padding, so a
    3-row strip and a broadcast of its middle row are exact (each element
    is the same dot product over the same taps).  The full canvas for
    ``h < 3`` or a kernel other than 3x3.  Returns ``[1, h, w, C_out]``."""
    c_in = b.shape[0]

    def canvas(rows):
        return b.reshape(1, 1, 1, c_in).expand(1, rows, w, c_in)

    if h < 3 or kernel.shape[0] != 3 or kernel.shape[1] != 3:
        return conv2d_same(canvas(h), kernel, bias,
                           compute_dtype=compute_dtype)
    strip = conv2d_same(canvas(3), kernel, bias, compute_dtype=compute_dtype)
    mid = strip[:, 1:2].expand(1, h - 2, w, strip.shape[3])
    return torch.cat([strip[:, 0:1], mid, strip[:, 2:3]], dim=1)


def dequantize_u8(q, affine, dtype=torch.bfloat16):
    """Dense activations from a ``(codes, (a, b))`` pair: ``q * a + b``."""
    a, b = affine
    return (q.float() * a + b).to(dtype)


class ConvBlock(nn.Module):
    """One CNNLayer, eval mode, as one fused kernel launch at the dense
    rungs.

    A uint8 input is raw BGR with a preprocess-folded kernel
    (``assembly.fold_preprocess``) and goes to ``conv1_block``; a float
    input goes to ``conv_block``.  The instance follows
    ``compute_dtype``:

    - ``None``: the f32 instances;
    - ``"bfloat16"``: the f32 ``conv1_block`` on weights rounded to bf16
      (uint8 pixels are exact in bf16), then the ``bf16_operands``
      instance of ``conv_block``;
    - ``"bfloat16_full"``: the ``bf16_xla`` instances of ``conv1_block``
      and ``conv_block`` on bf16 activations (XLA's numerics, the JAX
      rung's: a bf16 rounding after every op); a float input is rounded
      to bf16 first, as the JAX op rounds it;
      the block that ``feeds_head`` (the net's last) returns f32 through
      ``bf16_xla_f32``: its BN sum left unrounded, as XLA leaves it where
      it fuses that sum into the head's f32 read (the JAX package's
      compiled step, and so its CLI, computes it so);
    - ``"uint8_pool"``: plain PyTorch, no kernel (``_forward_u8_pool``);
    - ``"uint8_chain"``: ``FrameConvNet`` chains the blocks'
      ``forward_u8_chain``; ``forward`` has no instance for it and raises;
    - ``"int8_mxu"``: likewise, with ``forward_i8_chain``.
    """

    def __init__(self, in_ch: int, out_ch: int, compute_dtype=None, *,
                 feeds_head: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.bn = nn.BatchNorm2d(out_ch, eps=BN_EPS)
        self.compute_dtype = compute_dtype
        self.feeds_head = feeds_head
        self._frozen = None
        self._i8_frozen: dict = {}

    def kernel_args(self):
        """(HWIO kernel, bias, BN scale, BN offset) for the block kernels:
        the ones ``freeze`` stored, else computed from the parameters.
        The kernel is bf16 at ``"bfloat16_full"`` and rounded to bf16 (as
        f32) at ``"bfloat16"``; the BN scale is ``gamma * rsqrt(var +
        eps)`` at every rung, as ``batch_norm_infer``."""
        if self._frozen is not None:
            return self._frozen
        bn = self.bn
        scale, offset = bn_scale_offset(bn.running_mean, bn.running_var,
                                        bn.weight, bn.bias)
        kernel = self.hwio().contiguous()
        if self.compute_dtype == "bfloat16_full":
            kernel = kernel.to(torch.bfloat16)
        elif self.compute_dtype == "bfloat16":
            kernel = bf16_round(kernel)
        return kernel, self.conv.bias, scale, offset

    def hwio(self) -> torch.Tensor:
        """The conv kernel in HWIO [3, 3, C_in, C_out], f32."""
        return self.conv.weight.permute(2, 3, 1, 0)

    def quantize_scale(self) -> torch.Tensor:
        bn = self.bn
        return conv_quantize_scale(bn.running_mean, bn.running_var)

    def u8_pending_affine(self):
        """The ``uint8_chain`` block's pending affine ``(a, b)``: the
        dequantize (``* scale``) composed with eval BN (``* s + t``, ``s =
        gamma * rsqrt(var + eps)``).  The block and
        ``assembly.precompute_rings`` both take it from here, so the two
        cannot drift."""
        bn = self.bn
        s, t = bn_scale_offset(bn.running_mean, bn.running_var, bn.weight,
                               bn.bias)
        return self.quantize_scale() * s.float(), t.float()

    def forward_u8_chain(self, x, affine=None, ring=None):
        """One ``uint8_chain`` block: ``x`` is the dense input of layer 1
        (``affine=None``) or the previous block's uint8 codes with their
        pending ``affine``.  ``ring`` is this block's constant term from
        ``assembly.precompute_rings``; without it the term is computed
        here.  Returns ``(codes, this block's pending affine)``."""
        kernel = self.hwio()
        if affine is None:
            z = conv2d_same(x.float(), kernel, self.conv.bias,
                            compute_dtype="bfloat16_full")
        else:
            a, b = affine
            z = conv2d_same(x.float(), kernel * a[None, None, :, None], None,
                            compute_dtype="bfloat16_full")
            if ring is None:
                ring = const_conv_ring(b, kernel, self.conv.bias, x.shape[1],
                                       x.shape[2])
            z = z + ring
        q = quantize_pool_u8(torch.relu(z).float(), self.quantize_scale())
        return q, self.u8_pending_affine()

    def i8_pending_affine(self):
        """``int8_mxu``'s pending affine: ``uint8_chain``'s with the -128
        storage shift folded into the offset (``dense = q * a + b`` with
        ``b += 128 * a``).  A frozen block computes it once."""
        if "affine" in self._i8_frozen:
            return self._i8_frozen["affine"]
        a, b = self.u8_pending_affine()
        affine = (a, b + 128.0 * a)
        if self._frozen is not None:
            self._i8_frozen["affine"] = affine
        return affine

    def i8_args(self, affine=None):
        """(int8 HWIO kernel, its per-channel scale, activation scale) of
        the block's int8 conv: the kernel with the pending affine's scale
        folded in (``a = 1`` for raw pixels, ``affine=None``), quantized by
        ``quantize_kernel_i8``.  A frozen block computes them once per
        input ("pixels" or "codes"): its pending scale then comes from
        weights that no longer change."""
        branch = "pixels" if affine is None else "codes"
        if branch in self._i8_frozen:
            return self._i8_frozen[branch]
        kernel = self.hwio().float()
        a = (torch.ones(kernel.shape[2], device=kernel.device)
             if affine is None else affine[0])
        k_i8, so = quantize_kernel_i8(kernel * a[None, None, :, None])
        args = (k_i8.contiguous(), so, self.quantize_scale())
        if self._frozen is not None:
            self._i8_frozen[branch] = args
        return args

    def forward_i8_chain(self, x, affine=None, ring=None):
        """One ``int8_mxu`` block (JAX ``apply_conv_block_i8``): ``x`` is
        raw uint8 frames (``affine=None``: int8 after a -128 shift, with
        ``a = 1``, ``b = 128``), the previous block's int8 codes with their
        pending ``affine``, or the dense float input of an unfolded layer
        1 (``affine=None``), which runs ``uint8_chain``'s bf16 conv in
        plain PyTorch.  ``ring`` is the constant term ``conv(b * 1, W) +
        bias`` as the strip ``[3, W, Cout]`` f32 of
        ``assembly.precompute_rings``; without it the strip is computed
        here.  Returns ``(int8 codes, this block's pending affine)``."""
        kernel = self.hwio().float()
        if affine is None and x.dtype != torch.uint8:
            z = conv2d_same(x.float(), kernel, self.conv.bias,
                            compute_dtype="bfloat16_full")
            q = quantize_pool_i8(torch.relu(z), self.quantize_scale())
            return q, self.i8_pending_affine()
        k_i8, so, scale = self.i8_args(affine)
        # A frame under 3 x 3 has no pool window: the block returns no
        # codes and reads no ring.
        if ring is None and min(x.shape[1:3]) >= 3:
            b = (torch.full((kernel.shape[2],), 128.0, device=x.device)
                 if affine is None else affine[1])
            ring = const_conv_ring(b, kernel, self.conv.bias, 3,
                                   x.shape[2])[0].float()
        block = conv1_block_i8 if x.dtype == torch.uint8 else conv_block_i8
        return (block(x.contiguous(), k_i8, so, ring, scale),
                self.i8_pending_affine())

    def _forward_u8_pool(self, x):
        bn = self.bn
        z = conv2d_same(x.float(), self.hwio(), self.conv.bias,
                        compute_dtype="bfloat16_full")
        scale = self.quantize_scale()
        q = quantize_pool_u8(torch.relu(z).float(), scale)
        y = batch_norm_infer(q.float() * scale, bn.running_mean,
                             bn.running_var, bn.weight, bn.bias)
        # bf16 between blocks, bfloat16_full's traffic.
        return y.to(torch.bfloat16)

    def freeze(self) -> None:
        """Compute the kernel arguments once for every later call.  Only
        for a block whose weights and device are final, such as the
        classify step's private copy: later changes are not seen."""
        self._frozen = None
        self._i8_frozen = {}
        self._frozen = self.kernel_args()

    def freeze_slice(self, whole: "ConvBlock", channels: slice) -> None:
        """Freeze this block, which holds output channels ``channels`` of
        the frozen block ``whole`` (tensor parallelism,
        ``parallel.sharding.shard_bundle``), with ``whole``'s kernel
        arguments and the int8 ones it computed so far, sliced: what mixes
        channels, such as a pending affine folded along the input axis
        before the int8 kernel is quantized, comes from the whole layer,
        and each channel's arguments are the whole block's bit for bit."""
        if whole._frozen is None:
            raise ValueError("freeze_slice takes a frozen block (freeze())")

        def cut(args):
            return tuple(t[..., channels].contiguous() for t in args)

        self._frozen = cut(whole._frozen)
        self._i8_frozen = {k: cut(v) for k, v in whole._i8_frozen.items()}

    def init_weights(self, generator) -> None:
        """The JAX package's initial values (``init_conv_block``), drawn
        from ``generator``: the kernel, then the bias."""
        fan_in = self.conv.in_channels * 9
        _init_uniform(self.conv.weight, fan_in, generator)
        _init_uniform(self.conv.bias, fan_in, generator)
        _init_bn(self.bn)

    def forward_train(self, x: torch.Tensor, group=None):
        """conv -> ReLU -> maxpool 3/3 -> train BN, differentiable
        (``apply_conv_block(train=True)``).  Returns ``(y, (new running
        mean, new running var))``; the statistics are not written.  A
        frozen block is an inference copy and refuses.  With a process
        ``group`` the BN statistics are the group's global batch's
        (``ops.nn.batch_norm_train``)."""
        if self._frozen is not None:
            raise RuntimeError("this block was frozen for inference "
                               "(freeze()); train an unfrozen copy")
        _check_train_dtype(self.compute_dtype)
        z = conv2d_same(x, self.hwio(), self.conv.bias,
                        compute_dtype=self.compute_dtype)
        z = max_pool(torch.relu(z), POOL_WINDOW)
        bn = self.bn
        y, mean, var = batch_norm_train(z, bn.running_mean, bn.running_var,
                                        bn.weight, bn.bias, group=group)
        return y, (mean, var)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype == "uint8_pool":
            return self._forward_u8_pool(x)
        args = self.kernel_args()
        full = self.compute_dtype == "bfloat16_full"
        if x.dtype == torch.uint8:
            return conv1_block(x.contiguous(), *args,
                               compute_dtype="bfloat16_full" if full
                               else None, numerics="xla")
        if full:
            return conv_block(x.to(torch.bfloat16).contiguous(), *args,
                              compute_dtype="bfloat16_full",
                              out_dtype=torch.float32 if self.feeds_head
                              else torch.bfloat16, numerics="xla")
        return conv_block(x.contiguous(), *args,
                          compute_dtype=self.compute_dtype)


class FCBlock(nn.Module):
    """Hidden: linear -> ReLU -> eval BN.  Final: linear alone.  With a
    ``compute_dtype`` the linear's operands are rounded to bf16 (the
    result stays f32, as in the JAX package at every rung but float32)."""

    def __init__(self, in_f: int, out_f: int, *, hidden: bool,
                 compute_dtype=None):
        super().__init__()
        self.linear = nn.Linear(in_f, out_f)
        self.bn = nn.BatchNorm1d(out_f, eps=BN_EPS) if hidden else None
        self.compute_dtype = compute_dtype

    def init_weights(self, generator) -> None:
        """The JAX package's initial values (``init_fc_block``), drawn
        from ``generator``: the weight, then the bias."""
        fan_in = self.linear.in_features
        _init_uniform(self.linear.weight, fan_in, generator)
        _init_uniform(self.linear.bias, fan_in, generator)
        if self.bn is not None:
            _init_bn(self.bn)

    def forward_train(self, x: torch.Tensor, group=None):
        """Hidden: linear -> ReLU -> train BN; final: linear alone
        (``apply_fc_block(train=True)``).  Returns ``(y, (new running
        mean, new running var))``, or ``(y, None)`` without BN; ``group``
        as in ``ConvBlock.forward_train``."""
        _check_train_dtype(self.compute_dtype)
        x = linear(x, self.linear.weight.t(), self.linear.bias,
                   compute_dtype=self.compute_dtype)
        if self.bn is None:
            return x, None
        bn = self.bn
        y, mean, var = batch_norm_train(torch.relu(x), bn.running_mean,
                                        bn.running_var, bn.weight, bn.bias,
                                        group=group)
        return y, (mean, var)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = linear(x, self.linear.weight.t(), self.linear.bias,
                   compute_dtype=self.compute_dtype)
        if self.bn is None:
            return x
        return batch_norm_infer(torch.relu(x), self.bn.running_mean,
                                self.bn.running_var, self.bn.weight,
                                self.bn.bias)
