"""Stage-bisection microbenchmark of layer 1: ``conv1_stages<S>`` in
``csrc/conv_block.cu``.

Port of the TPU kernel ``_kernel`` of ``scripts/profile_fused_conv1.py``
(``:40``, its ``pl.pallas_call`` at ``:126``): six cumulative cuts of a
fused layer-1 kernel, whose times say where layer 1's per-tile chain
spends its time.  On Hopper each cut stops the port's own layer-1
tensor-core chain (``conv1_block_mma``, whose ``pack_tile``,
``conv1_mma`` and ``conv1_pool`` it calls) at the matching point: staging
(``cast``), packing the taps into k16 steps (``taps``), ``wgmma`` in
layer 1's orientation (``dotn``, M = the channels) or in the mid-stack
one (``dott``, M = the positions), an epilogue on every accumulator
(``tpose``) and the pool (``full``).  The kernel's comment lists where it
departs from ``conv1_block_mma``.

The public layout is the TPU script's, at its only shape (``build``,
``:97-117``): ``x`` ``[B, 3, 37668]`` uint8, three planes of (144 + 2)
rows x 258 lanes with the pad lanes included; ``w2t`` ``[48, 32]`` bf16.
The TPU kernel's accumulators start uninitialised and ``taps`` and
``dott`` leave nothing in its output, so the port defines (the plain
version and the kernel alike):

- ``out`` ``[B, 128, 128]`` f32, zero where the TPU kernel writes nothing:
  ``cast`` rows 0:48 of x[:, 0, 0:128]; ``dotn`` and ``tpose`` rows 0:48,
  columns 0:128, the sums over the 12 strips of ``acc[:, 0:128]`` and of
  ``bf16(relu(acc))[:, 0:128]``; ``full`` rows 0:85, columns 0:48, the sum
  over the 48 pooled rows of the 3x3 max pool of ``bf16(relu(acc))``;
- ``sink`` ``[B]`` f32, a checksum that keeps the kernel's work: ``taps``
  the checksum of the packed tiles (``taps_sink``, int32 bits: exact);
  ``dott`` the sum of every accumulator weighted by its position and its
  channel (``dott_sink``); zero for the other stages (the kernel's
  ``tpose`` xors its rounded values, an order-dependent number that
  nothing compares).

On the CPU ``conv1_stages`` runs the plain version, on CUDA the kernel (or
raises).  ``conv1_stages.launches`` counts its kernel launches, and
``conv1_stages.instance_launches[stage]`` counts them by stage.
"""

from __future__ import annotations

import torch

from cut_detection_tpu_torch.ops.kernels import _build

STAGES = ("cast", "taps", "dotn", "dott", "tpose", "full")

H, W = 144, 256
WS = 3 * (-(-(W + 1) // 3))  # 258 lanes a plane row
COUT, K = 48, 32
OUT = 128


def _strip_rows_for(h: int, cap: int = 24) -> int:
    """Largest strip height <= cap that tiles h into pool-aligned strips.

    Copy of ``cut_detection_tpu/ops/pallas/fused_conv1.py:158-169``."""
    for n in range(-(-h // cap), h + 1):
        if h % n == 0 and (h // n) % 3 == 0:
            return h // n
    raise ValueError(f"height {h} not divisible into pool-aligned strips")


STRIP_ROWS = _strip_rows_for(H, cap=12)  # 12
N_STRIPS = H // STRIP_ROWS
M = STRIP_ROWS * WS  # 3096 conv positions a strip
FLAT = (H + 2) * WS  # 37,668 bytes a plane
OUT_W = (W - 3) // 3 + 1  # 85


def _check(x: torch.Tensor, w2t: torch.Tensor, stage: str) -> None:
    if stage not in STAGES:
        raise ValueError(f"unknown stage {stage!r}; one of {STAGES}")
    if x.dim() != 3 or tuple(x.shape[1:]) != (3, FLAT) or x.shape[0] < 1:
        raise ValueError(f"x must be [B, 3, {FLAT}] uint8, got "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.uint8:
        raise TypeError(f"x has dtype {x.dtype}, expected torch.uint8")
    if tuple(w2t.shape) != (COUT, K) or w2t.dtype != torch.bfloat16:
        raise ValueError(f"w2t must be [{COUT}, {K}] bfloat16, got "
                         f"{tuple(w2t.shape)} {w2t.dtype}")


def im2col(x: torch.Tensor) -> torch.Tensor:
    """``[B, 27, 144 * 258]`` f32: row k = (dy * 3 + dx) * 3 + c of every
    strip's im2col side by side (strip s is columns s * 3096 on), from
    ``xbf``, the planes shifted right one lane with a zero at each end."""
    b = x.shape[0]
    xbf = torch.zeros((b, 3, FLAT + 2), dtype=torch.float32, device=x.device)
    xbf[:, :, 1:FLAT + 1] = x.float()
    rows = []
    for dy in range(3):
        for dx in range(3):
            for c in range(3):
                start = dy * WS + dx
                rows.append(xbf[:, c, start:start + N_STRIPS * M])
    return torch.stack(rows, 1)


def conv_acc(x: torch.Tensor, w2t: torch.Tensor) -> torch.Tensor:
    """``[B, 48, 144 * 258]`` f32: every strip's ``W @ A`` side by side.
    The products of bf16 operands are exact; the sums are taken in float64
    and rounded once, so the result is the f32 nearest the exact one
    whatever the device (the TPU kernel sums in f32, in its own order)."""
    a = im2col(x).double()
    wk = w2t[:, :27].double()  # columns 27-31 meet the zero im2col rows
    return torch.einsum("ok,bkp->bop", wk, a).float()


def _bf16_relu(acc: torch.Tensor) -> torch.Tensor:
    return torch.relu(acc).to(torch.bfloat16).float()


def _strip_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the strips, in strip order, of columns 0:128 of each."""
    total = torch.zeros(v.shape[:2] + (OUT,), dtype=v.dtype,
                        device=v.device)
    for s in range(N_STRIPS):
        total = total + v[:, :, s * M:s * M + OUT]
    return total


# The kernel's tiles (conv1_block_mma's): an item is a pooled row r, a
# tile 24 conv columns of its 5 plane rows 3r .. 3r + 4; 11 tiles a row.
ITEMS, TILE_COLS, TILES = H // 3, 24, -(-WS // 24)


def _tile_coef() -> torch.Tensor:
    """``[5, 24, 9]`` int64: the factor of tap k = dx * 3 + c of staged
    row sr, tile column col in the taps checksum: its 16-bit word's
    weight (2 * word index in the tile + 1), shifted to its half.  The
    tile's layout (``pack_tile``): column col's k 0-7 are 16 bytes at
    (sr * 3 + u // 2) * 256 + ((wl >> 1) * 2 + u % 2) * 16 with wl =
    col // 3, u = 3 * (wl % 2) + col % 3; its k 8 is 128 bytes on."""
    coef = torch.zeros((5, TILE_COLS, 9), dtype=torch.int64)
    for sr in range(5):
        for col in range(TILE_COLS):
            wl = col // 3
            u = 3 * (wl % 2) + col % 3
            i = ((sr * 3 + u // 2) * 256 + ((wl >> 1) * 2 + u % 2) * 16) // 4
            for k in range(9):
                word, half = (i + k // 2, k % 2) if k < 8 else (i + 32, 0)
                coef[sr, col, k] = (2 * word + 1) << (16 * half)
    return coef


def taps_sink(x: torch.Tensor) -> torch.Tensor:
    """``[B]`` f32 holding int32 bits: the sum, mod 2^32, over every packed
    tile of every word times 2 * its word index + 1.  Tap k = dx * 3 + c
    of staged row sr, column col of tile j of item r is the bf16 bits of
    x[c][(3r + sr) * 258 + 24 j + col + dx - 1] (zero outside the
    plane)."""
    b = x.shape[0]
    xz = torch.zeros((b, 3, FLAT + 16), dtype=torch.int64, device=x.device)
    xz[:, :, 1:FLAT + 1] = (x.float().view(torch.int32) >> 16).long()
    r = torch.arange(ITEMS, device=x.device).view(-1, 1, 1, 1, 1)
    sr = torch.arange(5, device=x.device).view(1, -1, 1, 1, 1)
    j = torch.arange(TILES, device=x.device).view(1, 1, -1, 1, 1)
    col = torch.arange(TILE_COLS, device=x.device).view(1, 1, 1, -1, 1)
    dx = torch.arange(3, device=x.device).view(1, 1, 1, 1, -1)
    at = ((3 * r + sr) * WS + TILE_COLS * j + col + dx).clamp(0, FLAT + 1)
    coef = _tile_coef().to(x.device)  # [sr, col, k]
    total = torch.zeros((b,), dtype=torch.int64, device=x.device)
    for c in range(3):
        bits = xz[:, c, at.reshape(-1)].view(b, *at.shape)
        part = (bits * coef[:, :, c::3].view(1, 1, 5, 1, TILE_COLS, 3))
        total = (total + (part.sum((2, 3, 4, 5)) & 0xFFFFFFFF).sum(1)) \
            & 0xFFFFFFFF
    signed = torch.where(total >= 2 ** 31, total - 2 ** 32, total)
    return signed.to(torch.int32).view(torch.float32)


def dott_weights(device) -> torch.Tensor:
    """``[48, 144 * 258]`` f64: the weight of channel o at position u in
    ``dott``'s sink, ((u mod 7) + 1) * ((o mod 5) + 1)."""
    u = torch.arange(H * WS, device=device)
    o = torch.arange(COUT, device=device)
    return ((o % 5 + 1).view(-1, 1) * (u % 7 + 1).view(1, -1)).double()


def dott_sink(acc: torch.Tensor) -> torch.Tensor:
    """``[B]`` f32: ``dott``'s sink of the accumulators ``acc`` ``[B, 48,
    144 * 258]``, summed in float64."""
    return (acc.double() * dott_weights(acc.device)).sum((1, 2)).float()


def _pooled_rows(z: torch.Tensor) -> torch.Tensor:
    """``[B, 48, 48, 85]``: the 3x3 max pool of ``z`` ``[B, 48, 144 *
    258]``, its 85 real columns (windows 0-84 read positions 0-254)."""
    z = z.reshape(z.shape[0], COUT, H, WS)
    return torch.nn.functional.max_pool2d(z, 3, 3)[..., :OUT_W]


def conv1_stages_plain(x: torch.Tensor, w2t: torch.Tensor,
                       stage: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of one stage: ``(out, sink)``."""
    _check(x, w2t, stage)
    b = x.shape[0]
    out = torch.zeros((b, OUT, OUT), dtype=torch.float32, device=x.device)
    sink = torch.zeros((b,), dtype=torch.float32, device=x.device)
    if stage == "cast":
        out[:, 0:COUT, :] = x[:, 0:1, 0:OUT].float()
        return out, sink
    if stage == "taps":
        return out, taps_sink(x)
    acc = conv_acc(x, w2t)
    if stage == "dott":
        sink = dott_sink(acc)
    elif stage == "dotn":
        out[:, 0:COUT, :] = _strip_sum(acc)
    elif stage == "tpose":
        out[:, 0:COUT, :] = _strip_sum(_bf16_relu(acc))
    else:  # full
        pooled = _pooled_rows(_bf16_relu(acc))
        total = torch.zeros((b, COUT, OUT_W), dtype=torch.float32,
                            device=x.device)
        for r in range(ITEMS):
            total = total + pooled[:, :, r]
        out[:, 0:OUT_W, 0:COUT] = total.transpose(1, 2)
    return out, sink


# The tensor cores' f32 accumulation of bf16 products aligns the terms to
# the largest and truncates, rather than rounding each addition to
# nearest: the kernel's accumulators are held to 2^-16 of the sum of the
# terms' magnitudes (|W| @ |A| at the position), where IEEE f32 in any
# order keeps within (27 + 12) * 2^-24 of it.
CARD_SUM_TOL = 2.0 ** -16
# dott's sink: f32 chains of fewer than 4096 additions a thread.
DOTT_CHAIN_TOL = 2.0 ** -12


def _f32_below(v: torch.Tensor) -> torch.Tensor:
    """The f32 at or below each float64 of ``v``."""
    f = v.float()
    return torch.where(f.double() > v, torch.nextafter(
        f, torch.full_like(f, -float("inf"))), f)


def _f32_above(v: torch.Tensor) -> torch.Tensor:
    f = v.float()
    return torch.where(f.double() < v, torch.nextafter(
        f, torch.full_like(f, float("inf"))), f)


def _term_bounds(x, w2t, scale):
    """``(lo, hi)``, ``[B, 48, 144 * 258]`` f32: the least and the most
    ``bf16(relu(a))`` for a card accumulator ``a`` within ``CARD_SUM_TOL``
    of the summed magnitudes ``scale`` of the exact sum (relu and the
    rounding are monotonic, so the ends of the interval bound it)."""
    acc = conv_acc(x, w2t).double()
    slack = CARD_SUM_TOL * scale
    return (_bf16_relu(_f32_below(acc - slack)),
            _bf16_relu(_f32_above(acc + slack)))


def check_stage(stage: str, x: torch.Tensor, w2t: torch.Tensor,
                got: tuple, want: tuple) -> float:
    """Hold the kernel's ``(out, sink)`` to the plain version's on the same
    inputs; raise ``AssertionError`` where they part, else return the
    largest absolute difference of ``out`` (of ``sink`` for ``dott``).

    ``cast`` and ``taps`` exact (``taps``'s sink too).  ``dotn`` within
    ``CARD_SUM_TOL`` of the summed magnitudes.  ``tpose`` and ``full`` add
    bf16-rounded terms (12 and 48): each term may differ only where an
    accumulator within ``CARD_SUM_TOL`` of the exact sum can round to
    another bf16 (``_term_bounds``: zero allowance elsewhere), and the two
    f32 sums of n non-negative terms, in different orders, by 2 (n - 1)
    2^-24 of their largest total.  ``dott``'s sink, a weighted sum of 1.8
    M accumulators a frame, within ``DOTT_CHAIN_TOL`` of the sum of the
    weighted magnitudes plus ``CARD_SUM_TOL`` of the weighted summed
    magnitudes of every term."""
    (out, sink), (ref, ref_sink) = got, want
    if stage in ("cast", "taps"):
        if not torch.equal(out, ref):
            raise AssertionError(f"{stage}: out differs")
        if stage == "taps" and not torch.equal(sink.view(torch.int32),
                                               ref_sink.view(torch.int32)):
            raise AssertionError("taps: the packed tiles' checksum differs")
        return 0.0
    scale = torch.einsum("ok,bkp->bop", w2t[:, :27].double().abs(),
                         im2col(x).double().abs())  # [B, 48, 144 * 258]
    if stage == "dott":
        if not torch.equal(out, ref):
            raise AssertionError("dott: out differs")
        wt = dott_weights(x.device)
        acc = conv_acc(x, w2t).double()
        err = (sink.double() - ref_sink.double()).abs()
        tol = (DOTT_CHAIN_TOL * (acc.abs() * wt).sum((1, 2))
               + CARD_SUM_TOL * (scale * wt).sum((1, 2)))
        if (err > tol).any():
            raise AssertionError(f"dott: sink off by {err.tolist()}, "
                                 f"allowed {tol.tolist()}")
        return float(err.max())
    diff = (out.double() - ref.double()).abs()
    tol = torch.zeros_like(diff)
    if stage == "dotn":
        tol[:, 0:COUT, :] = CARD_SUM_TOL * _strip_sum(scale.float()).double()
    elif stage == "tpose":
        lo, hi = (_strip_sum(v.double()) for v in _term_bounds(x, w2t,
                                                                 scale))
        order = 2 * (N_STRIPS - 1) * 2.0 ** -24
        tol[:, 0:COUT, :] = hi - lo + order * hi
    else:  # full
        lo, hi = (_pooled_rows(v) for v in _term_bounds(x, w2t, scale))
        order = 2 * (ITEMS - 1) * 2.0 ** -24
        width = (hi - lo).double().sum(2) + order * hi.double().sum(2)
        tol[:, 0:OUT_W, 0:COUT] = width.transpose(1, 2)
    if (diff > tol).any():
        at = int((diff - tol).argmax())
        raise AssertionError(
            f"{stage}: out off by {float(diff.reshape(-1)[at])} at flat "
            f"index {at}, allowed {float(tol.reshape(-1)[at])}")
    return float(diff.max())


def conv1_stages(x: torch.Tensor, w2t: torch.Tensor,
                 stage: str) -> tuple[torch.Tensor, torch.Tensor]:
    """One stage on ``x`` and ``w2t``: ``(out, sink)``, by the plain
    version on the CPU and by the kernel on CUDA."""
    if x.device.type == "cpu":
        return conv1_stages_plain(x, w2t, stage)
    if x.device.type != "cuda":
        raise ValueError(f"conv1_stages: unsupported device {x.device}")
    _check(x, w2t, stage)
    dev = x.device
    b = x.shape[0]
    _build.expect(x, "x", torch.uint8, (b, 3, FLAT), dev)
    _build.expect(w2t, "w2t", torch.bfloat16, (COUT, K), dev)
    if x.data_ptr() % 4 or w2t.data_ptr() % 16:
        raise ValueError("conv1_stages: x must be 4-byte aligned and w2t "
                         "16-byte aligned")
    out = torch.empty((b, OUT, OUT), dtype=torch.float32, device=dev)
    sink = torch.empty((b,), dtype=torch.float32, device=dev)
    rc = _build.library().cutdet_conv1_stages(
        STAGES.index(stage), x.data_ptr(), w2t.data_ptr(), out.data_ptr(),
        sink.data_ptr(), b, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, f"conv1_stages[{stage}] launch")
    conv1_stages.launches += 1
    conv1_stages.instance_launches[stage] += 1
    return out, sink


conv1_stages.launches = 0
conv1_stages.instance_launches = dict.fromkeys(STAGES, 0)
