"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. device  — a CUDA device is required (there is no CPU path); prints the
             card's name and power limit;
2. build   — compiles every kernel from ``cut_detection_tpu_torch/csrc``
             with nvcc and prints the build time and ptxas report (no
             spills allowed), and the wgmma instructions of each
             tensor-core kernel in the library's SASS: HGMMA in the bf16
             instances, IGMMA (s8) in the int8 ones, none of the other
             kind and no IDP.4A (dp4a) anywhere (any miss fails), the
             three layer-1 ones (``conv1_block``'s bf16, bf16_xla and
             i8 instances) named;
3. kernels — each kernel instance against its plain PyTorch version on
             the card at the main path's shapes (batch 128, seeded
             inputs), with the max error, the tolerance (for the
             instances that round activations to bf16, the worst error
             over its one-ulp bound and the count of one-ulp crossings,
             at most 0.1% of the elements), the median times of the
             kernel (one call between two CUDA events, so with the
             host's time to launch it; a call's share of 50 enqueued
             back to back; and the same behind a sleep on the card, so
             that the host stays ahead: the card's own time a call), its
             plain version and the library's convolution
             (cuDNN, the block's conv alone at the instance's operand
             type), and the least time the card could take (bytes or
             operations, from this run's shapes): layer 1 (f32, K1's
             bf16 instance and XLA's bf16_xla) at 144x256 and 143x256,
             the mid-stack block's five NHWC instances and K4's two
             channel-major ones at 48x85 and 16x28, the resize +
             normalize kernel at 1280x720 -> 256x144, the YUV -> BGR
             kernel on a seeded batch of 128 planes at 144x256 (max
             diff 0; also streamed from cold L2, over planes and outputs
             that rotate through three times the L2) and on the
             exhaustive 2^24 (Y, U, V) probe against the host's numpy
             twin, as it is, 2 bytes off a 16-byte boundary and cropped
             to a width off 16 (the kernel's vector and scalar routes),
             the int8 blocks of ``int8_mxu``
             (layer 1 on raw pixels at 144x256, the mid-stack block at
             48x85 on layer 1's codes and at 16x28 on layer 2's, the
             prod net's weights and rings; max diff 0; the library's
             yardstick is cuDNN's f32 convolution of the same integer
             values, TF32 off: PyTorch has no int8 convolution on CUDA;
             beside it ``torch._int_mm``, cuBLASLt's int8 GEMM with
             int32 sums, of an im2col made outside the timed call, the
             conv's sums alone, checked against the plain sums on two
             frames; the earlier design's times printed beside);
4. slice   — the prod classifier over a seeded synthetic stream of
             144x256 frames through the pipeline's device loop, on the
             card and on the CPU (plain versions): identical classes and
             CSV bytes, confidences within 1e-4, and the kernels'
             launch counts by instance over that run;
5. host    — where the slice loop's time per batch goes: the loop's
             frames/s, each of its pieces timed alone, and the card's
             busy share read from a ``torch.profiler`` trace of the loop;
5b. yuv420 — the slice stream as packed planar YUV420 through the device
             loop with ``yuv_dims`` at every rung: one ``yuv420_to_bgr``
             launch a batch, conf and pred identical to the loop on the
             planes converted on the host; then the host phase's
             breakdown of the float32 loop on planes, beside bgr's;
6. preprocess — a seeded synthetic 1280x720 stream through the device
             loop with the resize on the card (``--device-resize``): the
             exact path against the same frames resized on the host,
             the fused-kernel path (``--pallas-preprocess``) against the
             CPU; each path's launch counts; then per batch at 720p the
             loop's frames/s, the stack, the pageable and pinned uploads,
             the resizes and the steps, and each loop's busy share from
             a trace;
7. precision — the slice stream at ``--precision bfloat16``,
             ``bfloat16_full``, ``uint8_pool``, ``uint8_chain`` and
             ``int8_mxu``: card against CPU (identical classes,
             confidences within 2e-2 at the bf16 rungs and
             ``QUANT_CONF_TOL`` at the quantized ones), launches by
             instance (the ``bf16_xla`` instances at ``bfloat16_full``;
             none at ``uint8_pool`` and ``uint8_chain``, which are plain
             PyTorch; at ``int8_mxu`` ``conv1_block[i8]`` once and
             ``conv_block[i8]`` twice a batch and nothing else), each
             rung's step on a resident batch beside float32's, each
             rung's loop frames/s, and the quantized rungs' busy share
             from a trace;
8. bench_fused — the port's ``bench_fused_conv1`` entry point at batch
             128: K1 -> K4 -> K4 -> head must equal K1 -> K3 -> K3 ->
             head exactly; stage ``block`` with the launch counts read
             around it (K4's chain against the shipped net, XLA's
             numerics: no class flips, logits within ``BENCH_XLA_TOL``),
             stage ``mid`` (K3's ``bf16_out``) likewise, then ``all``;
             each stage's JSON line is printed;
9. golden  — when a decoder exists (cv2 or the native decoder), the
             ``segment_video`` CLI's ``main`` on the committed golden
             clips at float32 with no preprocess flag, ``--device-resize``
             and ``--device-resize --pallas-preprocess``, compared byte
             for byte with the reference CSVs; at each bf16 rung the same
             three on ``clip.mp4`` and the default on ``clip_odd.mp4``
             (byte for byte without ``--pallas-preprocess``, frame
             accuracy >= 0.99 against the reference with it); at each
             quantized rung the default on both clips, byte for byte;
             then the labelled eval-corpus clips at both bf16 rungs and
             ``corpus_a`` and ``corpus_nat`` at both quantized rungs,
             held to the JAX package's gates, and ``corpus_adv`` too at
             ``int8_mxu``; ``--device-glue`` at float32 on both golden
             clips (the host glue's bytes, the reference's) and
             ``--profile DIR`` on ``clip.mp4`` (a trace file holding the
             card's kernels, the same bytes).  Where the native
             decoder has its YUV entry points: ``--transfer auto`` must
             resolve to yuv420; the golden clips at float32 under
             ``--transfer yuv420`` and ``auto`` byte for byte, the other
             rungs under yuv420 on ``clip.mp4`` at frame accuracy >=
             0.99, and corpus a, b, c and nat at float32 and
             ``uint8_chain`` under yuv420 at the JAX gates.  Kernel
             launches are counted by instance in every run;
10. device_glue — the segment smoother on the card
             (``segmentation.device_glue``) on a seeded 324,000-frame
             score vector (a 3-hour game at 30 fps) against the host
             glue on the same vector: the same segments (means within
             1e-5), each one's time and the card's loop iterations.

Before it prints a result the run stops every process it started (the
decode subprocesses and ``multiprocessing``'s resource tracker).  Then
one JSON line with every kernel's numbers, and last the result line
``{"ok": true, "device": {...}}``.  Any failure exits non-zero without it.
"""

from __future__ import annotations

import collections
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden")
CORPUS = os.path.join(ROOT, "tests", "eval_corpus")
BATCH = 128
F32_TOL = 1e-4          # f32 kernel vs plain: summation order only
CONF_TOL = 1e-4         # slice confidences, card vs CPU
BF16_CONF_TOL = 2e-2    # the same at the bf16 rungs: one-ulp crossings of
                        # bf16-rounded activations move logits by a few
                        # 1e-3 (6.3e-3 at most measured on this stream)
K5_TOL = 1e-5           # resize + normalize on [0, 1]: two-tap sums
                        # against the plain version's dense matmuls
BENCH_XLA_TOL = 5e-2    # K1 -> K4 -> K4 (the Pallas kernels' numerics)
                        # against the shipped bfloat16_full net (XLA's):
                        # tests/test_torch_bench_fused.py's bar for the
                        # same comparison (0.0266 at batch 16 on the CPU)
QUANT_CONF_TOL = 2e-2   # the slice at the quantized rungs, card vs CPU: a
                        # conv output a bf16 ulp apart (cuDNN's summation
                        # order against the CPU's) moves a uint8 code by 1
                        # (7.9e-3 at most measured on this stream); at
                        # int8_mxu the rings are such a bf16 conv
GAME_FRAMES = 324_000   # a 3-hour game at 30 fps, for the smoother
BENCH_STEPS = 3         # calls per timed loop of the bench_fused phase
# H100 SXM peaks (NVIDIA's data sheet, dense): the least time of a kernel
# is the larger of its bytes over the memory rate and its operations over
# the rate of their type.
LAYER1_MMA_KERNELS = 3  # conv1_block's bf16, bf16_xla and i8
# The earlier designs' readings, from this script on an NVIDIA H100 80GB
# HBM3 at 700.00 W, printed beside this run's: layer 1 before its
# tensor-core route (one block per pooled row and frame, f32 FMAs for
# every instance), with the mid-stack blocks and the steps of that tree;
# the int8 blocks on __dp4a (one call / a call's share of 50 streamed, at
# 144x256, 48x85 and 16x28) and the int8_mxu step of their tree.
EARLIER_MS = {"conv1_block[f32]": 0.4425, "conv1_block[bf16]": 0.4492,
              "conv1_block[bf16_xla]": 0.4462, "conv_block[f32]": 0.6154,
              "conv_block[bf16_operands]": 0.2252,
              "conv_block[bf16_xla]": 0.0992,
              "conv_block[bf16_xla_f32]": 0.0980,
              "conv_block[bf16_out]": 0.0978, "conv_block[cm_bf16]": 0.3728,
              "conv_block[cm_f32]": 0.3102, "resize_normalize": 0.0861}
# yuv420_to_bgr's first design (one thread per 2x2 luma block) at batch
# 128, 144x256: one call and streamed (not queued), and its card time a
# batch in the yuv420 phase's trace.
EARLIER_YUV_MS = (0.0397, 0.0232, 0.0170)
EARLIER_I8_MS = {(144, 256): (0.2873, 0.2651), (48, 85): (0.3909, 0.3462),
                 (16, 28): (0.0996, 0.0684)}
EARLIER_STEP_MS = {"float32": 1.3493, "bfloat16": 0.9449,
                   "bfloat16_full": 0.7908, "uint8_pool": 9.4468,
                   "uint8_chain": 9.0933, "int8_mxu": 1.0319,
                   "host": 1.3342}
EARLIER_FPS = {"loop": 39875.9, "float32": 31629.0, "bfloat16": 32075.7,
               "bfloat16_full": 32727.7, "uint8_pool": 11765.2,
               "uint8_chain": 12257.4, "l1_fused": 218766.5,
               "l1_xla": 205233.5, "e2e_fused": 158487.0,
               "e2e_xla": 151183.0, "e2e_allfused": 109213.0,
               "e2e_u8mid": 17162.4, "e2e_chain": 13970.0}
HBM_BYTES_PER_S = 3.35e12
# Cycles of torch.cuda._sleep ahead of a queued stream (about 10 ms at
# the H100's clock): far longer than the host takes to enqueue it.
SLEEP_CYCLES = 20_000_000
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12, "i8": 1979e12}
SRC_HW = (720, 1280)    # source frames of the preprocess paths
MODEL_HW = (144, 256)   # their size at the model (reference size rule)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` on the card, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def stream_ms(fn, inputs: list | None = None, launches: int = 50,
              queued: bool = False) -> float:
    """Milliseconds per call of ``fn()`` over ``launches`` calls enqueued
    back to back between two CUDA events (``cuda_ms``, one call between
    its events, also counts the host's time to launch it).  A call whose
    wrapper takes longer on the host than its kernel on the card is
    timed at the host's pace; with ``queued`` the calls wait behind
    ``SLEEP_CYCLES`` of ``torch.cuda._sleep``, so that the host stays
    ahead and the figure is the card's own time per call.  With
    ``inputs`` the calls are ``fn(x)``, rotating over them, each output
    held until ``len(inputs)`` later calls have been made: n inputs and
    n + 1 outputs rotate, and with more than the card's L2 between two
    uses each call finds its input and its output out of L2 (without
    ``inputs`` one input and one recycled output stay in it)."""
    args = [()] if inputs is None else [(x,) for x in inputs]
    held = collections.deque(maxlen=0 if inputs is None else len(inputs))
    for a in args:  # warm-up; with inputs the allocator holds n + 1 outputs
        held.append(fn(*a))
    torch.cuda.synchronize()
    if queued:
        torch.cuda._sleep(SLEEP_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(launches):
        held.append(fn(*args[i % len(args)]))
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke test runs only on "
                           "the GPU")
    from cut_detection_tpu_torch.utils.device import card_info, strict_fp32

    strict_fp32()
    card = card_info()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()}")
    return card


def phase_build():
    from cut_detection_tpu_torch.ops.kernels import _build

    # Compile csrc/ in this run even where an earlier run left a current
    # library behind.
    t0 = time.perf_counter()
    path = _build.rebuild()
    _build.library()
    log(f"build: nvcc {_build.BuildInfo.seconds:.2f} s, build + load "
        f"{time.perf_counter() - t0:.2f} s -> {os.path.relpath(path, ROOT)}")
    spills = 0
    for line in _build.BuildInfo.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line \
                or "C75" in line:
            log(f"  ptxas: {line.strip()}")
        stores = re.search(r"(\d+) bytes spill stores", line)
        if stores and int(stores.group(1)):
            spills += 1
    if spills:
        raise AssertionError(f"ptxas reports spills in {spills} kernels")
    # The tensor-core kernels must issue wgmma: HGMMA (bf16) or IGMMA (s8,
    # the int8 instances, Epilogue::kI8 = 3 in their mangled names) in
    # their SASS, and none of the other kind; no kernel runs dp4a.
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", path], capture_output=True,
                          text=True, check=True).stdout
    ops = ("HGMMA", "IGMMA", "IDP.4A")
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = dict.fromkeys(ops, 0)
        elif name is not None:
            for op in ops:
                counts[name][op] += op in line

    def epilogue(n):
        return (re.search(r"EpilogueE(\d)", n) or [None, "?"])[1]

    mma = {n: c for n, c in counts.items() if "block_mma" in n}
    i8 = {n: c for n, c in mma.items() if epilogue(n) == "3"}
    for kind, group in (("HGMMA", {n: c for n, c in mma.items()
                                   if n not in i8}), ("IGMMA", i8)):
        per = [c[kind] for c in group.values()]
        log(f"build: {len(group)} {kind} tensor-core kernels, {kind} "
            f"instructions {sorted(set(per))} each ({sum(per)} in all)")
        other = "IGMMA" if kind == "HGMMA" else "HGMMA"
        if not group or 0 in per or any(c[other] for c in group.values()):
            raise AssertionError(f"a tensor-core kernel issues no {kind}, "
                                 f"or issues {other}")
    dp4a = sorted(n for n, c in counts.items() if c["IDP.4A"])
    log(f"build: IDP.4A (dp4a) in {len(dp4a)} kernels")
    if dp4a:
        raise AssertionError(f"kernels run dp4a: {dp4a}")
    # Layer 1's (conv1_block_mma): the bf16, bf16_xla and i8 instances.
    layer1 = {n: c for n, c in mma.items() if "conv1_block_mma" in n}
    for n, c in sorted(layer1.items()):
        epi = {"1": "bf16", "2": "bf16_xla", "3": "i8"}.get(epilogue(n), "?")
        log(f"build: layer-1 tensor-core kernel conv1_block[{epi}]: "
            f"{c['HGMMA']} HGMMA, {c['IGMMA']} IGMMA")
    if len(layer1) != LAYER1_MMA_KERNELS:
        raise AssertionError(f"{len(layer1)} layer-1 tensor-core kernels in "
                             f"the library, expected {LAYER1_MMA_KERNELS}")


def _bn(rng, cout):
    gamma = rng.normal(1, 0.1, cout)
    beta = rng.normal(0, 0.1, cout)
    mean = rng.normal(0, 0.5, cout)
    var = rng.uniform(0.5, 2, cout)
    s = gamma / np.sqrt(var + 1e-5)
    return s.astype(np.float32), (beta - mean * s).astype(np.float32)


def phase_kernels(dev):
    """Every kernel instance against its plain version; returns ``{row
    name: {"max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
    "bound_by"}}`` at the main path's shapes (layer 1 at 144x256, the
    mid-stack block at 48x85)."""
    import torch.nn.functional as F

    from cut_detection_tpu_torch.models.assembly import (
        fold_preprocess,
        load_default_net,
    )
    from cut_detection_tpu_torch.ops.kernels import conv_block as cb
    from cut_detection_tpu_torch.ops.kernels.conv1_block import (
        conv1_block,
        conv1_block_plain,
    )
    from cut_detection_tpu_torch.ops.kernels.conv1_block import (
        instance as conv1_instance,
    )
    from cut_detection_tpu_torch.ops.kernels.resize_normalize import (
        _resize_matrices,
        resize_normalize,
        resize_normalize_plain,
    )
    from cut_detection_tpu_torch.ops.kernels.tolerance import (
        MAX_CROSSING_SHARE,
        bf16_check,
        xla_check,
    )
    from cut_detection_tpu_torch.ops.nn import bn_scale_offset

    rng = np.random.default_rng(0)
    results = {}

    def library_conv(x_nhwc, kernel, bias, op_dtype):
        """One cuDNN convolution of the block's input and weights at the
        instance's operand type, channels-last: the library's route to
        the block's dominant work (the epilogue is not in it)."""
        x = x_nhwc.permute(0, 3, 1, 2).to(op_dtype).contiguous(
            memory_format=torch.channels_last)
        w = kernel.permute(3, 2, 0, 1).to(op_dtype).contiguous(
            memory_format=torch.channels_last)
        b = bias.to(op_dtype)
        return lambda: F.conv2d(x, w, b, padding=1)

    def bound(inputs, out, h, w, cin, cout, op):
        """Least milliseconds: each input read once and the output written
        once over the HBM rate, against the conv's operations (the conv
        outputs the pool reads, 3*Hp x 3*Wp per frame) over the peak of
        the operand type ``op``."""
        nbytes = sum(t.numel() * t.element_size() for t in (*inputs, out))
        b = out.shape[0]
        flops = 2 * b * (3 * (h // 3)) * (3 * ((w - 3) // 3 + 1)) \
            * 9 * cin * cout
        by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
        by_ops = 1e3 * flops / PEAK_FLOPS[op]
        return (by_ops, "operations") if by_ops >= by_bytes \
            else (by_bytes, "bytes")

    def record(name, shape, err, tol, ok, ms, plain_ms, library_ms, bnd,
               call):
        """The row of a kernel checked against its plain version; ``call``
        launches it once, for the two streamed times."""
        streamed, card = stream_ms(call), stream_ms(call, queued=True)
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        log(f"kernel {name} {shape}: max_abs_err {err:.3e} ({tol}) "
            f"kernel {ms:.4f} ms ({streamed:.4f} ms a call streamed, "
            f"{card:.4f} queued) plain {plain_ms:.4f} ms library {lib} "
            f"bound {bnd[0]:.4f} ms ({bnd[1]}) {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} at {shape} disagrees with its "
                                 f"plain version beyond {tol}")
        return {"max_abs_err": err, "ms": ms, "stream_ms": streamed,
                "card_stream_ms": card, "plain_ms": plain_ms,
                "library_ms": library_ms, "bound_ms": bnd[0],
                "bound_by": bnd[1]}

    def xla_for(scale, bias):
        """``tolerance.xla_check`` of a block with these BN scale and
        bias: the bar for XLA's roundings."""
        return lambda got, want, offset: xla_check(got, want, offset, scale,
                                                   bias)

    def compare(name, shape, fn, plain_fn, library_fn, bound_of,
                offset=None, to_nhwc=None, check=bf16_check):
        """``fn`` against ``plain_fn``: within F32_TOL, or, with the BN
        ``offset`` of an instance that rounds its activation to bf16, by
        ``tolerance.bf16_check``: within one bf16 ulp of the pooled
        activation m (y = m*s + t), plus one ulp of y where the output is
        bf16, on every element, and apart by more than 1e-5 (a one-ulp
        crossing: summation order moved m across a bf16 rounding
        boundary) on at most 0.1% of them; ``xla_check``, the same rule
        for XLA's roundings, for the ``bf16_xla`` instances.  ``to_nhwc``
        brings a channel-major output to NHWC for that check."""
        got, ref = fn(), plain_fn()
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        if offset is None:
            tol, ok = f"tol {F32_TOL:.0e}", err <= F32_TOL
        else:
            if to_nhwc is not None:
                got, ref = to_nhwc(got), to_nhwc(ref)
            ok, worst, crossings = check(got, ref, offset)
            cap = MAX_CROSSING_SHARE * got.numel()
            tol = (f"worst err / (2^-7*ulp terms + 1e-5) = {worst:.4f} <= "
                   f"1.001, crossings {crossings} of {got.numel()} <= "
                   f"{cap:.0f}")
        return record(name, shape, err, tol, ok, cuda_ms(fn),
                      cuda_ms(plain_fn),
                      None if library_fn is None else cuda_ms(library_fn),
                      bound_of(got), fn)

    # Layer 1's instances on the prod net's folded layer: f32, K1's
    # (Pallas numerics, its gamma / sqrt BN) and XLA's (gamma * rsqrt).
    for precision, numerics in (("float32", "pallas"),
                                ("bfloat16_full", "pallas"),
                                ("bfloat16_full", "xla")):
        net, _ = load_default_net(dev, precision)
        layer = net.conv.conv_layers[0]
        cd = None if precision == "float32" else precision
        inst = conv1_instance(cd, numerics)[0]
        bias1 = layer.conv.bias
        s1, t1 = bn_scale_offset(layer.bn.running_mean, layer.bn.running_var,
                                 layer.bn.weight, layer.bn.bias,
                                 rsqrt=inst != "bf16")
        kernel1 = (fold_preprocess(net.state_dict())
                   ["conv.conv_layers.0.conv.weight"].permute(2, 3, 1, 0)
                   .contiguous())
        op = "bf16" if cd else "f32"
        if cd:
            kernel1 = kernel1.to(torch.bfloat16)
        kw1 = {"compute_dtype": cd, "numerics": numerics}
        for h, w in ((144, 256), (143, 256)):
            x = torch.from_numpy(rng.integers(0, 256, (BATCH, h, w, 3),
                                              dtype=np.uint8)).to(dev)
            args = (x, kernel1, bias1, s1, t1)
            out = compare(
                f"conv1_block[{inst}]", (BATCH, h, w, 3),
                lambda: conv1_block(*args, **kw1),
                lambda: conv1_block_plain(*args, **kw1),
                library_conv(x, kernel1, bias1, getattr(torch, {
                    "f32": "float32", "bf16": "bfloat16"}[op])),
                lambda o: bound((x, kernel1), o, h, w, 3, 48, op),
                offset=t1 if cd else None,
                check=xla_for(s1, bias1) if inst == "bf16_xla"
                else bf16_check)
            if h == 144:
                results[f"conv1_block[{inst}]"] = out

    for h, w in ((48, 85), (16, 28)):
        cin = cout = 48
        x = torch.from_numpy(rng.normal(0, 1, (BATCH, h, w, cin))
                             .astype(np.float32)).to(dev)
        k = torch.from_numpy(rng.normal(0, 0.1, (3, 3, cin, cout))
                             .astype(np.float32)).to(dev)
        bias = torch.from_numpy(rng.normal(0, 0.1, cout)
                                .astype(np.float32)).to(dev)
        s, t = (torch.from_numpy(a).to(dev) for a in _bn(rng, cout))
        for (cd, out_dtype, numerics), (inst, dtype) in cb.INSTANCES.items():
            args = (x.to(dtype), k.to(dtype), bias, s, t)
            kw = {"compute_dtype": cd, "out_dtype": out_dtype,
                  "numerics": numerics or "pallas"}
            op = "f32" if cd is None else "bf16"
            out = compare(
                f"conv_block[{inst}]", (BATCH, h, w, cin),
                lambda: cb.conv_block(*args, **kw),
                lambda: cb.conv_block_plain(*args, **kw),
                library_conv(args[0], args[1], bias, torch.float32
                             if cd is None else torch.bfloat16),
                lambda o: bound(args[:2], o, h, w, cin, cout, op),
                offset=t if cd == "bfloat16_full" else None,
                check=xla_for(s, bias) if numerics == "xla" else bf16_check)
            if h == 48:
                results[f"conv_block[{inst}]"] = out

        # K4 through its wrapper, channel-major in and out (no permute), at
        # both out dtypes: bf16 input and kernel, as the kernel reads them.
        gamma = torch.from_numpy(rng.normal(1, 0.1, cout)
                                 .astype(np.float32)).to(dev)
        beta = torch.from_numpy(rng.normal(0, 0.1, cout)
                                .astype(np.float32)).to(dev)
        mean = torch.from_numpy(rng.normal(0, 0.5, cout)
                                .astype(np.float32)).to(dev)
        var = torch.from_numpy(rng.uniform(0.5, 2, cout)
                               .astype(np.float32)).to(dev)
        xcm = x.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous()
        kbf = k.to(torch.bfloat16)
        k4_args = (xcm, kbf, bias, gamma, beta, mean, var)
        t4 = cb._k4_affine(gamma, beta, mean, var)[1]
        for out_dtype, inst in cb.CM_INSTANCES.items():
            k4_kw = {"out_dtype": out_dtype, "nhwc_out": False,
                     "channel_major_in": True}
            out = compare(
                f"conv_block[{inst}]", (BATCH, cin, h, w),
                lambda: cb.fused_conv_block(*k4_args, **k4_kw),
                lambda: cb.fused_conv_block_plain(*k4_args, **k4_kw),
                library_conv(x, k, bias, torch.bfloat16),
                lambda o: bound((xcm, kbf), o, h, w, cin, cout, "bf16"),
                offset=t4, to_nhwc=lambda a: a.permute(0, 2, 3, 1))
            if h == 48:
                results[f"conv_block[{inst}]"] = out

    results.update(i8_kernels(dev, rng, record, library_conv, bound))

    gen = torch.Generator(device=dev).manual_seed(0)
    raw = torch.randint(0, 256, (BATCH, *SRC_HW, 3), generator=gen,
                        device=dev, dtype=torch.uint8)
    got = resize_normalize(raw, *MODEL_HW)
    ref = resize_normalize_plain(raw, *MODEL_HW)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    # Bytes bound (2 taps per axis, ~8 FLOP per output value, is far
    # below the memory line): the source rows the vertical taps read,
    # whole (the horizontal taps touch every 32-byte sector of a row at
    # this 5x downscale), and the output.
    rows = int((_resize_matrices(*SRC_HW, *MODEL_HW)[0] != 0).any(0).sum())
    nbytes = BATCH * rows * SRC_HW[1] * 3 + got.numel() * got.element_size()
    # The library's yardstick: one bilinear F.interpolate (half-pixel
    # centres, no antialias) of the frames as f32 channels-last NCHW, made
    # outside the timed call; its output, flipped to RGB and over 255, is
    # held against the plain version's by K5's tolerance and reported.
    src = raw.permute(0, 3, 1, 2).float().contiguous(
        memory_format=torch.channels_last)

    def interp():
        return F.interpolate(src, size=MODEL_HW, mode="bilinear",
                             align_corners=False)

    lib_err = (interp().flip(1).permute(0, 2, 3, 1) / 255.0
               - ref).abs().max().item()
    log(f"kernel resize_normalize: the library's F.interpolate (bilinear, "
        f"align_corners=False), flipped and over 255, differs from the "
        f"plain version by {lib_err:.3e} "
        f"({'within' if lib_err <= K5_TOL else 'beyond'} K5's tol "
        f"{K5_TOL:.0e})")
    results["resize_normalize"] = record(
        "resize_normalize", (BATCH, *SRC_HW, 3), err, f"tol {K5_TOL:.0e}",
        err <= K5_TOL, cuda_ms(lambda: resize_normalize(raw, *MODEL_HW)),
        cuda_ms(lambda: resize_normalize_plain(raw, *MODEL_HW)),
        cuda_ms(interp), (1e3 * nbytes / HBM_BYTES_PER_S, "bytes"),
        lambda: resize_normalize(raw, *MODEL_HW))
    results["yuv420_to_bgr"] = yuv_kernel(dev, record)
    for name, row in results.items():
        if name in EARLIER_MS:
            log(f"kernels: {name} at the main path's shape {row['ms']:.4f} "
                f"ms (earlier {EARLIER_MS[name]})")
    log(f"kernels: launches so far {read_launches()} (comparisons and "
        "timing only)")
    return results


def i8_im2col(x_i8, k_i8):
    """The int8 conv as one GEMM for ``torch._int_mm``: NHWC int8 ``x``
    as zero-padded im2col rows ``[B*H*W, K]`` in (dy, dx, c) order, and
    the HWIO kernel as ``[K, Cout]``, K = 9 * Cin zero-padded to a
    multiple of 8 (cuBLASLt's int8 GEMM needs it: layer 1's 27 -> 32)."""
    import torch.nn.functional as F

    b, h, w, c = x_i8.shape
    k = -(-9 * c // 8) * 8
    cols = F.pad(x_i8, (0, 0, 1, 1, 1, 1)).unfold(1, 3, 1).unfold(2, 3, 1)
    cols = cols.permute(0, 1, 2, 4, 5, 3).reshape(b * h * w, 9 * c)
    wmat = k_i8.reshape(9 * c, k_i8.shape[-1])
    return (F.pad(cols, (0, k - 9 * c)).contiguous(),
            F.pad(wmat, (0, 0, 0, k - 9 * c)).contiguous())


def i8_kernels(dev, rng, record, library_conv, bound):
    """The ``int8_mxu`` blocks against their plain versions with a max
    diff of 0, with the prod net's folded chain (weights, scales and
    rings as the step hands them over): layer 1 on a seeded batch of
    raw frames at 144x256, the mid-stack block on layer 1's codes at
    48x85 and on layer 2's at 16x28.  Rows at the main path's shapes
    (layer 1, layer 2): the library's yardstick is cuDNN's f32
    convolution of the same integer values (the shifted pixels or the
    codes, and the int8 weights), TF32 off, the conv alone; beside it
    (``int_mm_ms``) ``torch._int_mm`` of the conv as a GEMM on an
    im2col made outside the timed call, its int32 sums checked against
    the plain ones on two frames; the bound counts the ops on the int8
    peak.  The earlier design's times are printed beside each shape's."""
    from cut_detection_tpu_torch.models.assembly import (
        GluedNet,
        fold_preprocess,
        load_default_net,
        precompute_rings,
    )
    from cut_detection_tpu_torch.ops.kernels import conv_block_i8 as k8
    from cut_detection_tpu_torch.ops.nn import conv2d_same_i8_plain

    base, _ = load_default_net(dev, "int8_mxu")
    net = GluedNet(base.model_params, "int8_mxu")
    net.load_state_dict(fold_preprocess(base.state_dict()))
    net.to(dev)
    h, w = MODEL_HW
    rings = precompute_rings(net, h, w)
    x = torch.from_numpy(rng.integers(0, 256, (BATCH, h, w, 3),
                                      dtype=np.uint8)).to(dev)
    out, affine = {}, None
    entries = ((k8.conv1_block_i8, k8.conv1_block_i8_plain, "conv1_block"),
               (k8.conv_block_i8, k8.conv_block_i8_plain, "conv_block"),
               (k8.conv_block_i8, k8.conv_block_i8_plain, "conv_block"))
    for (fn, plain, name), layer, ring in zip(entries, net.conv.conv_layers,
                                              rings):
        k, so, scale = layer.i8_args(affine)
        affine = layer.i8_pending_affine()
        args = (x, k, so, ring, scale)
        got, ref = fn(*args), plain(*args)
        torch.cuda.synchronize()
        err = (got.int() - ref.int()).abs().max().item()
        b, hh, ww, cin = x.shape
        ints = (x.float() - 128.0) if x.dtype == torch.uint8 else x.float()
        zero = torch.zeros(k.shape[-1], device=dev)
        row = record(f"{name}[i8]", tuple(x.shape), float(err), "max diff 0",
                     err == 0, cuda_ms(lambda: fn(*args)),
                     cuda_ms(lambda: plain(*args)),
                     cuda_ms(library_conv(ints, k.float(), zero,
                                          torch.float32)),
                     bound((x, k, so, ring, scale), got, hh, ww, cin,
                           k.shape[-1], "i8"),
                     lambda: fn(*args))
        x_i8 = ints.to(torch.int8)
        cols, wmat = i8_im2col(x_i8, k)
        sums = torch._int_mm(cols[:2 * hh * ww], wmat)
        want = conv2d_same_i8_plain(x_i8[:2], k).reshape(sums.shape)
        if not torch.equal(sums, want):
            raise AssertionError(f"torch._int_mm's sums at {tuple(x.shape)} "
                                 "differ from the plain conv's")
        row["int_mm_ms"] = cuda_ms(lambda: torch._int_mm(cols, wmat))
        del cols
        was = EARLIER_I8_MS[(hh, ww)]
        log(f"kernel {name}[i8] {tuple(x.shape)}: torch._int_mm "
            f"{tuple(wmat.shape)} GEMM {row['int_mm_ms']:.4f} ms (its sums "
            f"equal the plain conv's on two frames); the __dp4a design "
            f"{was[0]} ms, {was[1]} ms streamed")
        out.setdefault(f"{name}[i8]", row)
        x = got
    return out


def yuv_kernel(dev, record):
    """``yuv420_to_bgr`` against its plain version at the main path's
    shape, a seeded batch of 128 planes at 144x256, with a max diff of
    0; then against the host's numpy twin with 0 bytes apart on the
    exhaustive probe (one 4096x4096 image holding every (Y, U, V)
    combination: the vector route), on the same planes 2 bytes past a
    16-byte boundary and cropped to 4096x4090 (the scalar route, as a
    base or a width off 16 takes); its row, timed at the main path's
    shape, with the times streamed from cold L2 (``stream_ms`` over
    rotating inputs, at the host's pace and queued) and the wrapper's
    host time a call beside it."""
    from cut_detection_tpu_torch.geometry import yuv420_nbytes
    from cut_detection_tpu_torch.ops.kernels.yuv420_to_bgr import (
        yuv420_to_bgr,
        yuv420_to_bgr_plain,
    )
    from cut_detection_tpu_torch.ops.yuv import (
        exhaustive_probe,
        pack_yuv420,
        yuv420_to_bgr_np,
    )

    h, w = MODEL_HW
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(0, 256, (BATCH, yuv420_nbytes(h, w)),
                                      dtype=np.uint8)).to(dev)
    got = yuv420_to_bgr(x, h, w)
    ref = yuv420_to_bgr_plain(x, h, w)
    torch.cuda.synchronize()
    err = (got.int() - ref.int()).abs().max().item()
    y, u, v = exhaustive_probe()
    side, cropped = y.shape[1], y.shape[1] - 6
    wants = {}
    for what, planes, pw, offset in (
            ("exhaustive 2^24 (Y, U, V) probe", (y, u, v), side, 0),
            ("the probe 2 bytes past a 16-byte boundary", (y, u, v), side,
             2),
            ("the probe cropped to a width off 16",
             (y[:, :cropped], u[:, :cropped // 2], v[:, :cropped // 2]),
             cropped, 0)):
        flat = pack_yuv420(*planes)
        if pw not in wants:
            wants[pw] = yuv420_to_bgr_np(flat, side, pw)
        buf = torch.zeros(offset + flat.size, dtype=torch.uint8, device=dev)
        buf[offset:] = torch.from_numpy(flat).to(dev)
        out = yuv420_to_bgr(buf[offset:][None], side, pw)[0].cpu().numpy()
        bad = int((out != wants[pw]).sum())
        log(f"kernel yuv420_to_bgr: {what}, {side}x{pw}, {bad} bytes differ "
            f"from the host's numpy twin {'OK' if bad == 0 else 'FAIL'}")
        if bad:
            raise AssertionError(f"yuv420_to_bgr: {bad} bytes of {what} "
                                 "differ from yuv420_to_bgr_np")
    del wants, buf
    # Bytes bound: the planes read once, the BGR frames written once; a
    # few integer operations a byte are far below the ALU rate.
    nbytes = x.numel() + got.numel()
    bound = (1e3 * nbytes / HBM_BYTES_PER_S, "bytes")
    row = record("yuv420_to_bgr", tuple(x.shape), float(err), "max diff 0",
                 err == 0, cuda_ms(lambda: yuv420_to_bgr(x, h, w)),
                 cuda_ms(lambda: yuv420_to_bgr_plain(x, h, w)), None, bound,
                 lambda: yuv420_to_bgr(x, h, w))
    # Cold L2: n input planes and n + 1 outputs rotating through 3x the
    # card's L2 (n = 8 at the main path's shape on an H100's 50 MB).
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    n = -(-3 * l2 // nbytes)
    inputs = [x] + [torch.from_numpy(rng.integers(
        0, 256, tuple(x.shape), dtype=np.uint8)).to(dev) for _ in range(n - 1)]
    for key, queued in (("cold_stream_ms", False),
                        ("card_cold_stream_ms", True)):
        row[key] = stream_ms(lambda t: yuv420_to_bgr(t, h, w), inputs,
                             launches=64, queued=queued)
    # What moving the same bytes costs the card: a clone of half of them
    # (read once, written once), queued, warm and from cold L2.  No
    # PyTorch call computes the conversion, so it is no library row.
    halves = [torch.zeros(nbytes // 2, dtype=torch.uint8, device=dev)
              for _ in inputs]
    copy_ms = (stream_ms(halves[0].clone, queued=True),
               stream_ms(lambda t: t.clone(), halves, launches=64,
                         queued=True))
    del halves
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    for _ in range(200):
        yuv420_to_bgr(x, h, w)
    host_ms = 1e3 * (time.perf_counter() - t0) / 200
    torch.cuda.synchronize()
    log(f"kernel yuv420_to_bgr: streamed from cold L2 ({n} inputs, "
        f"{n * nbytes / 1e6:.1f} MB rotating) {row['cold_stream_ms']:.4f} "
        f"ms a call, {row['card_cold_stream_ms']:.4f} queued: "
        f"{bound[0] / row['card_cold_stream_ms']:.1%} of the bound (warm "
        f"L2: {row['stream_ms']:.4f} streamed, {row['card_stream_ms']:.4f} "
        f"queued, {bound[0] / row['card_stream_ms']:.1%}); the wrapper's "
        f"host time {host_ms:.4f} ms a call; a clone of {nbytes // 2:,} B "
        f"(the same bytes moved) {copy_ms[0]:.4f} ms queued, "
        f"{copy_ms[1]:.4f} from cold L2; the first design "
        f"{EARLIER_YUV_MS[0]} ms one call, {EARLIER_YUV_MS[1]} streamed, "
        f"{EARLIER_YUV_MS[2]} a batch in the trace")
    return row


def synthetic_frames(n: int, h: int = 144, w: int = 256,
                     seed: int = 42) -> np.ndarray:
    """Blocks of base colours plus noise, so the classes vary over time."""
    rng = np.random.default_rng(seed)
    blocks = [(0.3, (40, 120, 40)), (0.1, (10, 10, 10)),
              (0.3, (150, 60, 60)), (0.05, (200, 200, 200)),
              (0.25, (60, 60, 140))]
    frames = []
    for frac, colour in blocks:
        k = max(1, int(round(frac * n)))
        base = np.array(colour, np.int16)
        noise = rng.integers(0, 30, (k, h, w, 3), dtype=np.int16)
        frames.append(np.clip(base + noise, 0, 255).astype(np.uint8))
    return np.concatenate(frames)[:n]


def _csv_bytes(conf, pred, path):
    from cut_detection_tpu_torch.pipeline import _smooth

    _smooth(conf, pred, 100, 10).write_csv(path)
    with open(path, "rb") as f:
        return f.read()


def _wrappers():
    """Every kernel wrapper of the port, by name; each counts its own
    kernel launches in ``launches`` and, where it has several instances,
    by instance in ``instance_launches``."""
    from cut_detection_tpu_torch.ops.kernels.conv1_block import conv1_block
    from cut_detection_tpu_torch.ops.kernels.conv_block import conv_block
    from cut_detection_tpu_torch.ops.kernels.resize_normalize import (
        resize_normalize,
    )
    from cut_detection_tpu_torch.ops.kernels.yuv420_to_bgr import (
        yuv420_to_bgr,
    )

    from cut_detection_tpu_torch.ops.kernels.conv_block_i8 import (
        conv1_block_i8,
        conv_block_i8,
    )

    return {"conv1_block": conv1_block, "conv_block": conv_block,
            "resize_normalize": resize_normalize,
            "yuv420_to_bgr": yuv420_to_bgr,
            "conv1_block[i8]": conv1_block_i8,
            "conv_block[i8]": conv_block_i8}


def zero_launches() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
        for inst in getattr(fn, "instance_launches", {}):
            fn.instance_launches[inst] = 0


def read_launches() -> dict:
    """Launches by instance (``"conv1_block[bf16]"``, ...); a wrapper's
    total must be the sum of its instances'."""
    out = {}
    for name, fn in _wrappers().items():
        per = getattr(fn, "instance_launches", None)
        if per is None:
            out[name] = fn.launches
            continue
        if sum(per.values()) != fn.launches:
            raise AssertionError(f"{name}: {fn.launches} launches but "
                                 f"{per} by instance")
        out.update({f"{name}[{inst}]": n for inst, n in per.items()})
    return out


# Launches per batch by instance of each path: (precision, fused
# preprocess) -> {instance: launches}.
PATH_LAUNCHES = {
    ("float32", False): {"conv1_block[f32]": 1, "conv_block[f32]": 2},
    ("float32", True): {"resize_normalize": 1, "conv_block[f32]": 3},
    ("bfloat16", False): {"conv1_block[f32]": 1,
                          "conv_block[bf16_operands]": 2},
    ("bfloat16", True): {"resize_normalize": 1,
                         "conv_block[bf16_operands]": 3},
    # XLA's numerics: the last block keeps its BN sum in f32 for the head.
    ("bfloat16_full", False): {"conv1_block[bf16_xla]": 1,
                               "conv_block[bf16_xla]": 1,
                               "conv_block[bf16_xla_f32]": 1},
    ("bfloat16_full", True): {"resize_normalize": 1,
                              "conv_block[bf16_xla]": 2,
                              "conv_block[bf16_xla_f32]": 1},
    # The quantized rungs are plain PyTorch: no hand-written kernel on
    # the default path, the resize kernel alone with the fused preprocess.
    ("uint8_pool", False): {},
    ("uint8_pool", True): {"resize_normalize": 1},
    ("uint8_chain", False): {},
    ("uint8_chain", True): {"resize_normalize": 1},
    # The int8 blocks; after the fused preprocess layer 1 is dense (plain
    # PyTorch) and the mid-stack blocks int8.
    ("int8_mxu", False): {"conv1_block[i8]": 1, "conv_block[i8]": 2},
    ("int8_mxu", True): {"resize_normalize": 1, "conv_block[i8]": 2},
}
QUANTIZED = ("uint8_pool", "uint8_chain", "int8_mxu")


def per_batch(n: int, precision: str = "float32", fused: bool = False,
              yuv: bool = False) -> dict:
    """The launches by instance that ``n`` batches of a path should make;
    ``yuv``: the yuv420 transfer, one ``yuv420_to_bgr`` a batch first."""
    want = dict.fromkeys(read_launches(), 0)
    for inst, k in PATH_LAUNCHES[(precision, fused)].items():
        want[inst] = k * n
    if yuv:
        want["yuv420_to_bgr"] = n
    return want


def check_launches(what: str, got: dict, want: dict) -> None:
    if got != want:
        raise AssertionError(f"{what}: expected launches {want}, got {got}")


def phase_slice(dev, frames, workdir, precision: str = "float32",
                tag: str = "slice"):
    """The slice stream through the device loop at ``precision`` on the
    card and on the CPU: identical classes and CSV bytes, confidences
    within the rung's tolerance, the launches by instance checked and
    returned."""
    from cut_detection_tpu_torch.models.assembly import load_default_net
    from cut_detection_tpu_torch.pipeline import (
        batch_frames,
        classify_batches,
    )

    n = len(frames)
    tol = (CONF_TOL if precision == "float32" else QUANT_CONF_TOL
           if precision in QUANTIZED else BF16_CONF_TOL)
    net_gpu, _ = load_default_net(dev, precision)
    net_cpu, _ = load_default_net("cpu", precision)

    def run(net):
        return classify_batches(batch_frames(iter(frames), BATCH), net,
                                batch_size=BATCH, length=n, print_every=0)

    conf_cpu, pred_cpu, _ = run(net_cpu)

    zero_launches()
    conf_gpu, pred_gpu, stats = run(net_gpu)
    launches = read_launches()
    n_batches = stats.batches
    log(f"{tag}: {precision}, {n} frames in {n_batches} batches of {BATCH}, "
        f"launches {launches}")
    check_launches(f"{tag} {precision}", launches,
                   per_batch(n_batches, precision))

    if not np.array_equal(pred_gpu, pred_cpu):
        bad = int(np.count_nonzero(pred_gpu != pred_cpu))
        raise AssertionError(f"{precision}: {bad} class flips between card "
                             "and CPU")
    conf_err = float(np.abs(conf_gpu - conf_cpu).max())
    if conf_err > tol:
        raise AssertionError(f"{precision}: conf differs by {conf_err} > "
                             f"{tol}")
    csv_gpu = _csv_bytes(conf_gpu, pred_gpu, os.path.join(workdir, "g.csv"))
    csv_cpu = _csv_bytes(conf_cpu, pred_cpu, os.path.join(workdir, "c.csv"))
    if csv_gpu != csv_cpu:
        raise AssertionError(f"{precision}: card CSV differs from the CPU "
                             "CSV")
    n_segments = csv_gpu.count(b"\n")
    log(f"{tag}: {precision}, pred identical, conf max_abs_err "
        f"{conf_err:.3e} (tol {tol:.0e}), CSV identical ({n_segments} "
        f"segments), classes {np.bincount(pred_gpu, minlength=3).tolist()}")
    return launches


def phase_precision(dev, frames, workdir):
    """The slice stream at the bf16 and quantized rungs: each checked as
    the float32 slice is (card against CPU, launches by instance: none at
    the quantized rungs), then each rung's step on a resident batch
    beside float32's (CUDA events) and its loop of 20 batches from host
    memory, and for the quantized rungs (plain PyTorch) the loop under a
    trace, which names the library kernels their time goes to.  Returns
    the launches of each rung's run."""
    from cut_detection_tpu_torch.models.assembly import load_default_net
    from cut_detection_tpu_torch.pipeline import (
        batch_frames,
        classify_batches,
        make_classify_step,
    )

    rungs = ("bfloat16", "bfloat16_full", *QUANTIZED)
    launches = {p: phase_slice(dev, frames, workdir, p, tag="precision")
                for p in rungs}
    resident = torch.from_numpy(np.stack(frames[:BATCH])).to(dev)
    n, reps = len(frames), 20
    for precision in ("float32", *rungs):
        net, _ = load_default_net(dev, precision)
        step = make_classify_step(net)

        def loop():
            stream = (frames[i % n] for i in range(reps * BATCH))
            return classify_batches(batch_frames(stream, BATCH), net,
                                    batch_size=BATCH, length=reps * BATCH,
                                    print_every=0)

        loop()  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        log(f"precision: {precision}, step on a resident batch of {BATCH} "
            f"{cuda_ms(lambda: step(resident)):.4f} ms (CUDA events; "
            f"earlier {EARLIER_STEP_MS.get(precision, 'none')}); loop of "
            f"{reps} batches from host memory "
            f"{1e3 * reps * BATCH / wall_ms:.1f} frames/s (earlier "
            f"{EARLIER_FPS.get(precision, 'none')}), {wall_ms / reps:.4f} "
            "ms per batch")
        if precision in QUANTIZED:
            trace_loop(f"precision {precision}", loop, reps)
    return launches


def host_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` on the host clock, up to a
    synchronise of the card."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def _trace_device_ms(prof):
    """From a ``torch.profiler`` trace: the device's busy milliseconds in
    kernels (the union of their intervals), in copies and memsets, and
    ``{kernel name: (ms, launches)}``."""
    kernels, copies, per_name = [], [], {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        span = (evt.time_range.start, evt.time_range.end)
        if evt.name.startswith(("Memcpy", "Memset")):
            copies.append(span)
            continue
        kernels.append(span)
        ms, count = per_name.get(evt.name, (0.0, 0))
        per_name[evt.name] = (ms + (span[1] - span[0]) / 1e3, count + 1)

    def union_ms(spans):
        total, end = 0.0, float("-inf")
        for lo, hi in sorted(spans):
            if hi > end:
                total += hi - max(lo, end)
                end = hi
        return total / 1e3

    return union_ms(kernels), union_ms(copies), per_name


def host_breakdown(tag: str, dev, net, step, items, **opts) -> dict:
    """Where a loop's time per batch goes: ``classify_batches`` over
    ``batch_frames`` of ``items`` in host memory, 20 batches, timed;
    each of its pieces timed alone (the stack, the pageable upload, the
    pinned upload, the step on a resident batch); then the loop under
    ``torch.profiler`` for the card's busy share.  ``opts`` go to
    ``classify_batches`` (``yuv_dims``).  Returns the figures."""
    from cut_detection_tpu_torch.pipeline import (
        batch_frames,
        classify_batches,
    )

    n, reps = len(items), 20
    listed = list(items[:BATCH])
    batch = np.stack(listed)
    resident = torch.from_numpy(batch).to(dev)
    pinned = torch.from_numpy(batch).pin_memory()

    def loop():
        stream = (items[i % n] for i in range(reps * BATCH))
        return classify_batches(batch_frames(stream, BATCH), net,
                                batch_size=BATCH, length=reps * BATCH,
                                print_every=0, **opts)

    loop()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, stats = loop()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    batch_ms = wall_ms / reps
    out = {"fps": 1e3 * reps * BATCH / wall_ms, "batch_ms": batch_ms}
    log(f"{tag}: loop, {reps} batches of {BATCH} from host memory: "
        f"{out['fps']:.1f} frames/s end to end (steady "
        f"{stats.steady_frames_per_sec:.1f}), {batch_ms:.4f} ms per batch")
    pieces = (
        ("stack", "np.stack of the batch's items (batch_frames)",
         host_ms(lambda: np.stack(listed))),
        ("upload", f"synchronous pageable upload of {batch.nbytes:,} B "
         "(the loop's)", host_ms(lambda: torch.from_numpy(batch).to(dev))),
        ("pinned", "upload from pinned memory (not used yet)",
         host_ms(lambda: pinned.to(dev, non_blocking=True))),
        ("step", "device step on a resident batch (CUDA events)",
         cuda_ms(lambda: step(resident))),
    )
    for key, name, ms in pieces:
        out[key] = ms
        log(f"{tag}:   {name}: {ms:.4f} ms alone, "
            f"{100 * ms / batch_ms:.1f}% of the batch")
    out["busy"] = trace_loop(tag, loop, reps)
    return out


def phase_host(dev, frames):
    """Where the slice loop's time per batch goes (``host_breakdown`` of
    the float32 bgr loop); returns its figures."""
    from cut_detection_tpu_torch.models.assembly import load_default_net
    from cut_detection_tpu_torch.pipeline import make_classify_step

    net, _ = load_default_net(dev)
    out = host_breakdown("host", dev, net, make_classify_step(net), frames)
    log(f"host: earlier {EARLIER_FPS['loop']} frames/s, step "
        f"{EARLIER_STEP_MS['host']} ms")
    return out


def trace_loop(tag: str, loop, reps: int) -> float | None:
    """Run ``loop`` (``reps`` batches) under ``torch.profiler`` and log the
    card's busy share and the costliest kernels per batch; return the
    busy share in percent (None if the trace holds no kernel)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loop()
        torch.cuda.synchronize()
        traced_ms = 1e3 * (time.perf_counter() - t0)
    kernel_ms, copy_ms, per_name = _trace_device_ms(prof)
    if not per_name:
        log(f"{tag}: the trace holds no device kernels; busy share not "
            "measured")
        return None
    log(f"{tag}: under torch.profiler, {reps} batches in {traced_ms:.4f} "
        f"ms: kernels {kernel_ms:.4f} ms ({100 * kernel_ms / traced_ms:.1f}%"
        f" busy, from the trace), copies {copy_ms:.4f} ms "
        f"({100 * copy_ms / traced_ms:.1f}%)")
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:6]
    for name, (ms, count) in top:
        log(f"{tag}:   {ms / reps:.4f} ms per batch, {count} launches: "
            f"{name[:100]}")
    return 100 * kernel_ms / traced_ms


def phase_preprocess(dev):
    """The on-device preprocess paths at 720p, through the device loop.

    A seeded synthetic 1280x720 stream of ``2*BATCH+37`` frames from host
    memory (not through the decode ring, whose six source-resolution
    slots would take 2.1 GB of shared memory) goes through
    ``classify_batches`` with the resize on the card:

    - exact (``--device-resize``): ``pred`` and ``conf`` identical to the
      same frames resized on the host by the port's exact resize and
      sent through the default step;
    - fused (``--pallas-preprocess``): ``pred`` identical to the same
      path on the CPU (plain versions), ``conf`` within 1e-4.

    Each path's launches are counted over its run.  Then, per batch: the
    loop's frames/s for each path, the pieces of the loop timed alone,
    and each loop's busy share from a trace.  Returns the fused path's
    launch counts.
    """
    from cut_detection_tpu_torch.models.assembly import load_default_net
    from cut_detection_tpu_torch.ops.kernels.resize_normalize import (
        resize_normalize,
    )
    from cut_detection_tpu_torch.ops.resize import resize_bilinear
    from cut_detection_tpu_torch.pipeline import (
        batch_frames,
        classify_batches,
        make_classify_step,
    )

    n = 2 * BATCH + 37
    t0 = time.perf_counter()
    frames = synthetic_frames(n, *SRC_HW, seed=7)
    log(f"preprocess: {n} synthetic {SRC_HW[1]}x{SRC_HW[0]} frames made in "
        f"{time.perf_counter() - t0:.1f} s")
    net_gpu, _ = load_default_net(dev)
    net_cpu, _ = load_default_net("cpu")
    exact = {"device_resize": MODEL_HW}
    fused = {"device_resize": MODEL_HW, "pallas_preprocess": True}

    def run(net, stream, **opts):
        return classify_batches(batch_frames(iter(stream), BATCH), net,
                                batch_size=BATCH, length=len(stream),
                                print_every=0, **opts)

    zero_launches()
    conf, pred, stats = run(net_gpu, frames, **exact)
    got = read_launches()
    log(f"preprocess: exact path, {n} frames in {stats.batches} batches, "
        f"launches {got}")
    check_launches("exact path", got, per_batch(stats.batches))
    resized = resize_bilinear(torch.from_numpy(frames), *MODEL_HW).numpy()
    ref_conf, ref_pred, _ = run(net_gpu, resized)
    if not (np.array_equal(pred, ref_pred) and np.array_equal(conf,
                                                              ref_conf)):
        raise AssertionError("exact path differs from the host-resized "
                             "frames through the default step")
    log("preprocess: exact path, pred and conf identical to the frames "
        "resized on the host through the default step, classes "
        f"{np.bincount(pred, minlength=3).tolist()}")

    zero_launches()
    conf, pred, stats = run(net_gpu, frames, **fused)
    launches = read_launches()
    log(f"preprocess: fused path, {n} frames in {stats.batches} batches, "
        f"launches {launches}")
    check_launches("fused path", launches,
                   per_batch(stats.batches, fused=True))
    cpu_conf, cpu_pred, _ = run(net_cpu, frames, **fused)
    if not np.array_equal(pred, cpu_pred):
        bad = int(np.count_nonzero(pred != cpu_pred))
        raise AssertionError(f"fused path: {bad} class flips between card "
                             "and CPU")
    conf_err = float(np.abs(conf - cpu_conf).max())
    if conf_err > CONF_TOL:
        raise AssertionError(f"fused path: conf differs by {conf_err} > "
                             f"{CONF_TOL}")
    log(f"preprocess: fused path, pred identical to the CPU, conf "
        f"max_abs_err {conf_err:.3e} (tol {CONF_TOL:.0e}), classes "
        f"{np.bincount(pred, minlength=3).tolist()}")

    reps = 8
    listed = list(frames[:BATCH])
    batch = np.stack(listed)
    resident = torch.from_numpy(batch).to(dev)
    pinned = torch.from_numpy(batch).pin_memory()

    def loop(opts):
        stream = (frames[i % n] for i in range(reps * BATCH))
        return classify_batches(batch_frames(stream, BATCH), net_gpu,
                                batch_size=BATCH, length=reps * BATCH,
                                print_every=0, **opts)

    for name, opts in (("exact", exact), ("fused", fused)):
        loop(opts)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, st = loop(opts)
        wall_ms = 1e3 * (time.perf_counter() - t0)
        log(f"preprocess: {name} loop, {reps} batches of {BATCH} from host "
            f"memory: {1e3 * reps * BATCH / wall_ms:.1f} frames/s end to end"
            f" (steady {st.steady_frames_per_sec:.1f}), "
            f"{wall_ms / reps:.4f} ms per batch")
    step_exact = make_classify_step(net_gpu, **exact)
    step_fused = make_classify_step(net_gpu, **fused)
    pieces = (
        ("np.stack of the batch's frames (batch_frames)",
         host_ms(lambda: np.stack(listed))),
        (f"synchronous pageable upload of {batch.nbytes / 1e6:.1f} MB "
         "(the loop's)", host_ms(lambda: torch.from_numpy(batch).to(dev))),
        ("upload from pinned memory (not used yet)",
         host_ms(lambda: pinned.to(dev, non_blocking=True))),
        ("exact resize on the card (ops.resize, CUDA events)",
         cuda_ms(lambda: resize_bilinear(resident, *MODEL_HW))),
        ("resize_normalize kernel (CUDA events)",
         cuda_ms(lambda: resize_normalize(resident, *MODEL_HW))),
        ("exact-path step on a resident batch (CUDA events)",
         cuda_ms(lambda: step_exact(resident))),
        ("fused-path step on a resident batch (CUDA events)",
         cuda_ms(lambda: step_fused(resident))),
    )
    for name, ms in pieces:
        log(f"preprocess:   {name}: {ms:.4f} ms per batch")
    for name, opts in (("exact", exact), ("fused", fused)):
        trace_loop(f"preprocess {name}", lambda: loop(opts), reps)
    return launches


def yuv420_planes(frames: np.ndarray) -> np.ndarray:
    """Packed planar YUV420 of uint8 BGR frames (BT.601, limited range,
    chroma averaged over each 2x2 block): ``[n, yuv420_nbytes(h, w)]``
    uint8, the layout the native YUV decoder yields."""
    n, h, w, _ = frames.shape
    f = frames.astype(np.float32)
    b, g, r = f[..., 0], f[..., 1], f[..., 2]
    y = 16 + 0.257 * r + 0.504 * g + 0.098 * b
    u = 128 - 0.148 * r - 0.291 * g + 0.439 * b
    v = 128 + 0.439 * r - 0.368 * g - 0.071 * b

    def sub(c):
        return c.reshape(n, h // 2, 2, w // 2, 2).mean(axis=(2, 4))

    planes = np.concatenate([y.reshape(n, -1), sub(u).reshape(n, -1),
                             sub(v).reshape(n, -1)], axis=1)
    return np.clip(np.rint(planes), 0, 255).astype(np.uint8)


def phase_yuv420(dev, frames, host_bgr: dict):
    """The yuv420 transfer's device loop on the slice stream as packed
    planes (``yuv420_planes``), at every rung: one ``yuv420_to_bgr``
    launch a batch ahead of the rung's own, and conf and pred identical
    to the same loop on the planes converted on the host
    (``yuv420_to_bgr_np``).  Then ``host_breakdown`` of the float32
    loop on planes, printed beside the bgr loop's (``host_bgr``).
    Returns the float32 run's launches."""
    from cut_detection_tpu_torch.models.assembly import load_default_net
    from cut_detection_tpu_torch.ops.yuv import yuv420_to_bgr_np
    from cut_detection_tpu_torch.pipeline import (
        batch_frames,
        classify_batches,
        make_classify_step,
    )

    planes = yuv420_planes(frames)
    host = yuv420_to_bgr_np(planes, *MODEL_HW)
    n = len(planes)
    out = None
    for precision in ("float32", "bfloat16", "bfloat16_full", *QUANTIZED):
        net, _ = load_default_net(dev, precision)

        def run(stream, **opts):
            return classify_batches(batch_frames(iter(stream), BATCH), net,
                                    batch_size=BATCH, length=n,
                                    print_every=0, **opts)

        zero_launches()
        conf, pred, stats = run(planes, yuv_dims=MODEL_HW)
        launches = read_launches()
        check_launches(f"yuv420 {precision}", launches,
                       per_batch(stats.batches, precision, yuv=True))
        want_conf, want_pred, _ = run(host)
        same = (np.array_equal(pred, want_pred)
                and np.array_equal(conf, want_conf))
        log(f"yuv420: {precision}, {n} frames as planes in {stats.batches} "
            f"batches: launches {launches}; conf and pred "
            f"{'identical to' if same else 'DIFFER from'} the loop on the "
            "planes converted on the host, classes "
            f"{np.bincount(pred, minlength=3).tolist()}")
        if not same:
            raise AssertionError(f"yuv420 {precision}: the loop on planes "
                                 "differs from the host-converted loop")
        if precision == "float32":
            out = launches
    net, _ = load_default_net(dev)
    yuv = host_breakdown("yuv420", dev, net,
                         make_classify_step(net, yuv_dims=MODEL_HW),
                         list(planes), yuv_dims=MODEL_HW)
    for key, unit in (("fps", "frames/s"), ("batch_ms", "ms per batch"),
                      ("stack", "ms stack"), ("upload", "ms pageable upload"),
                      ("pinned", "ms pinned upload"), ("step", "ms step"),
                      ("busy", "% busy")):
        a, b = yuv[key], host_bgr[key]
        log(f"yuv420 vs bgr: {unit}: "
            f"{'not measured' if a is None else f'{a:.4f}'} against "
            f"{'not measured' if b is None else f'{b:.4f}'}")
    return out


PREPROCESS_FLAGS = ([], ["--device-resize"],
                    ["--device-resize", "--pallas-preprocess"])
# (clip, reference CSV, frames) of the committed golden clips.
GOLDEN_CLIPS = (("clip.mp4", "ref_segments.csv", 220),
                ("clip_odd.mp4", "ref_segments_odd.csv", 200))
# (clip, frames, frame-accuracy gate) of the labelled eval corpus, with
# boundary precision and recall >= 0.90 on each: the JAX package's gates
# (tests/test_eval_corpus.py), corpus_adv's lower for its two blocks on
# a class boundary; corpus_nat must be exact at bfloat16_full.
CORPUS_RUNS = (("corpus_a", 590, 0.99), ("corpus_adv", 593, 0.96),
               ("corpus_nat", 590, 0.99))
# (clip, frames) of the eval corpus under the yuv420 transfer: the JAX
# package's gate for it (tests/test_eval_corpus.py:
# test_yuv420_transfer_holds_accuracy, frame accuracy >= 0.99, boundary
# precision and recall >= 0.90), at float32 and uint8_chain.
YUV_CORPUS = (("corpus_a", 590), ("corpus_b", 535), ("corpus_c", 540),
              ("corpus_nat", 590))


def _cli_run(cli_main, video, out, precision, flags, frames,
             transfer="bgr"):
    """The CLI's own entry point on ``video`` (``frames`` long), in this
    process so that its kernel launches are counted and checked against
    the path's over its ``ceil(frames / BATCH)`` batches.  A ``transfer``
    other than bgr must take the yuv420 path (``auto`` where the native
    YUV decoder is built): one ``yuv420_to_bgr`` launch a batch too."""
    zero_launches()
    t0 = time.perf_counter()
    cli_main([video, "--transfer", transfer, "--output_path", out,
              "--print-every", "0", "--precision", precision, *flags])
    wall = time.perf_counter() - t0
    launches = read_launches()
    check_launches(f"{os.path.basename(video)} {precision} {transfer} "
                   f"{flags}", launches,
                   per_batch(-(-frames // BATCH), precision,
                             "--pallas-preprocess" in flags,
                             yuv=transfer != "bgr"))
    return wall, launches


def phase_golden(workdir):
    from cut_detection_tpu_torch.cli.evaluate import evaluate
    from cut_detection_tpu_torch.cli.segment_video import main as cli_main
    from cut_detection_tpu_torch.pipeline import available_decoder

    decoder = available_decoder()
    if decoder is None:
        log("golden: no video decoder on this machine (neither cv2 nor the "
            "native decoder); golden-clip phase not run")
        return
    log(f"golden: decoder {decoder}")
    extra = [] if decoder == "cv2" else ["--decoder", "native",
                                         "--decode-process", "off"]
    for precision in ("float32", "bfloat16", "bfloat16_full", *QUANTIZED):
        for flags in PREPROCESS_FLAGS:
            # float32 runs every flag set on both clips, the bf16 rungs
            # every flag set on clip.mp4 and the default on clip_odd.mp4,
            # the quantized rungs the default on both (their preprocess
            # paths are the bf16 rungs' code, held by the CPU tests).
            if flags and precision in QUANTIZED:
                continue
            # The fast rungs promise accuracy, not bytes; the float
            # bilinear resize of --pallas-preprocess is held by frame
            # accuracy there, the rest byte for byte.
            exact = precision == "float32" or \
                "--pallas-preprocess" not in flags
            for clip, ref, n in GOLDEN_CLIPS:
                if flags and precision != "float32" and clip != "clip.mp4":
                    continue
                out = os.path.join(workdir, clip + ".csv")
                ref = os.path.join(GOLDEN, ref)
                wall, launches = _cli_run(
                    cli_main, os.path.join(GOLDEN, clip), out, precision,
                    flags + extra, n)
                with open(out, "rb") as f, open(ref, "rb") as g:
                    same = f.read() == g.read()
                acc = evaluate(out, ref, n)["frame_accuracy"]
                log(f"golden: {clip} {precision} "
                    f"{' '.join(flags) or '(no preprocess flag)'} -> "
                    f"{'byte-identical to' if same else 'DIFFERS from'} "
                    f"{os.path.basename(ref)}, frame accuracy {acc} "
                    f"({wall:.1f} s, launches {launches})")
                if not (same if exact else acc >= 0.99):
                    raise AssertionError(
                        f"{clip} {precision} {flags}: CSV differs from "
                        f"{os.path.basename(ref)}")
    # Every corpus clip at the bf16 rungs and int8_mxu, corpus_a and
    # corpus_nat at the uint8 rungs.
    corpus = [(p, run) for p in ("bfloat16", "bfloat16_full", "int8_mxu")
              for run in CORPUS_RUNS]
    corpus += [(p, run) for p in ("uint8_pool", "uint8_chain")
               for run in CORPUS_RUNS if run[0] in ("corpus_a", "corpus_nat")]
    for precision, (name, n, frame_min) in corpus:
        out = os.path.join(workdir, name + ".csv")
        wall, launches = _cli_run(
            cli_main, os.path.join(CORPUS, name + ".mp4"), out,
            precision, extra, n)
        res = evaluate(out, os.path.join(CORPUS, name + "_truth.csv"),
                       n, tolerance=30)
        if name == "corpus_nat" and precision != "bfloat16":
            frame_min = 1.0
        ok = (res["frame_accuracy"] >= frame_min
              and res["boundary_precision"] >= 0.90
              and res["boundary_recall"] >= 0.90)
        log(f"corpus: {name} {precision} -> frame accuracy "
            f"{res['frame_accuracy']} (gate {frame_min}), boundary P/R "
            f"{res['boundary_precision']}/{res['boundary_recall']} "
            f"(gate 0.9) {'OK' if ok else 'FAIL'} ({wall:.1f} s, "
            f"launches {launches})")
        if not ok:
            raise AssertionError(f"{name} {precision} fails its gate: "
                                 f"{res}")
    golden_options(cli_main, workdir, extra)
    golden_yuv(cli_main, evaluate, workdir, extra)


def golden_options(cli_main, workdir, extra):
    """``--device-glue`` at float32 on both golden clips (the host glue's
    bytes, which are the reference's), then ``--profile DIR`` on
    ``clip.mp4``: the reference's bytes and one trace file in DIR that
    holds the card's kernels."""
    for clip, ref, n in GOLDEN_CLIPS:
        out = os.path.join(workdir, clip + ".csv")
        wall, launches = _cli_run(cli_main, os.path.join(GOLDEN, clip), out,
                                  "float32", ["--device-glue", *extra], n)
        with open(out, "rb") as f, open(os.path.join(GOLDEN, ref), "rb") as g:
            same = f.read() == g.read()
        log(f"golden: {clip} float32 --device-glue -> "
            f"{'byte-identical to' if same else 'DIFFERS from'} {ref} "
            f"({wall:.1f} s, launches {launches})")
        if not same:
            raise AssertionError(f"{clip} --device-glue: CSV differs from "
                                 f"{ref}")
    clip, ref, n = GOLDEN_CLIPS[0]
    out = os.path.join(workdir, clip + ".csv")
    trace = os.path.join(workdir, "trace")
    wall, launches = _cli_run(cli_main, os.path.join(GOLDEN, clip), out,
                              "float32", ["--profile", trace, *extra], n)
    with open(out, "rb") as f, open(os.path.join(GOLDEN, ref), "rb") as g:
        same = f.read() == g.read()
    names = os.listdir(trace)
    kernels = 0
    for name in names:
        with open(os.path.join(trace, name)) as f:
            kernels += sum(e.get("cat") == "kernel"
                           for e in json.load(f)["traceEvents"])
    log(f"golden: {clip} float32 --profile -> "
        f"{'byte-identical to' if same else 'DIFFERS from'} {ref}, trace "
        f"files {names} with {kernels} kernel events ({wall:.1f} s, "
        f"launches {launches})")
    if not same or len(names) != 1 or not kernels:
        raise AssertionError("--profile: the CSV differs or no trace of the "
                             "card's kernels was written")


def golden_yuv(cli_main, evaluate, workdir, extra):
    """The yuv420 transfer through the CLI, where the native decoder has
    its YUV entry points (the port builds it with ``make -C native`` on
    first use): ``auto`` must resolve to yuv420 on the card; the golden
    clips at float32 under ``--transfer yuv420`` and ``auto`` byte for
    byte, the other rungs on ``clip.mp4`` at frame accuracy >= 0.99
    against the reference; then ``YUV_CORPUS`` at float32 and
    ``uint8_chain`` at the JAX package's gates.  Launches are checked in
    every run (one ``yuv420_to_bgr`` a batch)."""
    from cut_detection_tpu_torch.data import native_video
    from cut_detection_tpu_torch.pipeline import resolve_transfer

    if not native_video.yuv_available():
        log("golden: the native decoder with YUV entry points could not be "
            "built or loaded here; no yuv420 or auto run made")
        return
    auto = resolve_transfer("auto", device=torch.device("cuda"))
    log(f"golden: native YUV decoder built; --transfer auto resolves to "
        f"{auto} on this card")
    if auto != "yuv420":
        raise AssertionError(f"--transfer auto resolved to {auto} on CUDA "
                             "with the YUV decoder built")
    runs = [("float32", transfer, clip) for transfer in ("yuv420", "auto")
            for clip in GOLDEN_CLIPS]
    runs += [(p, "yuv420", GOLDEN_CLIPS[0])
             for p in ("bfloat16", "bfloat16_full", *QUANTIZED)]
    for precision, transfer, (clip, ref, n) in runs:
        out = os.path.join(workdir, clip + ".csv")
        ref = os.path.join(GOLDEN, ref)
        wall, launches = _cli_run(cli_main, os.path.join(GOLDEN, clip), out,
                                  precision, extra, n, transfer)
        with open(out, "rb") as f, open(ref, "rb") as g:
            same = f.read() == g.read()
        acc = evaluate(out, ref, n)["frame_accuracy"]
        log(f"golden: {clip} {precision} --transfer {transfer} -> "
            f"{'byte-identical to' if same else 'DIFFERS from'} "
            f"{os.path.basename(ref)}, frame accuracy {acc} ({wall:.1f} s, "
            f"launches {launches})")
        if not (same if precision == "float32" else acc >= 0.99):
            raise AssertionError(f"{clip} {precision} --transfer "
                                 f"{transfer}: CSV fails its gate")
    for precision in ("float32", "uint8_chain"):
        for name, n in YUV_CORPUS:
            out = os.path.join(workdir, name + ".csv")
            wall, launches = _cli_run(
                cli_main, os.path.join(CORPUS, name + ".mp4"), out,
                precision, extra, n, "yuv420")
            res = evaluate(out, os.path.join(CORPUS, name + "_truth.csv"),
                           n, tolerance=30)
            ok = (res["frame_accuracy"] >= 0.99
                  and res["boundary_precision"] >= 0.90
                  and res["boundary_recall"] >= 0.90)
            log(f"corpus: {name} {precision} --transfer yuv420 -> frame "
                f"accuracy {res['frame_accuracy']} (gate 0.99), boundary "
                f"P/R {res['boundary_precision']}/{res['boundary_recall']} "
                f"(gate 0.9) {'OK' if ok else 'FAIL'} ({wall:.1f} s, "
                f"launches {launches})")
            if not ok:
                raise AssertionError(f"{name} {precision} yuv420 fails its "
                                     f"gate: {res}")


def game_scores(n: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Seeded per-frame ``(conf, pred)`` of a game: class runs of
    geometric length (mean 150 frames, 5 s) under noisy logits, so that
    short runs and single-frame flips leave orphans to glue."""
    rng = np.random.default_rng(seed)
    runs, total = [], 0
    while total < n:
        length = int(rng.geometric(1 / 150))
        runs.append(np.full(length, rng.integers(0, 3)))
        total += length
    labels = np.concatenate(runs)[:n]
    scores = rng.normal(0, 1, (n, 3)).astype(np.float32)
    scores[np.arange(n), labels] += rng.uniform(1.5, 6, n).astype(np.float32)
    return scores.max(1), scores.argmax(1).astype(np.int32)


def phase_device_glue(dev):
    """The smoother on the card against the host glue on a seeded game of
    ``GAME_FRAMES`` frames: the same segments, the means within 1e-5
    (the host rounds the merge's product on its own, the card as the JAX
    program fuses it); each one's wall time, the card's including its
    fetches, and the card's loop iterations."""
    from cut_detection_tpu_torch.segmentation import rle
    from cut_detection_tpu_torch.segmentation.device_glue import (
        smooth_tables,
    )

    conf, pred = game_scores(GAME_FRAMES)
    n_seg = 1 + int(np.count_nonzero(pred[1:] != pred[:-1]))
    max_segments = max(4096, 1 << (n_seg - 1).bit_length())
    backend = "native" if rle._native_available() else "python"
    t0 = time.perf_counter()
    seg = rle.Segmentation.from_frame_scores(conf, pred)
    seg.glue_orphans(100, 10)
    seg.combine_adjacent_segments()
    host_ms = 1e3 * (time.perf_counter() - t0)
    conf_d, pred_d = torch.from_numpy(conf).to(dev), torch.from_numpy(
        pred).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    te, count, loops = smooth_tables(conf_d, pred_d, 100, 10,
                                     max_segments=max_segments)
    torch.cuda.synchronize()
    card_ms = 1e3 * (time.perf_counter() - t0)
    act = te["active"].cpu().numpy()
    same = all(np.array_equal(te[k].cpu().numpy()[act], seg.te[v])
               for k, v in (("start", "start_frames"),
                            ("type", "frame_types"), ("end", "end_frames")))
    means = np.allclose(te["mean"].cpu().numpy()[act],
                        seg.te["score_means"], rtol=1e-5, atol=1e-5)
    log(f"device_glue: {GAME_FRAMES} frames, {count} initial segments "
        f"(table of {max_segments} rows) -> {int(act.sum())}: card "
        f"{card_ms:.4f} ms ({loops['sum']} summing steps, {loops['glue']} "
        f"orphan merges, {loops['adjacent']} adjacent merges, one fetch "
        f"each), host glue ({backend}) {host_ms:.4f} ms; segments "
        f"{'identical' if same else 'DIFFER'}, means "
        f"{'within 1e-5' if means else 'DIFFER'}")
    if not (same and means and count == n_seg):
        raise AssertionError("the smoother on the card differs from the "
                             "host glue")


def phase_bench(dev):
    """The port's ``bench_fused_conv1`` entry point at batch 128.

    Stage ``block`` is K4's main path: K1 -> K4 -> K4 -> head
    (``e2e_allfused``, the Pallas kernels' numerics) against the shipped
    ``bfloat16_full`` net (``e2e_xla``: the ``bf16_xla`` instances), each
    graph called once for the comparison, once to warm up and ``3 *
    BENCH_STEPS`` times in its timed loops, so K1 and K4's ``cm_bf16``
    launch twice per ``e2e_allfused`` call and the net's three
    instances once per ``e2e_xla`` call; then stage ``mid``, whose
    ``e2e_u8mid`` runs K3's ``bf16_out`` twice a call.  The counts are
    read around those two stages and must be exactly those.  K4's logits
    must equal the all-Pallas chain K1 -> K3 -> K3 (``e2e_k3``) exactly,
    and hold the shipped net with no class flip and within
    ``BENCH_XLA_TOL``.  Then stage ``all``.  Each stage's JSON line is
    printed.  Returns the launches of the ``block`` and ``mid`` stages.
    """
    from cut_detection_tpu_torch.scripts import bench_fused_conv1 as bench

    graphs = bench.build_graphs(dev)
    frames = bench.seeded_frames(BATCH, dev)
    with torch.inference_mode():
        k4 = graphs["e2e_allfused"](frames)
        k3_diff = (k4 - graphs["e2e_k3"](frames)).abs().max().item()
    log(f"bench_fused: K1 -> K4 -> K4 against K1 -> K3 -> K3: logits "
        f"differ by {k3_diff}")
    if k3_diff != 0.0:
        raise AssertionError("K4's chain departs from the K3 chain")

    calls = 2 + 3 * BENCH_STEPS  # per graph: compare, warm up, 3 loops
    zero_launches()
    out = bench.run(BATCH, BENCH_STEPS, "block", dev)
    launches = read_launches()
    want = dict.fromkeys(launches, 0)
    for inst, per_call in (("conv1_block[bf16]", 1),
                           ("conv_block[cm_bf16]", 2),
                           ("conv1_block[bf16_xla]", 1),
                           ("conv_block[bf16_xla]", 1),
                           ("conv_block[bf16_xla_f32]", 1)):
        want[inst] = per_call * calls
    log(f"bench_fused: stage block, launches {launches}")
    check_launches("bench_fused block", launches, want)
    log(f"bench_fused: {json.dumps(out)}")
    if out["full_argmax_flips"] != 0 or \
            out["full_max_logit_diff"] > BENCH_XLA_TOL:
        raise AssertionError(f"K1 -> K4 -> K4 departs from the shipped net: "
                             f"{out}")
    zero_launches()
    res = bench.run(BATCH, BENCH_STEPS, "mid", dev)
    mid = read_launches()
    log(f"bench_fused: stage mid, launches {mid}")
    want = dict.fromkeys(mid, 0)
    want["conv_block[bf16_out]"] = 2 * calls
    check_launches("bench_fused mid", mid, want)
    log(f"bench_fused: {json.dumps(res)}")
    res = bench.run(BATCH, BENCH_STEPS, "all", dev)
    log(f"bench_fused: {json.dumps(res)}")
    log("bench_fused: frames/s against the earlier layer 1: " + ", ".join(
        f"{g} {res[g + '_fps']:.1f} (earlier {fps})"
        for g, fps in EARLIER_FPS.items() if g + "_fps" in res))
    if res["argmax_flips"] != 0 or res["full_argmax_flips"] != 0:
        raise AssertionError(f"bench_fused all: class flips {res}")
    return {inst: launches[inst] + mid[inst] for inst in launches}


def _child_pids() -> list[int]:
    """The processes whose parent is this one, from ``/proc``."""
    me, pids = os.getpid(), []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, ValueError, IndexError):
            continue
        if ppid == me:
            pids.append(int(entry))
    return pids


def _reap(pid: int, timeout: float) -> bool:
    """Wait up to ``timeout`` seconds for child ``pid`` to end; reap it."""
    deadline = time.monotonic() + timeout
    while not os.waitpid(pid, os.WNOHANG)[0]:
        if time.monotonic() > deadline:
            return False
        time.sleep(0.05)
    return True


def stop_children() -> None:
    """Stop every process this run started before it exits.

    The golden phase's decode subprocesses are joined by their loaders;
    their shared-memory rings start ``multiprocessing``'s resource
    tracker, which would otherwise outlive this process for a moment, so
    it is stopped here.  Any other child still running is logged,
    terminated (killed if it ignores that) and reaped.
    """
    import multiprocessing
    from multiprocessing import resource_tracker

    for proc in multiprocessing.active_children():
        proc.terminate()
        proc.join(5)
    stop = getattr(resource_tracker._resource_tracker, "_stop", None)
    if stop is not None:
        stop()
    for pid in _child_pids():
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            cmd = "?"
        log(f"stopping leftover child {pid}: {cmd[:120]}")
        for sig in (signal.SIGTERM, signal.SIGKILL):
            os.kill(pid, sig)  # an unreaped child still takes a signal
            if _reap(pid, 5):
                break
    left = _child_pids()
    if left:
        raise RuntimeError(f"child processes {left} could not be stopped")


# The kernel instances of the port's paths: (row name, the path whose run
# gives its launches, source, the TPU kernel (or XLA op) it replaces).
KERNEL_ROWS = (
    ("conv1_block[f32]", "float32", "cut_detection_tpu_torch/csrc/"
     "conv_block.cu", "cut_detection_tpu/ops/pallas/conv1_kernel.py:97"),
    ("conv1_block[bf16]", "bench_fused", "cut_detection_tpu_torch/csrc/"
     "conv_block.cu", "cut_detection_tpu/ops/pallas/fused_conv1.py:174"),
    ("conv1_block[bf16_xla]", "bfloat16_full", "cut_detection_tpu_torch/"
     "csrc/conv_block.cu", "cut_detection_tpu/ops/pallas/fused_conv1.py:174"),
    ("conv_block[f32]", "float32", "cut_detection_tpu_torch/csrc/"
     "conv_block.cu", "cut_detection_tpu/ops/pallas/fused_block_pm.py:112"),
    ("conv_block[bf16_operands]", "bfloat16", "cut_detection_tpu_torch/"
     "csrc/conv_block.cu",
     "cut_detection_tpu/ops/pallas/fused_block_pm.py:112"),
    ("conv_block[bf16_xla]", "bfloat16_full", "cut_detection_tpu_torch/"
     "csrc/conv_block.cu",
     "cut_detection_tpu/ops/pallas/fused_block_pm.py:112"),
    ("conv_block[bf16_xla_f32]", "bfloat16_full", "cut_detection_tpu_torch/"
     "csrc/conv_block.cu",
     "cut_detection_tpu/ops/pallas/fused_block_pm.py:112"),
    ("conv_block[bf16_out]", "bench_fused", "cut_detection_tpu_torch/"
     "csrc/conv_block.cu",
     "cut_detection_tpu/ops/pallas/fused_block_pm.py:112"),
    ("conv_block[cm_bf16]", "bench_fused", "cut_detection_tpu_torch/"
     "csrc/conv_block.cu",
     "cut_detection_tpu/ops/pallas/fused_conv_block.py:130"),
    ("resize_normalize", "preprocess", "cut_detection_tpu_torch/csrc/"
     "resize_normalize.cu",
     "cut_detection_tpu/ops/pallas/preprocess_kernel.py:74"),
    ("yuv420_to_bgr", "yuv420", "cut_detection_tpu_torch/csrc/"
     "yuv420_to_bgr.cu", "cut_detection_tpu/ops/yuv.py:79"),
    ("conv1_block[i8]", "int8_mxu", "cut_detection_tpu_torch/csrc/"
     "conv_block.cu", "cut_detection_tpu/models/layers.py:229"),
    ("conv_block[i8]", "int8_mxu", "cut_detection_tpu_torch/csrc/"
     "conv_block.cu", "cut_detection_tpu/models/layers.py:229"),
)
# The rows whose ``replaces`` is an op the JAX package leaves to XLA (no
# Pallas kernel): each row's ``replaces_kind`` says which it is.
XLA_ROWS = ("yuv420_to_bgr", "conv1_block[i8]", "conv_block[i8]")


def timed(name: str, fn, *args):
    """``fn(*args)``, logging its wall time as the phase ``name``'s."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    return out


def run() -> tuple[str, list[dict]]:
    """Every phase; returns the card's line and the kernels' rows."""
    card = phase_device()
    dev = torch.device("cuda")
    timed("build", phase_build)
    kres = timed("kernels", phase_kernels, dev)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    frames = synthetic_frames(3 * BATCH + 50)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as wd:
        paths = {"float32": timed("slice", phase_slice, dev, frames, wd)}
        host_bgr = timed("host", phase_host, dev, frames)
        paths["yuv420"] = timed("yuv420", phase_yuv420, dev, frames,
                                host_bgr)
        paths["preprocess"] = timed("preprocess", phase_preprocess, dev)
        paths.update(timed("precision", phase_precision, dev, frames, wd))
        paths["bench_fused"] = timed("bench_fused", phase_bench, dev)
        timed("golden", phase_golden, wd)
        timed("device_glue", phase_device_glue, dev)
    rows = []
    for name, path, source, replaces in KERNEL_ROWS:
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "replaces_kind": "xla"
                     if name in XLA_ROWS else "pallas",
                     "launches": paths[path][name], **kres[name]})
    return card, rows


def main() -> int:
    try:
        card, rows = run()
    finally:
        stop_children()
    log(card)
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
