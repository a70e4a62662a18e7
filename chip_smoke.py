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
8b. profile — the layer-1 stage-bisection kernel ``conv1_stages`` at
             batch 128 on the profiling script's seeded inputs: each of
             its six stages against its plain version (``cast`` and
             ``taps`` exact; the sums within ``check_stage``'s stated
             tolerances, which must reject the sums without the bf16
             rounding and a ``dott`` sink of rolled channels), its
             times beside its bound, its plain version's and, for
             ``dotn`` and ``dott``, ``torch.matmul``'s of the same
             products; then the ``profile_fused_conv1``
             entry point with its launches counted and its cumulative
             table of microseconds an image;
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
             ``int8_mxu`` (the float32 runs without a preprocess flag
             through the decode subprocess, the CLI's default on the
             card, the others decoding in-process: the subprocess's
             start-up, about 10 s, outweighs these clips' work);
             ``--device-glue`` at float32 on both golden
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
9b. serve  — the serving daemon in this process (``make_server`` at port
             0, warmed up, heartbeat on): ``/healthz``, ``/segment`` of
             ``clip.mp4`` at float32 / bgr (the reference's CSV bytes),
             ``/segment_batch`` of both golden clips (likewise),
             ``/reload`` to ``bfloat16_full`` and a request there, then
             back, and ``/metrics``; the block kernels' launches counted
             inside each request against its batches; then shut down
             with no thread or process left;
10. device_glue — the segment smoother on the card
             (``segmentation.device_glue``) on a seeded 324,000-frame
             score vector (a 3-hour game at 30 fps) against the host
             glue on the same vector: the same segments (means within
             1e-5), each one's time and the card's loop iterations.
11. train  — training on the card: the prod net's shape (conv 3->48->48->48,
             pool 4, FC 768->32->3) on a fixed batch of 128 synthetic
             144x256 frames at float32 (20 steps) and ``bfloat16`` (10),
             and the contrastive defaults (32 channels, pool 1, FC
             3x32->8) on 32 frames of 360x640 with each augment path (10
             steps each): one step card against CPU at each precision
             (loss, BN statistics and every gradient leaf within the
             stated tolerances, which a control step must fail), the
             loss falling on the fixed batch, the validation pass's
             ``conv_block`` launches and its logits against the same net
             on the CPU, the views of one seed on the card against the
             CPU's; each loop's ms a step, frames/s, peak memory and a
             trace of 3 steps (busy share, top kernels).  Then both
             training CLIs on a tree of labelled JPEGs: contrastive
             pretraining, supervised training warm-started from it with
             snapshots, the ``.pt`` export and ``--resume``; the
             validation passes' launches, and the trained triplet through
             the classify step on the card and the CPU (every class
             predicted, the same classes).
12. tools  — the tool entry points as a user runs them: ``doctor --full
             --json`` in a subprocess (healthy; its ``kernels-build`` and
             ``classify-step`` checks passed, the step launching
             ``conv1_block[f32]`` once and ``conv_block[f32]`` twice);
             ``embed_frames`` on the train phase's JPEG tree and
             contrastive pair at ``--frame-limit 1024`` (embeddings within
             1e-4 of a ``--cpu`` run on the first 256, ``conv_block[f32]``
             launched conv layers x batches times, frames/s);
             ``export_model --use-default-net`` at batch 128 at every
             rung whose net launches kernels (each reloaded
             ``torch.export`` program on the card, aten ops only, within
             the rung's ``EXPORT_TOL`` of the net at that rung; float32
             also within 1e-4; the ``--format torch`` state dicts equal to
             the bundle's); ``bench_pipeline`` at its defaults on a seeded
             2,000-frame 1280x720 clip written here, all three stages at
             float32 (cv2 decode, sequential and parallel; the resident
             loop; end to end); ``split_video`` on the golden clip, the
             same JPEG bytes at ``--decode-workers`` 1 and 4.
12b. scripts — the workflow and measurement entry points as a user runs
             them: (a) ``e2e_workflow_demo`` at the prod shape and its
             default epochs (split, SimCLR pretraining, warm-started
             supervised training, ``segment_video --model-dir``,
             ``evaluate``): the held-out clip at frame accuracy >= 0.99
             and boundary precision and recall >= 0.90 (tolerance 15),
             and ``segment_video``'s launches counted from 0 around that
             stage: ``conv1_block[f32]`` once and ``conv_block[f32]``
             twice a batch; (b) ``bench_full_game`` at 4,096 frames with
             its three default modes: every mode that ran decodes every
             frame with no failure, yuv420 skipped exactly where the
             native YUV decoder is missing, the card named, and
             ``csv_parity_bgr`` printed; (c) ``bench_train`` and (d)
             ``profile_simclr_step`` at their defaults: finite positive
             times and finite losses; (e) ``bench_decode`` at 2,000
             frames.
13. parallel — several cards and processes (``parallel/``): (a) the
             slice stream through the device loop with each batch split
             over a mesh of every card (one card listed twice where there
             is one: the split and the gather, the shards sharing it) at
             float32 and ``int8_mxu``: classes and CSV bytes of the
             unsharded loop, conf within ``PARALLEL_CONF_TOL``, each
             shard's launches, both loops' frames/s; (b) a 2-rank group
             (NCCL with a card a rank, gloo over CUDA tensors on one
             card) running the supervised step at the prod widths and the
             contrastive step at its defaults, each against the
             single-rank step (loss within rtol 1e-5, each all-reduced
             gradient leaf within ``PARALLEL_GRAD_RTOL`` of its norm,
             parameters ``PARALLEL_PARAM_TOL``, BN statistics
             ``PARALLEL_STAT_TOL``), and a tiny ``train_supervised`` with
             tails; (c)
             ``segment_videos --multi-host --data-parallel`` as two
             processes with torchrun's variables over the golden clips,
             the union of their CSVs the single process's byte for byte;
             (d) with two or more cards, every kernel route launched on
             ``cuda:1`` while ``cuda:0`` is current, against its plain
             version, and (e) ``train_supervised --data-parallel`` over
             every card against the same CLI on one: one step of 128,
             its gradients read from the snapshot's Adam moments; (f)
             ``segment_videos``' split of two 2,000-frame 1280x720 clips
             a card over a process a card (the golden clips over one
             card twice where there is one), the one-card CSVs byte for
             byte, walls of both; (g) ``dryrun_multichip``'s
             tensor-parallel part: each block-kernel instance of the
             tensor-parallel step at 24 and 12 output channels against
             its plain version (``F32_TOL``, ``xla_check``, max diff 0 for
             int8), then the slice stream through
             ``make_sharded_classify_step(..., tensor_parallel=True)`` over
             ``[cuda:0] * 4`` at model 2 (every rung) and model 4
             (float32, ``int8_mxu``), and, with two or more cards, over the
             cards at model 2 (and 4): classes and CSV bytes of the
             unsharded step, conf within ``PARALLEL_CONF_TOL``, each block
             kernel launched data rows x model columns times a batch a
             layer, ms a batch and frames/s of the unsharded,
             data-parallel and tensor-parallel steps.

Before it prints a result the run stops every process it started (the
decode subprocesses and ``multiprocessing``'s resource tracker).  Then
one JSON line with every kernel's numbers, and last the result line
``{"ok": true, "device": {...}}``.  Any failure exits non-zero without it.
"""

from __future__ import annotations

import collections
import dataclasses
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
    # The stage-bisection kernel's instances (template argument = stage):
    # wgmma from dotn (2) on, none in cast (0) and taps (1).
    stages = {int(m.group(1)): c["HGMMA"] for n, c in counts.items()
              if (m := re.search(r"conv1_stagesILi(\d)E", n))}
    log(f"build: conv1_stages instances, HGMMA by stage {stages}")
    if sorted(stages) != list(range(6)) or stages[0] or stages[1] \
            or not all(stages[k] for k in range(2, 6)):
        raise AssertionError(f"conv1_stages: expected six instances, wgmma "
                             f"from dotn on only; got {stages}")


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

    from cut_detection_tpu_torch.ops.kernels.conv1_stages import (
        conv1_stages,
    )
    from cut_detection_tpu_torch.ops.kernels.conv_block_i8 import (
        conv1_block_i8,
        conv_block_i8,
    )

    return {"conv1_block": conv1_block, "conv_block": conv_block,
            "resize_normalize": resize_normalize,
            "yuv420_to_bgr": yuv420_to_bgr,
            "conv1_block[i8]": conv1_block_i8,
            "conv_block[i8]": conv_block_i8,
            "conv1_stages": conv1_stages}


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


def trace_loop(tag: str, loop, reps: int, top: int = 6) -> float | None:
    """Run ``loop`` (``reps`` batches) under ``torch.profiler`` and log the
    card's busy share and the ``top`` costliest kernels per batch; return
    the busy share in percent (None if the trace holds no kernel)."""
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
    for name, (ms, count) in sorted(per_name.items(),
                                    key=lambda kv: -kv[1][0])[:top]:
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
    # The decode subprocess, the CLI's default on the card, takes about
    # 10 s to start, more than these clips take to classify.  The first
    # run of each decode path (its preprocess flags and transfer: full
    # frames through the ring under --device-resize) keeps it; a later run
    # that repeats a path decodes in this process (the same frames, and
    # the same CSV bytes).
    covered = set()

    def decode(flags, transfer="bgr"):
        if (tuple(flags), transfer) in covered:
            return [*extra, "--decode-process", "off"]
        covered.add((tuple(flags), transfer))
        return extra

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
                    flags + decode(flags), n)
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
            precision, decode([]), n)
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
    golden_options(cli_main, workdir, decode)
    golden_yuv(cli_main, evaluate, workdir, decode)


def golden_options(cli_main, workdir, decode):
    """``--device-glue`` at float32 on both golden clips (the host glue's
    bytes, which are the reference's), then ``--profile DIR`` on
    ``clip.mp4``: the reference's bytes and one trace file in DIR that
    holds the card's kernels.  ``decode(flags, transfer)`` gives a run's
    decoder flags (``phase_golden``)."""
    for clip, ref, n in GOLDEN_CLIPS:
        out = os.path.join(workdir, clip + ".csv")
        wall, launches = _cli_run(cli_main, os.path.join(GOLDEN, clip), out,
                                  "float32", ["--device-glue", *decode([])], n)
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
                              "float32", ["--profile", trace, *decode([])], n)
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


def golden_yuv(cli_main, evaluate, workdir, decode):
    """The yuv420 transfer through the CLI, where the native decoder has
    its YUV entry points (the port builds it with ``make -C native`` on
    first use): ``auto`` must resolve to yuv420 on the card; the golden
    clips at float32 under ``--transfer yuv420`` and ``auto`` byte for
    byte, the other rungs on ``clip.mp4`` at frame accuracy >= 0.99
    against the reference; then ``YUV_CORPUS`` at float32 and
    ``uint8_chain`` at the JAX package's gates.  Launches are checked in
    every run (one ``yuv420_to_bgr`` a batch).  ``decode`` as in
    ``golden_options``."""
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
                                  precision, decode([], transfer), n,
                                  transfer)
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
                precision, decode([], "yuv420"), n, "yuv420")
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


# The train phase: steps on a fixed batch at each precision, the
# contrastive loop's steps with each augment path, then both training CLIs
# on a frame tree.
TRAIN_STEPS = {"float32": 20, "bfloat16": 10}
CONTRASTIVE_STEPS = 10
CONTRASTIVE_HW = (360, 640)  # the contrastive frames (360p) -> 144x256 views
CHECK_BATCH = 32             # the step held card against CPU
# One step, card against CPU, from the same weights on the same batch:
# cuDNN's summation order against the CPU's (measured on an NVIDIA H100
# 80GB HBM3 at 700 W: loss 2.2e-7, gradients 7.9e-4, BN 6e-8 at float32;
# loss 2.7e-5, gradients 6.1e-3, BN 1.1e-5 at bf16; the worst gradient
# leaf, in relative norm, layer 1's conv weight at float32 and a conv bias
# at bf16).  The gradient bar must also fail a control step: at float32
# the same step with TF32 allowed (9.3e-2 measured), at bf16 the float32
# step (0.35).
TRAIN_LOSS_RTOL = {"float32": 1e-5, "bfloat16": 2e-4}
TRAIN_GRAD_RTOL = {"float32": 2e-3, "bfloat16": 2e-2}
TRAIN_BN_TOL = {"float32": 1e-4, "bfloat16": 1e-3}
VIEW_TOL = 1e-5              # views: all but 0.1% of the pixels
# The training CLIs' frame tree: 144x256 JPEGs in labelled segments of one
# colour each (BGR, plus noise), cycling A22 / EZ / blank.
TREE_FRAMES = 4096
EMBED_FRAMES = 1024  # the tools phase's embed_frames on the tree
EMBED_CHECK = 256    # of them held against a --cpu run
TREE_SEGMENT = 128
TREE_COLOURS = {"a22": (40, 120, 40), "ez": (60, 60, 150), "b": (10, 10, 10)}
TREE_MIN_ACC = 0.9           # the trained triplet on the tree's frames
# The tools phase's bench_pipeline clip (write_game_clip): a game's frame
# size, as many frames as the CLI's default --frame-limit.
CLIP_FRAMES = 2000
GAME_HW = (720, 1280)


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _train_labels(n: int) -> np.ndarray:
    """Labels 0, 1, 2, 0, 1 in five runs of the batch.  The runs do not
    follow ``synthetic_frames``' colour blocks, so the net fits the
    frames' noise as well as their colours."""
    return (np.arange(n) * 5 // n % 3).astype(np.int64)


def _bn_leaves(net) -> list:
    return [b.cpu().numpy() for k, b in net.state_dict().items()
            if "running_" in k]


def _grads(net) -> dict:
    return {n: p.grad.cpu().numpy() for n, p in net.named_parameters()}


def _one_step(cfg, where, frames, labels):
    """One train step from seed 1's weights: the loss, the gradients by
    parameter name and the new BN statistics."""
    from cut_detection_tpu_torch.train.supervised import (
        init_train_state,
        make_train_step,
    )

    state = init_train_state(torch.Generator().manual_seed(1), cfg, where)
    state, m = make_train_step(cfg)(state, frames, labels)
    return float(m["loss"]), _grads(state.net), _bn_leaves(state.net)


def _worst_leaf(grads, ref) -> tuple[str, float]:
    return max(((n, _rel(grads[n], ref[n])) for n in ref),
               key=lambda t: t[1])


def train_step_card_vs_cpu(dev, cfg, frames, labels) -> str:
    """One step from the same weights on the same batch on the card and on
    the CPU (plain PyTorch both): the loss, the BN statistics and every
    gradient leaf; then a control step on the card, which the gradient
    bar must fail (float32: TF32 allowed; bf16: the float32 step)."""
    from cut_detection_tpu_torch.utils.device import strict_fp32

    prec = "float32" if cfg.compute_dtype is None else "bfloat16"
    lc, gc, bc = _one_step(cfg, dev, frames, labels)
    lh, gh, bh = _one_step(cfg, torch.device("cpu"), frames, labels)
    if prec == "float32":
        control = "TF32 allowed"
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            _, gx, _ = _one_step(cfg, dev, frames, labels)
        finally:
            strict_fp32()
    else:
        control = "the float32 step"
        _, gx, _ = _one_step(dataclasses.replace(cfg, compute_dtype=None),
                             dev, frames, labels)
    loss_err = abs(lc - lh) / abs(lh)
    leaf, grad_err = _worst_leaf(gc, gh)
    xleaf, ctrl_err = _worst_leaf(gx, gh)
    bn_err = max(float(np.abs(a - b).max()) for a, b in zip(bc, bh))
    bar = TRAIN_GRAD_RTOL[prec]
    msg = (f"{prec} step card vs CPU at batch {len(frames)}: loss "
           f"{lc:.6f} / {lh:.6f} (rel {loss_err:.2e}, tol "
           f"{TRAIN_LOSS_RTOL[prec]:.0e}), BN statistics max diff "
           f"{bn_err:.2e} (tol {TRAIN_BN_TOL[prec]:.0e}), gradients worst "
           f"leaf rel {grad_err:.2e} ({leaf}; tol {bar:.0e}); control "
           f"({control}) worst leaf rel {ctrl_err:.2e} ({xleaf}; must "
           f"exceed the tol)")
    if (loss_err > TRAIN_LOSS_RTOL[prec] or bn_err > TRAIN_BN_TOL[prec]
            or grad_err > bar or ctrl_err <= bar):
        raise AssertionError(f"train: {msg}")
    return msg


def train_supervised_run(dev, card, cfg, frames, labels) -> dict:
    """``TRAIN_STEPS`` steps on the fixed batch (the loss must fall), timed;
    the validation pass (the block kernels' launches counted, its logits
    against the same net on the CPU)."""
    from cut_detection_tpu_torch.models.assembly import GluedNet
    from cut_detection_tpu_torch.ops.preprocess import to_unit
    from cut_detection_tpu_torch.train.supervised import (
        init_train_state,
        make_eval_step,
        make_train_step,
    )

    prec = "float32" if cfg.compute_dtype is None else "bfloat16"
    steps = TRAIN_STEPS[prec]
    state = init_train_state(torch.Generator().manual_seed(0), cfg, dev)
    step = make_train_step(cfg)
    x = torch.from_numpy(frames).to(dev)
    y = torch.from_numpy(labels).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, x, y)
        losses.append(float(m["loss"]))  # waits for the step
        times.append(1e3 * (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    ms = float(np.median(times[2:]))
    log(f"train: {prec} supervised, batch {len(frames)} of "
        f"{frames.shape[1]}x{frames.shape[2]}: {steps} steps, "
        f"{ms:.4f} ms a step (median, after 2), "
        f"{1e3 * len(frames) / ms:.1f} frames/s, first step "
        f"{times[0]:.1f} ms, peak {peak:.1f} MiB; loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} [{card}]")
    if not (np.isfinite(losses).all() and losses[-1] < 0.8 * losses[0]):
        raise AssertionError(f"train: {prec} loss did not fall on a fixed "
                             f"batch: {losses}")
    busy = trace_loop(f"train: {prec} step trace",
                      lambda: [step(state, x, y) for _ in range(3)], 3,
                      top=10)

    # The validation pass: the eval step on the card launches the block
    # kernels (the float frames go to conv_block at every layer).
    want = ({"conv_block[f32]": 3} if prec == "float32" else
            {"conv_block[bf16_xla]": 2, "conv_block[bf16_xla_f32]": 1})
    zero_launches()
    metrics = make_eval_step(cfg)(state, x, y)
    got = read_launches()
    check_launches(f"train {prec} validation", got,
                   {**dict.fromkeys(got, 0), **want})
    with torch.no_grad():
        logits = state.net(to_unit(x)).cpu()
        plain = GluedNet(state.net.model_params, state.net.precision)
        plain.load_state_dict(state.net.state_dict())
        ref = plain(to_unit(torch.from_numpy(frames)))
        # The same batch under its own statistics (train mode, nothing
        # applied): the eval pass's running statistics still hold 0.9^20
        # of their initial values after 20 steps at momentum 0.1.
        state.net.train()
        batch_pred = state.net(to_unit(x)).argmax(dim=1).cpu().numpy()
        state.net.conv.bn_stats.clear()
        state.net.linear.bn_stats.clear()
        state.net.eval()
    err = float((logits - ref).abs().max())
    tol = CONF_TOL if prec == "float32" else BF16_CONF_TOL
    log(f"train: {prec} validation pass, launches {want}, per-class "
        f"correct {metrics['correct'].tolist()} of "
        f"{metrics['total'].tolist()} (under the batch's own statistics "
        f"{np.bincount(batch_pred[batch_pred == labels], minlength=3).tolist()}"
        f"); logits against the plain eval "
        f"forward on the CPU max diff {err:.3e} (tol {tol:.0e})")
    if err > tol:
        raise AssertionError(f"train: {prec} validation logits differ by "
                             f"{err}")
    return {"ms": ms, "fps": 1e3 * len(frames) / ms, "peak_mib": peak,
            "busy": busy}


def write_frame_tree(path: str, n: int, seed: int = 5) -> None:
    """``n`` 144x256 JPEGs ``frame_%07d.jpg`` under ``path`` in segments of
    ``TREE_SEGMENT`` frames of one class each, and their ``frames.csv``
    (``start,label`` rows), written with the cv2 that the port's
    ``data/frames.py`` reads them with."""
    from cut_detection_tpu_torch.data.frames import cv2

    names = list(TREE_COLOURS)
    rows, labels = [], np.empty(n, np.int64)
    for k, start in enumerate(range(0, n, TREE_SEGMENT)):
        rows.append(f"{start},{names[k % 3]}")
        labels[start:start + TREE_SEGMENT] = k % 3
    rng = np.random.default_rng(seed)
    noise = rng.integers(0, 30, (61, 144, 256, 3), dtype=np.int16)
    base = np.array([TREE_COLOURS[c] for c in names], np.int16)
    for i in range(n):
        img = np.clip(base[labels[i]] + noise[i % len(noise)], 0, 255)
        cv2.imwrite(os.path.join(path, f"frame_{i:07d}.jpg"),
                    img.astype(np.uint8))
    with open(os.path.join(path, "frames.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")


def write_game_clip(path: str, n: int = CLIP_FRAMES, seed: int = 7) -> None:
    """``n`` seeded ``GAME_HW`` frames at 30 fps under ``path`` (mp4v), in
    segments of 60-240 frames, cycling A22 / EZ / blank: each segment a
    camera pan, 2 pixels a frame, across a field of its class colour
    (``TREE_COLOURS``) with a texture (noise of amplitude 16 drawn at an
    eighth of the size and scaled up), plus noise of amplitude 4 a pixel
    from 16 frames in turn.  The encoder finds the pan's motion, as it
    does in game film, and writes about 5 KB a frame."""
    from cut_detection_tpu_torch.data.frames import cv2

    h, w = GAME_HW
    span = w + 2 * 240  # the longest segment's pan
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 16, (h // 8, span // 8, 3), dtype=np.uint8)
    texture = cv2.resize(coarse, (span, h), interpolation=cv2.INTER_LINEAR)
    fields = [cv2.add(np.full((h, span, 3), c, np.uint8), texture)
              for c in TREE_COLOURS.values()]
    noise = rng.integers(0, 4, (16, h, w, 3), dtype=np.uint8)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30,
                             (w, h))
    if not writer.isOpened():
        raise RuntimeError(f"cv2 cannot write {path}")
    try:
        i = k = 0
        while i < n:
            seg = min(int(rng.integers(60, 241)), n - i)
            for j in range(seg):
                x = 2 * j
                writer.write(cv2.add(fields[k % 3][:, x:x + w],
                                     noise[(i + j) % 16]))
            i, k = i + seg, k + 1
    finally:
        writer.release()


def train_cli_run(dev, card, workdir) -> str:
    """Both training CLIs on the card as a user runs them, on a tree of
    ``TREE_FRAMES`` labelled frames: contrastive pretraining of the prod
    backbone (``--fast-augment``, 48 channels, one epoch), supervised
    training warm-started from it (``--load-conv-net --data-parallel``,
    one card: unsharded) for 2 of 3 epochs with a snapshot each epoch and
    the ``.pt`` export, then ``--resume`` for the third.  Held: the
    validation passes' ``conv_block`` launches, the snapshots' epoch
    numbering, the ``.pt`` files equal to the bundles, and the triplet
    through the classify step on the card and the CPU on the tree's
    frames: the same classes, every class predicted, accuracy at least
    ``TREE_MIN_ACC``."""
    from cut_detection_tpu_torch.cli import train_contrastive, train_supervised
    from cut_detection_tpu_torch.data.frames import SupervisedFrameDataset
    from cut_detection_tpu_torch.models.assembly import (
        load_and_glue_nets,
        load_triplet_or_default,
    )
    from cut_detection_tpu_torch.pipeline import make_classify_step

    tree = os.path.join(workdir, "tree")
    models = os.path.join(workdir, "tree_models")
    os.makedirs(tree)
    t0 = time.perf_counter()
    write_frame_tree(tree, TREE_FRAMES)
    t_tree = time.perf_counter() - t0
    named = ["--model-dir", models, "--model-name", "smoke"]
    t0 = time.perf_counter()
    train_contrastive.main(["--data-dir", tree, "--fast-augment",
                            "--conv-hidden-channels", "48", "--epochs", "1",
                            *named])
    t_con = time.perf_counter() - t0
    sup = ["--data-dirs", tree, "--checkpoint-every-n", "1",
           "--export-torch", *named]
    zero_launches()
    t0 = time.perf_counter()
    train_supervised.main([*sup, "--load-conv-net", "--data-parallel",
                           "--epochs", "2"])
    t_sup = time.perf_counter() - t0
    t0 = time.perf_counter()
    train_supervised.main([*sup, "--resume", "--epochs", "3"])
    t_res = time.perf_counter() - t0
    got = read_launches()
    n_valid = TREE_FRAMES - int(np.floor(TREE_FRAMES * 0.75))
    val_batches = -(-n_valid // BATCH)
    check_launches("train CLI validation passes", got,
                   {**dict.fromkeys(got, 0),
                    "conv_block[f32]": 3 * val_batches * 3})
    snaps = sorted(f for f in os.listdir(models)
                   if re.fullmatch(r"train_state_\d{4}\.npz", f))
    with open(os.path.join(models, "train_state_meta.json")) as f:
        meta = json.load(f)
    if snaps != [f"train_state_{e:04d}.npz" for e in range(3)] \
            or meta["epoch"] != 2:
        raise AssertionError(f"train CLI snapshots {snaps}, meta {meta}")

    # Every 8th frame of the tree as the dataset reads it (RGB), flipped
    # to BGR as the classify step takes decoded video.
    ds = SupervisedFrameDataset(tree, "frames.csv")
    items = [ds[i] for i in range(0, TREE_FRAMES, 8)]
    bgr = np.stack([it["x"][..., ::-1] for it in items])
    labels = np.array([it["y"] for it in items])
    out = []
    for where in (dev, torch.device("cpu")):
        net, _ = load_triplet_or_default(models, "smoke", where)
        step = make_classify_step(net)
        res = [step(torch.from_numpy(bgr[i:i + BATCH]).to(where))
               for i in range(0, len(bgr), BATCH)]
        out.append((torch.cat([c for c, _ in res]).cpu().numpy(),
                    torch.cat([p for _, p in res]).cpu().numpy()))
    (cc, pc), (ch, ph) = out
    pt, _ = load_and_glue_nets(
        *(os.path.join(models, f"smoke{suffix}") for suffix in (
            "_model_params.json", "_classifier_conv.pt",
            "_classifier_linear.pt")), torch.device("cpu"))
    sd_pt, sd_npz = pt.state_dict(), net.state_dict()
    pt_same = sd_pt.keys() == sd_npz.keys() and all(
        torch.equal(sd_pt[k], sd_npz[k]) for k in sd_npz)
    err = float(np.abs(cc - ch).max())
    acc = float((pc == labels).mean())
    classes = np.bincount(pc, minlength=3).tolist()
    msg = (f"train: CLIs on a tree of {TREE_FRAMES} 144x256 JPEGs (written "
           f"in {t_tree:.1f} s): train_contrastive --fast-augment 1 epoch "
           f"{t_con:.1f} s; train_supervised --load-conv-net epochs 1-2 "
           f"{t_sup:.1f} s, --resume epoch 3 {t_res:.1f} s "
           f"({3 * TREE_FRAMES / (t_sup + t_res):.1f} frames/s with "
           f"loading and validation); validation launches "
           f"{ {k: v for k, v in got.items() if v} }; snapshots {snaps}; "
           f".pt {'equal to' if pt_same else 'DIFFER from'} the bundles; "
           f"triplet -> classify step on {len(bgr)} frames: classes "
           f"{classes}, accuracy {acc:.4f} (min {TREE_MIN_ACC}), conf card "
           f"vs CPU {err:.3e} [{card}]")
    log(msg)
    if not (pt_same and np.array_equal(pc, ph) and err <= CONF_TOL
            and np.isfinite(cc).all() and min(classes) > 0
            and acc >= TREE_MIN_ACC):
        raise AssertionError(msg)
    return msg


def train_contrastive_run(dev, card, cfg, frames) -> dict:
    """The views of one seed on the card against the CPU's; then
    ``CONTRASTIVE_STEPS`` steps of the contrastive loop's step (views made
    on the card), timed."""
    from cut_detection_tpu_torch.train import augment
    from cut_detection_tpu_torch.train.contrastive import (
        init_contrastive_state,
        make_contrastive_step,
    )

    tag = "fast" if cfg.fast_augment else "exact"
    two_views = (augment.fast_simclr_two_views if cfg.fast_augment
                 else augment.simclr_two_views)
    x = torch.from_numpy(frames).to(dev)
    card_views, cpu_views = (
        two_views(torch.Generator().manual_seed(7), xx).cpu().numpy()
        for xx in (x, torch.from_numpy(frames)))
    diff = np.abs(card_views - cpu_views).max(axis=-1)
    off = float((diff > VIEW_TOL).mean())
    log(f"train: {tag} views of seed 7, card vs CPU: "
        f"{cpu_views.shape}, max diff {float(diff.max()):.3e}, "
        f"{off:.4%} of the pixels beyond {VIEW_TOL:.0e}")
    if off > 1e-3:
        raise AssertionError(f"train: {tag} views differ card vs CPU")

    gen = torch.Generator().manual_seed(cfg.seed)
    state = init_contrastive_state(gen, cfg, dev)
    step = make_contrastive_step(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(CONTRASTIVE_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, gen, x)
        losses.append(float(m["loss"]))
        times.append(1e3 * (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    ms = float(np.median(times[2:]))
    log(f"train: contrastive ({tag} views), batch {len(frames)} of "
        f"{frames.shape[1]}x{frames.shape[2]} -> 2x{len(frames)} views of "
        f"144x256: {CONTRASTIVE_STEPS} steps, {ms:.4f} ms a step (median, "
        f"after 2), {1e3 * len(frames) / ms:.1f} frames/s, peak "
        f"{peak:.1f} MiB; loss {losses[0]:.4f} -> {losses[-1]:.4f} [{card}]")
    if not np.isfinite(losses).all():
        raise AssertionError(f"train: contrastive {tag} loss {losses}")
    busy = trace_loop(f"train: contrastive {tag} step trace",
                      lambda: [step(state, gen, x) for _ in range(3)], 3,
                      top=10)
    return {"ms": ms, "fps": 1e3 * len(frames) / ms, "peak_mib": peak,
            "busy": busy}


def phase_train(dev, card, workdir):
    """Training on the card at the prod net's shape (conv 3->48->48->48,
    pool 4, FC 768->32->3; batch 128 of 144x256 synthetic frames) and the
    contrastive defaults (32 channels, pool 1, 3x32->8; batch 32 of
    360x640): one step card against CPU at each precision, the loss falling
    on a fixed batch, the validation pass's kernel launches and logits,
    the views card against CPU, and each loop's ms a step, frames/s and
    peak memory; then both training CLIs on a frame tree, the trained
    triplet through the classify step (``train_cli_run``)."""
    from cut_detection_tpu_torch.config import ContrastiveConfig, TrainConfig

    # synthetic_frames rounds each colour block's share, so ask for more.
    frames = synthetic_frames(BATCH + 8)[:BATCH]
    labels = _train_labels(BATCH)
    sub = np.linspace(0, BATCH - 1, CHECK_BATCH).astype(int)
    out = {}
    for prec in ("float32", "bfloat16"):
        cfg = TrainConfig(compute_dtype=None if prec == "float32"
                          else prec)
        log("train: " + train_step_card_vs_cpu(dev, cfg, frames[sub],
                                               labels[sub]))
        out[prec] = train_supervised_run(dev, card, cfg, frames, labels)
    src = synthetic_frames(40, *CONTRASTIVE_HW, seed=3)[:32]
    for fast in (False, True):
        cfg = ContrastiveConfig(fast_augment=fast)
        out["fast" if fast else "exact"] = train_contrastive_run(
            dev, card, cfg, src)
    train_cli_run(dev, card, workdir)
    return out


def start_doctor(card):
    """Start ``doctor --full --json`` in a subprocess, as a supervisor runs
    it.  Returns a function that waits for it and checks it: healthy, its
    kernel build and classify step passed, and the step launched
    ``conv1_block[f32]`` once and ``conv_block[f32]`` twice."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "cut_detection_tpu_torch.cli.doctor",
         "--full", "--json"], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)

    def finish() -> dict:
        try:
            stdout, stderr = proc.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise
        wall = time.perf_counter() - t0
        lines = stdout.strip().splitlines()
        report = json.loads(lines[-1]) if lines else {}
        checks = {c["check"]: c for c in report.get("checks", [])}
        log(f"tools: doctor --full --json exit {proc.returncode} in "
            f"{wall:.1f} s: " + "; ".join(
                f"{n} {'ok' if c['ok'] else 'FAIL'} {c['seconds']} s "
                f"{c['detail'] or c['error']}"
                for n, c in checks.items()) + f" [{card}]")
        step = checks.get("classify-step", {})
        if not (proc.returncode == 0 and report.get("healthy") is True
                and checks.get("kernels-build", {}).get("ok")
                and step.get("ok") and step["detail"]["launches"] == {
                    "conv1_block[f32]": 1, "conv_block[f32]": 2}):
            raise AssertionError(f"tools: doctor unhealthy or off its "
                                 f"path:\n{stdout}\n{stderr[-4000:]}")
        return {"wall_s": wall}

    return finish


def tools_embed(dev, card, workdir) -> dict:
    """``embed_frames`` on the train phase's JPEG tree and contrastive
    pair, ``--frame-limit EMBED_FRAMES`` on the card and its first
    ``EMBED_CHECK`` frames with ``--cpu``: embeddings within ``CONF_TOL``,
    ``conv_block[f32]`` launched once per conv layer and batch (float
    frames: layer 1 too) and no other kernel; frames/s of the CLI."""
    from cut_detection_tpu_torch.cli import embed_frames
    from cut_detection_tpu_torch.config import ModelParams

    tree = os.path.join(workdir, "tree")
    models = os.path.join(workdir, "tree_models")
    mp = ModelParams.from_json(os.path.join(models,
                                            "smoke_embed_params.json"))
    common = [tree, "--model-dir", models, "--model-name", "smoke"]
    card_out = os.path.join(workdir, "embed_card.npz")
    cpu_out = os.path.join(workdir, "embed_cpu.npz")
    zero_launches()
    t0 = time.perf_counter()
    embed_frames.main([*common, "--frame-limit", str(EMBED_FRAMES),
                       "--output", card_out])
    wall = time.perf_counter() - t0
    got = read_launches()
    batches = -(-EMBED_FRAMES // 256)  # the CLI's default batch
    check_launches("tools: embed_frames", got,
                   {**dict.fromkeys(got, 0),
                    "conv_block[f32]": mp.conv_layers * batches})
    embed_frames.main([*common, "--frame-limit", str(EMBED_CHECK),
                       "--output", cpu_out, "--cpu"])
    on_card = np.load(card_out)["embeddings"]
    on_cpu = np.load(cpu_out)["embeddings"]
    err = float(np.abs(on_card[:EMBED_CHECK] - on_cpu).max())
    fps = EMBED_FRAMES / wall
    log(f"tools: embed_frames --frame-limit {EMBED_FRAMES} on the tree "
        f"(conv {mp.conv_layers}x{mp.conv_channels}ch, pool "
        f"{mp.avg_pool_size}, FC {mp.linear_layers}x{mp.linear_size}->"
        f"{mp.linear_output_size}): {on_card.shape} in {wall:.2f} s, "
        f"{fps:.1f} frames/s with start-up and JPEG decode; launches "
        f"{ {k: v for k, v in got.items() if v} }; card vs --cpu on "
        f"{EMBED_CHECK} frames {err:.3e} (tol {CONF_TOL:.0e}) [{card}]")
    if not (on_card.shape == (EMBED_FRAMES, mp.linear_output_size)
            and np.isfinite(on_card).all() and err <= CONF_TOL):
        raise AssertionError("tools: embed_frames card vs CPU")
    return {"fps": fps, "wall_s": wall}


# The rungs whose nets launch kernels.  At uint8_pool and uint8_chain the
# blocks are plain PyTorch, so the exported program runs the net's own
# ops on any device; tests/test_torch_embed_export.py holds them.
EXPORT_RUNGS = ("float32", "bfloat16", "bfloat16_full", "int8_mxu")


def tools_export(dev, card, workdir) -> dict:
    """``export_model --use-default-net`` at batch 128 at each of
    ``EXPORT_RUNGS``: ``export`` (the CLI's own check, then here: the
    reloaded program on the card, aten ops only, within the rung's
    ``EXPORT_TOL`` of the logits of the net at that rung on the CLI's
    example, the net launching its kernels; at float32 also within
    ``F32_TOL``, ``conv_block[f32]`` three times) and, at float32,
    ``torch`` (the ``.pt`` state dicts equal to the bundle's tensors).
    Returns each rung's reading and wall time."""
    from cut_detection_tpu_torch.cli import export_model
    from cut_detection_tpu_torch.models.assembly import (
        _PROD_NET_DIR,
        load_and_glue_nets,
        load_default_net,
    )

    x = torch.from_numpy(np.random.default_rng(0).random(
        (BATCH, *MODEL_HW, 3), dtype=np.float32)).to(dev)
    readings = {}
    for precision in EXPORT_RUNGS:
        out = os.path.join(workdir, f"prod_{precision}.pt2")
        t0 = time.perf_counter()
        export_model.main(["--use-default-net", "--batch-size", str(BATCH),
                           "--precision", precision, "--output", out])
        wall = time.perf_counter() - t0
        size = os.path.getsize(out)
        program = torch.export.load(out)
        os.remove(out)
        ops = {str(n.target) for n in program.graph.nodes
               if n.op == "call_function"}
        net, _ = load_default_net(dev, precision)
        zero_launches()
        with torch.inference_mode():
            want = net(x).cpu().numpy()
        launched = {k: v for k, v in read_launches().items() if v}
        with torch.inference_mode():
            got = program.module()(x).cpu().numpy()
        err = float(np.abs(got - want).max())
        bar = export_model.EXPORT_TOL[precision]
        log(f"tools: export_model --use-default-net --batch-size {BATCH} "
            f"--precision {precision}: {size:,} B in {wall:.2f} s, "
            f"{len(ops)} aten ops; program on the card vs the net "
            f"{err:.3e} (bar {bar:.0e}; the net's launches {launched}) "
            f"[{card}]")
        if not (ops and all(op.startswith("aten.") for op in ops)
                and err <= bar and np.isfinite(got).all() and launched):
            raise AssertionError(f"tools: export_model at {precision}")
        if precision == "float32" and not (
                err <= F32_TOL and launched == {"conv_block[f32]": 3}):
            raise AssertionError("tools: export_model at float32")
        readings[precision] = {"max_abs_err": err, "bar": bar,
                               "wall_s": wall}
    pt_dir = export_model.main(["--use-default-net", "--format", "torch",
                                "--output", os.path.join(workdir, "pt")])
    pt, _ = load_and_glue_nets(
        os.path.join(_PROD_NET_DIR, "init_model_model_params.json"),
        os.path.join(pt_dir, "classifier_conv.pt"),
        os.path.join(pt_dir, "classifier_linear.pt"), torch.device("cpu"))
    ref = load_default_net(torch.device("cpu"))[0].state_dict()
    sd = pt.state_dict()
    same = sd.keys() == ref.keys() and all(torch.equal(sd[k], ref[k])
                                           for k in ref)
    log(f"tools: export_model --format torch "
        f"{'equal to' if same else 'DIFFERS from'} the bundle [{card}]")
    if not same:
        raise AssertionError("tools: export_model --format torch")
    return readings


def tools_bench(card, clip: str) -> dict:
    """``bench_pipeline`` at its defaults on ``clip`` (``write_game_clip``:
    ``CLIP_FRAMES`` frames of 1280x720, the CLI's default
    ``--frame-limit``), all three stages at float32: the decode rates
    (cv2, sequential and chunk-parallel), the resident loop's and the
    end-to-end frames/s, each over the whole clip."""
    from cut_detection_tpu_torch.cli import bench_pipeline
    from cut_detection_tpu_torch.data import native_video

    t0 = time.perf_counter()
    lines = bench_pipeline.main([clip, "--precision", "float32"])
    wall = time.perf_counter() - t0
    got = {r["metric"]: r for r in lines}
    h, w = GAME_HW
    log(f"tools: bench_pipeline on a seeded game clip ({CLIP_FRAMES} frames "
        f"of {w}x{h}, mp4v, {os.path.getsize(clip):,} B; decoder cv2, "
        f"native decoder "
        f"{'built' if native_video.available() else 'not built'} on this "
        f"host) in {wall:.1f} s: " + "; ".join(
            f"{m} {r['value']} {r['unit']}"
            + (f" ({r['frames']} frames)" if "frames" in r else "")
            for m, r in got.items()) + f" [{card}]")
    want = ["decode_sequential", "decode_parallel",
            "classify_device (float32)", "e2e_classify"]
    if not (list(got) == want and all(r["value"] > 0 for r in lines)
            and got["e2e_classify"]["frames"] == CLIP_FRAMES):
        raise AssertionError(f"tools: bench_pipeline lines {lines}")
    return {m: r["value"] for m, r in got.items()}


def tools_split(card, workdir) -> dict:
    """``split_video`` on the golden clip at ``--decode-workers`` 1 and 4:
    the same JPEG names and bytes."""
    from cut_detection_tpu_torch.cli import split_video

    clip = os.path.join(GOLDEN, "clip.mp4")
    trees, walls = [], []
    for workers in (1, 4):
        out = os.path.join(workdir, f"split_{workers}")
        t0 = time.perf_counter()
        split_video.main([clip, out, "--decode-workers", str(workers)])
        walls.append(time.perf_counter() - t0)
        files = {}
        for name in sorted(os.listdir(out)):
            with open(os.path.join(out, name), "rb") as f:
                files[name] = f.read()
        trees.append(files)
    same = trees[0] == trees[1] and len(trees[0]) == 220
    log(f"tools: split_video {os.path.basename(clip)}: {len(trees[0])} "
        f"JPEGs at --decode-workers 1 in {walls[0]:.2f} s, 4 in "
        f"{walls[1]:.2f} s, bytes {'equal' if same else 'DIFFER'} [{card}]")
    if not same:
        raise AssertionError("tools: split_video bytes differ by workers")
    return {"walls_s": walls}


def phase_tools(dev, card, workdir):
    """The tool entry points on the card as a user runs them: ``doctor``,
    ``export_model``, ``embed_frames`` (on the ``train`` phase's tree and
    contrastive pair), ``bench_pipeline`` and ``split_video``.  The doctor
    runs in its subprocess and the game clip for ``bench_pipeline`` is
    written on a thread (cv2 releases the GIL) while the exports run;
    both are awaited before the timed ``embed_frames``."""
    import threading

    clip = os.path.join(workdir, "game.mp4")
    failed = []

    def write():
        try:
            t0 = time.perf_counter()
            write_game_clip(clip)
            log(f"tools: wrote {os.path.basename(clip)} in "
                f"{time.perf_counter() - t0:.1f} s")
        except BaseException as e:  # re-raised on the phase's thread
            failed.append(e)

    writer = threading.Thread(target=write, daemon=True)
    writer.start()
    try:
        finish_doctor = start_doctor(card)
        out = {"export": tools_export(dev, card, workdir),
               "doctor": finish_doctor()}
    finally:
        writer.join()
    if failed:
        raise failed[0]
    out["embed"] = tools_embed(dev, card, workdir)
    out["bench"] = tools_bench(card, clip)
    out["split"] = tools_split(card, workdir)
    return out


WORKFLOW_GATES = {"frame_accuracy": 0.99, "boundary_precision": 0.90,
                  "boundary_recall": 0.90}  # the JAX corpus gates
SCRIPTS_GAME_FRAMES = 4096   # bench_full_game's clip in this phase
SCRIPTS_DECODE_FRAMES = 2000


def scripts_workflow(card, workdir) -> dict:
    """``e2e_workflow_demo`` at its defaults (the prod shape) on the card:
    the held-out clip at the JAX corpus gates, and ``segment_video``'s
    launches, counted from 0 around that stage alone: ``conv1_block[f32]``
    once and ``conv_block[f32]`` twice a batch of the held-out clip."""
    from cut_detection_tpu_torch.cli import segment_video
    from cut_detection_tpu_torch.scripts import e2e_workflow_demo as demo

    real, seen = segment_video.main, {}

    def counted(args):
        zero_launches()
        out = real(args)
        seen.update(read_launches())
        return out

    segment_video.main = counted
    try:
        rec = demo.main(["--workdir", os.path.join(workdir, "workflow")])
    finally:
        segment_video.main = real
    n_frames = sum(b[1] for b in demo.EVAL_BLOCKS)
    batches = -(-n_frames // BATCH)
    check_launches(f"scripts: the workflow's segment_video ({n_frames} "
                   f"frames, {batches} batches)", seen, per_batch(batches))
    scores = rec["scores"]
    log(f"scripts: workflow at the prod shape: stages {rec['stages_s']} "
        f"(total {rec['total_s']} s), held-out scores {scores}, "
        f"segment_video launches {seen} [{card}]")
    if rec["backend"] != card:
        raise AssertionError(f"scripts: workflow backend {rec['backend']}")
    low = {k: scores[k] for k, bar in WORKFLOW_GATES.items()
           if not scores[k] >= bar}
    if low:
        raise AssertionError(f"scripts: workflow below the gates {low}")
    return rec


def scripts_full_game(card, workdir) -> dict:
    """``bench_full_game`` at ``SCRIPTS_GAME_FRAMES`` frames with its three
    default modes, its clip, CSVs and record in a directory of its own:
    every mode that ran decodes every frame without a failure, yuv420
    is skipped exactly where the native YUV decoder is missing, and the
    record names the card."""
    from cut_detection_tpu_torch.data import native_video
    from cut_detection_tpu_torch.scripts import bench_full_game

    game_dir = tempfile.mkdtemp(dir=workdir, prefix="full_game_")
    env = {"FULL_GAME_FRAMES": str(SCRIPTS_GAME_FRAMES),
           "FULL_GAME_OUT": os.path.join(game_dir, "game.json")}
    saved = {k: os.environ.get(k) for k in (*env, "FULL_GAME_MODES",
                                            "FULL_GAME_WORKERS")}
    saved_tmp = tempfile.tempdir
    os.environ.update(env)
    os.environ.pop("FULL_GAME_MODES", None)
    os.environ.pop("FULL_GAME_WORKERS", None)
    tempfile.tempdir = game_dir
    try:
        rec = bench_full_game.main([])
    finally:
        tempfile.tempdir = saved_tmp
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    yuv = native_video.yuv_available()
    modes = rec["modes"]
    for key, mode in modes.items():
        if "skipped" in mode:
            continue
        if (mode["frames"], mode["decode_failures"]) != (
                SCRIPTS_GAME_FRAMES, 0):
            raise AssertionError(f"scripts: full game {key}: {mode}")
    if ("skipped" in modes["yuv420_uint8_chain"]) == yuv:
        raise AssertionError(f"scripts: full game yuv420 with the YUV "
                             f"decoder {'built' if yuv else 'missing'}: "
                             f"{modes['yuv420_uint8_chain']}")
    if rec["hardware"] != card:
        raise AssertionError(f"scripts: full game hardware "
                             f"{rec['hardware']!r}, card {card!r}")
    log(f"scripts: bench_full_game at {SCRIPTS_GAME_FRAMES} frames: "
        + "; ".join(f"{k} {m}" if "skipped" in m else
                    f"{k} {m['e2e_s']} s, {m['fps']} frames/s, "
                    f"{m['segments']} segments"
                    for k, m in modes.items())
        + f"; csv_parity_bgr {rec.get('csv_parity_bgr')} [{card}]")
    return rec


def _finite_positive(what: str, rec: dict, keys) -> None:
    bad = {k: rec[k] for k in keys
           if not (np.isfinite(rec[k]) and rec[k] > 0)}
    if bad:
        raise AssertionError(f"scripts: {what}: {bad}")


def phase_scripts(dev, card, workdir):
    """The port's workflow and measurement entry points on the card as a
    user runs them: (a) ``e2e_workflow_demo`` at the prod shape, (b)
    ``bench_full_game`` at ``SCRIPTS_GAME_FRAMES`` frames, (c)
    ``bench_train`` and (d) ``profile_simclr_step`` at their defaults,
    (e) ``bench_decode`` at ``SCRIPTS_DECODE_FRAMES`` frames."""
    from cut_detection_tpu_torch.scripts import (
        bench_decode,
        bench_train,
        profile_simclr_step,
    )

    out = {"workflow": scripts_workflow(card, workdir),
           "full_game": scripts_full_game(card, workdir)}
    rec = bench_train.main([])
    _finite_positive("bench_train", rec,
                     [k for k in rec if k.endswith(("_ms", "_per_sec"))])
    bad = [k for k in rec if k.endswith("_loss")
           and not np.isfinite(rec[k])]
    if bad:
        raise AssertionError(f"scripts: bench_train losses {bad}: {rec}")
    log(f"scripts: bench_train {rec} [{card}]")
    out["train"] = rec
    rec = profile_simclr_step.main([])
    _finite_positive("profile_simclr_step", rec,
                     [k for k in rec if k.endswith("_ms")])
    log(f"scripts: profile_simclr_step {rec} [{card}]")
    out["simclr"] = rec
    saved_tmp = tempfile.tempdir
    tempfile.tempdir = tempfile.mkdtemp(dir=workdir, prefix="decode_")
    try:
        rec = bench_decode.main([str(SCRIPTS_DECODE_FRAMES)])
    finally:
        tempfile.tempdir = saved_tmp
    _finite_positive("bench_decode", rec,
                     ["cv2_threads_1", "cv2_threads_0"])
    log(f"scripts: bench_decode at {SCRIPTS_DECODE_FRAMES} frames {rec} "
        f"[{card}]")
    out["decode"] = rec
    return out


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


PROFILE_STEPS = 10  # calls per timed loop of the profile phase


def phase_profile(dev):
    """The layer-1 stage-bisection kernel (``conv1_stages``), at batch 128
    of the profiling script's seeded inputs: each stage's kernel against
    its plain version (``conv1_stages.check_stage``: ``cast`` and
    ``taps`` exact, the sums within the tolerances stated there, which
    must reject the plain version without the bf16 rounding and a
    ``dott`` sink of accumulators with rolled channels), its times
    beside its bound, its plain version's and, for ``dotn`` and
    ``dott``, ``torch.matmul`` of the same bf16 products, strip by strip
    (one batched call on an im2col made outside it).  Then the entry
    point ``profile_fused_conv1`` with its launches counted (one warm-up
    call and ``3 * PROFILE_STEPS`` timed ones a stage) and its cumulative
    table of microseconds an image.  Returns ``(rows, launches)``."""
    from cut_detection_tpu_torch.ops.kernels import conv1_stages as cs
    from cut_detection_tpu_torch.scripts import profile_fused_conv1 as prof

    x, w = prof.seeded_inputs(BATCH, dev)
    a = torch.zeros((BATCH * cs.N_STRIPS, cs.K, cs.M), dtype=torch.bfloat16,
                    device=dev)
    a[:, :27] = cs.im2col(x).reshape(BATCH, 27, cs.N_STRIPS, cs.M) \
        .permute(0, 2, 1, 3).reshape(-1, 27, cs.M).to(torch.bfloat16)
    a_t = a.transpose(1, 2).contiguous()
    w_t = w.t().contiguous()
    library = {"dotn": lambda: torch.matmul(w, a),
               "dott": lambda: torch.matmul(a_t, w_t)}
    nbytes = (x.numel() + w.numel() * 2 + BATCH * cs.OUT * cs.OUT * 4
              + BATCH * 4)
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    # The products the conv needs: 27 taps (the weights' columns 27-31
    # meet the TPU kernel's zero im2col rows), the 48 channels unpadded.
    by_ops = 1e3 * 2 * cs.COUT * 27 * cs.M * cs.N_STRIPS * BATCH \
        / PEAK_FLOPS["bf16"]
    rows = {}
    for stage in cs.STAGES:
        got = cs.conv1_stages(x, w, stage)
        want = cs.conv1_stages_plain(x, w, stage)
        torch.cuda.synchronize()
        err = cs.check_stage(stage, x, w, got, want)
        if not torch.isfinite(got[0]).all():
            raise AssertionError(f"conv1_stages[{stage}]: non-finite out")

        def call(stage=stage):
            return cs.conv1_stages(x, w, stage)

        ms = cuda_ms(call)
        streamed = stream_ms(call)
        plain_ms = cuda_ms(lambda: cs.conv1_stages_plain(x, w, stage),
                           reps=3, warmup=1)
        lib_ms = cuda_ms(library[stage]) if stage in library else None
        bnd = (by_bytes, "bytes") if stage in ("cast", "taps") or \
            by_bytes >= by_ops else (by_ops, "operations")
        lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
        log(f"profile: conv1_stages[{stage}] max_abs_err {err:.3e} "
            f"(conv1_stages.check_stage) kernel {ms:.4f} ms ({streamed:.4f}"
            f" ms a call streamed) plain {plain_ms:.4f} ms library {lib} "
            f"bound {bnd[0]:.4f} ms ({bnd[1]}) OK")
        rows[f"conv1_stages[{stage}]"] = {
            "max_abs_err": err, "ms": ms, "stream_ms": streamed,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1]}

    # The checks' power at this size: the plain version without the bf16
    # rounding (tpose, full) and a dott sink of accumulators whose
    # channels are rolled by one must each fail check_stage.
    rounded = cs._bf16_relu
    for stage in ("tpose", "full"):
        want = cs.conv1_stages_plain(x, w, stage)
        cs._bf16_relu = torch.relu
        try:
            unrounded = cs.conv1_stages_plain(x, w, stage)
        finally:
            cs._bf16_relu = rounded
        try:
            cs.check_stage(stage, x, w, unrounded, want)
        except AssertionError:
            log(f"profile: check_stage rejects {stage} without the bf16 "
                "rounding")
        else:
            raise AssertionError(f"check_stage({stage}) passes the sums "
                                 "without the bf16 rounding")
    want = cs.conv1_stages_plain(x, w, "dott")
    rolled = cs.dott_sink(cs.conv_acc(x, w).roll(1, dims=1))
    try:
        cs.check_stage("dott", x, w, (want[0], rolled), want)
    except AssertionError:
        log("profile: check_stage rejects a dott sink of rolled channels")
    else:
        raise AssertionError("check_stage(dott) passes rolled channels")

    zero_launches()
    out = prof.run(BATCH, PROFILE_STEPS, cs.STAGES, dev)
    launches = read_launches()
    want = dict.fromkeys(launches, 0)
    for stage in cs.STAGES:
        want[f"conv1_stages[{stage}]"] = 1 + 3 * PROFILE_STEPS
    log(f"profile: entry point, launches {launches}")
    check_launches("profile_fused_conv1", launches, want)
    log(f"profile: {json.dumps(out)}")
    us = {st: out[st + "_us_per_img"] for st in cs.STAGES}
    log("profile: stage (cumulative) | us/img | delta")
    for stage, base in (("cast", None), ("taps", "cast"), ("dotn", "taps"),
                        ("dott", "taps"), ("tpose", "dotn"),
                        ("full", "tpose")):
        delta = us[stage] - (us[base] if base else 0.0)
        log(f"profile: {stage} | {us[stage]:.4f} | {delta:+.4f}"
            f"{f' vs {base}' if base else ''}")
    return rows, launches


def phase_serve(dev, workdir):
    """The serving daemon in this process on the card (``make_server``
    at port 0, warmed up, the device heartbeat on): ``/healthz``;
    ``/segment`` of ``clip.mp4`` at float32, ``transfer: "bgr"``, whose
    CSV must be the reference's bytes; ``/segment_batch`` of both golden
    clips (each CSV the reference's); ``/reload`` to ``bfloat16_full``, a
    ``/segment`` there (frame accuracy >= 0.99 against the reference),
    ``/reload`` back; ``/metrics``.  The block kernels' launches are
    counted inside each request and must be the path's per batch times
    the request's batches.  Then the server, its heartbeat and every
    thread and process it started are stopped, and none may be left.
    Returns the requests' launches."""
    import shutil
    import threading
    import urllib.request

    from cut_detection_tpu_torch.cli import serve
    from cut_detection_tpu_torch.cli.evaluate import evaluate
    from cut_detection_tpu_torch.pipeline import available_decoder

    if available_decoder() is None:
        raise RuntimeError("serve: no video decoder on this machine")
    threads0, pids0 = set(threading.enumerate()), set(_child_pids())
    t0 = time.perf_counter()
    server, state = serve.make_server("127.0.0.1", 0, warmup=True,
                                      heartbeat_interval=0.2, device=dev,
                                      transfer="auto")
    log(f"serve: make_server with warmup {time.perf_counter() - t0:.2f} s, "
        f"transfer auto -> {state.transfer}")
    loop = threading.Thread(target=server.serve_forever, daemon=True)
    loop.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def call(path, payload=None):
        data = None if payload is None else json.dumps(payload).encode()
        req = urllib.request.Request(base + path, data=data,
                                     method="GET" if data is None
                                     else "POST")
        with urllib.request.urlopen(req, timeout=300) as resp:
            return json.loads(resp.read())

    def counted(what, precision, path, payload):
        zero_launches()
        t = time.perf_counter()
        res = call(path, payload)
        wall = time.perf_counter() - t
        got = read_launches()
        items = res["results"] if "results" in res else [res]
        batches = sum(r["stats"]["batches"] for r in items)
        check_launches(f"serve {what}", got, per_batch(batches, precision))
        if not any(got.values()):
            raise AssertionError(f"serve {what}: no kernel launched")
        log(f"serve: {what} {wall:.2f} s, {batches} batches, launches "
            f"{ {k: v for k, v in got.items() if v} }")
        return res, got

    launches = collections.Counter()
    try:
        deadline = time.time() + 10
        while True:
            health = call("/healthz")
            dev_ok = health["device"] and health["device"]["ok_age_s"] < 5
            if dev_ok or time.time() > deadline:
                break
            time.sleep(0.1)
        log(f"serve: /healthz {health}")
        if health["status"] != "ok" or not dev_ok or \
                health["device"]["last_error"] is not None:
            raise AssertionError(f"serve: /healthz {health}")
        clips = []
        for clip, ref, n in GOLDEN_CLIPS:
            path = os.path.join(workdir, "serve_" + clip)
            shutil.copy(os.path.join(GOLDEN, clip), path)
            clips.append((path, os.path.join(GOLDEN, ref), n))
        out = os.path.join(workdir, "served.csv")
        res, got = counted("/segment clip.mp4 float32", "float32",
                           "/segment", {"input_path": clips[0][0],
                                        "output_path": out,
                                        "transfer": "bgr"})
        launches.update(got)
        with open(out, "rb") as f, open(clips[0][1], "rb") as g:
            if f.read() != g.read():
                raise AssertionError("serve: /segment CSV differs from "
                                     "ref_segments.csv")
        res, got = counted("/segment_batch golden clips float32",
                           "float32", "/segment_batch",
                           {"input_paths": [c[0] for c in clips],
                            "transfer": "bgr"})
        launches.update(got)
        for r, (_, ref, _) in zip(res["results"], clips):
            with open(r["output_path"], "rb") as f, open(ref, "rb") as g:
                if f.read() != g.read():
                    raise AssertionError(f"serve: /segment_batch CSV "
                                         f"differs from {ref}")
        log("serve: /segment and /segment_batch CSVs byte-identical to the "
            "references")
        t = time.perf_counter()
        res = call("/reload", {"precision": "bfloat16_full"})
        log(f"serve: /reload bfloat16_full {time.perf_counter() - t:.2f} s "
            f"(warmed) -> {res}")
        out = os.path.join(workdir, "served_bf16.csv")
        counted("/segment clip.mp4 bfloat16_full", "bfloat16_full",
                "/segment", {"input_path": clips[0][0], "output_path": out,
                             "transfer": "bgr"})
        acc = evaluate(out, clips[0][1], clips[0][2])["frame_accuracy"]
        log(f"serve: bfloat16_full frame accuracy {acc}")
        if acc < 0.99:
            raise AssertionError(f"serve: bfloat16_full accuracy {acc}")
        res = call("/reload", {"precision": "float32"})
        if res["precision"] != "float32" or state.net.precision != \
                "float32":
            raise AssertionError(f"serve: /reload back failed: {res}")
        metrics = call("/metrics")
        log(f"serve: /metrics {metrics}")
        if metrics["requests_served"] != 4 or metrics["requests_failed"]:
            raise AssertionError(f"serve: /metrics {metrics}")
    finally:
        server.shutdown()
        server.server_close()
        loop.join(10)
        if state.heartbeat is not None:
            state.heartbeat.stop()
            state.heartbeat.join(10)
    deadline = time.time() + 10
    while time.time() < deadline:
        left = [t for t in threading.enumerate() if t not in threads0
                and t.is_alive()]
        if not left:
            break
        time.sleep(0.1)
    if left:
        raise AssertionError(f"serve: threads left running: {left}")
    # (The golden phase's shared-memory rings leave multiprocessing's
    # resource tracker running until ``stop_children``.)
    started = sorted(set(_child_pids()) - pids0)
    if started:
        raise AssertionError(f"serve: processes left: {started}")
    log("serve: shut down, no thread or process of its own left")
    return dict(launches)


# The sharded loop against the unsharded one: float32 within
# tests/test_parallel.py's 1e-5.  At int8_mxu the pooled features and the
# head's hidden layer are rounded to bf16 after cuBLAS sums them, and it
# sums a GEMM of 32 or 64 rows in another order than one of 128, so a
# rounding may land one bf16 ulp apart, as between the card and the CPU:
# the rung's QUANT_CONF_TOL (2.403e-4 measured over 2 shards of one
# card, 6.504e-3 over 4 cards).
# The tensor-parallel step (g) against the unsharded one: float32 within
# the same 1e-5; at the other rungs QUANT_CONF_TOL, for the same cause
# (the hidden FC layer's GEMM of 16 or 8 output columns sums in another
# order than one of 32).
PARALLEL_CONF_TOL = {p: 1e-5 if p == "float32" else QUANT_CONF_TOL
                     for p in ("float32", "bfloat16", "bfloat16_full",
                               "uint8_pool", "uint8_chain", "int8_mxu")}
PARALLEL_PARAM_TOL = 2e-3  # a first AdamW step: 2 * lr where a near-zero
                           # gradient's sign differs (test_parallel.py),
                           # plus two ulps of the parameter (the roundings
                           # of p - lr and p + lr), as params_within takes
PARALLEL_STAT_TOL = 1e-5   # BN running statistics: global-batch moments
# Each all-reduced gradient leaf against the single rank's, relative to
# the leaf's norm.  A gradient missing the other ranks' terms, halved or
# of the wrong sign is off by 1e-1 or more (0.17-24.9 for four such
# faults in tests/test_torch_distributed.py), and a first Adam step
# passes any of those within PARALLEL_PARAM_TOL: the gradients carry the
# check.  The float32 sums run in another order: layer 1's weight
# gradient sums millions of products, and cuDNN picks its algorithm by
# the shard's shape; 2.710e-5 over 2 ranks, 2.210e-4 over 4 (3.9e-5 on
# the CPU, whose bar is 1e-4).
PARALLEL_GRAD_RTOL = 1e-3


def off_device_kernels(dev) -> dict:
    """Every kernel route launched on ``dev`` while the caller keeps
    another card current, each against its plain version on the same
    inputs on ``dev``: layer 1 and the mid-stack block at float32 (the
    FMA route) on the prod net, the int8 blocks (the tensor-core routes),
    the resize + normalize and YUV -> BGR kernels and the stage bisection
    of layer 1.  Returns ``{kernel: max_abs_err}``; raises where one
    parts from its plain version or writes to another device."""
    from cut_detection_tpu_torch.models.assembly import (
        load_default_net,
        precompute_rings,
    )
    from cut_detection_tpu_torch.ops.kernels import conv1_stages as cs
    from cut_detection_tpu_torch.ops.kernels.conv1_block import (
        conv1_block,
        conv1_block_plain,
    )
    from cut_detection_tpu_torch.ops.kernels.conv_block import (
        conv_block,
        conv_block_plain,
    )
    from cut_detection_tpu_torch.ops.kernels.conv_block_i8 import (
        conv1_block_i8,
        conv1_block_i8_plain,
        conv_block_i8,
        conv_block_i8_plain,
    )
    from cut_detection_tpu_torch.ops.kernels.resize_normalize import (
        resize_normalize,
        resize_normalize_plain,
    )
    from cut_detection_tpu_torch.ops.kernels.yuv420_to_bgr import (
        yuv420_to_bgr,
        yuv420_to_bgr_plain,
    )
    from cut_detection_tpu_torch.pipeline import frozen_copy
    from cut_detection_tpu_torch.scripts.profile_fused_conv1 import (
        seeded_inputs,
    )

    errs = {}

    def held(name, got, want, tol):
        if got.device != dev:
            raise AssertionError(f"{name} wrote to {got.device}, not {dev}")
        err = float((got.float() - want.float()).abs().max())
        if err > tol:
            raise AssertionError(f"{name} on {dev}: off its plain version "
                                 f"by {err} > {tol}")
        errs[name] = err

    frames = synthetic_frames(8)
    x = torch.from_numpy(frames).to(dev)
    with torch.inference_mode():
        net = frozen_copy(load_default_net(dev)[0])
        h = x
        for i, layer in enumerate(net.conv.conv_layers):
            args = layer.kernel_args()
            kernel, plain = ((conv1_block, conv1_block_plain) if i == 0
                             else (conv_block, conv_block_plain))
            got = kernel(h, *args)
            held(f"{kernel.__name__}[f32] layer {i + 1}", got,
                 plain(h, *args), F32_TOL)
            h = got
        net = frozen_copy(load_default_net(dev, "int8_mxu")[0])
        h, affine = x, None
        for i, (layer, ring) in enumerate(zip(
                net.conv.conv_layers, precompute_rings(net, *MODEL_HW))):
            k, so, scale = layer.i8_args(affine)
            kernel, plain = ((conv1_block_i8, conv1_block_i8_plain) if i == 0
                             else (conv_block_i8, conv_block_i8_plain))
            got = kernel(h, k, so, ring, scale)
            held(f"{kernel.__name__} layer {i + 1}", got,
                 plain(h, k, so, ring, scale), 0.0)
            h, affine = got, layer.i8_pending_affine()
        src = torch.from_numpy(np.random.default_rng(5).integers(
            0, 256, (4, *SRC_HW, 3), dtype=np.uint8)).to(dev)
        held("resize_normalize", resize_normalize(src, *MODEL_HW),
             resize_normalize_plain(src, *MODEL_HW), K5_TOL)
        planes = torch.from_numpy(yuv420_planes(frames)).to(dev)
        held("yuv420_to_bgr", yuv420_to_bgr(planes, *MODEL_HW),
             yuv420_to_bgr_plain(planes, *MODEL_HW), 0.0)
        xs, w = seeded_inputs(3, dev)
        got = cs.conv1_stages(xs, w, "full")
        if got[0].device != dev:
            raise AssertionError(f"conv1_stages wrote to {got[0].device}")
        errs["conv1_stages[full]"] = cs.check_stage(
            "full", xs, w, got, cs.conv1_stages_plain(xs, w, "full"))
    return errs


def parallel_classify(cards, frames, workdir) -> dict:
    """(a) The slice stream through the device loop with its batches
    split over a mesh of every card (one card listed twice where there
    is one), at float32 and ``int8_mxu``, against the unsharded loop on
    the first card: the same classes and CSV bytes, conf within
    ``PARALLEL_CONF_TOL``, each shard's launches; then frames/s of both
    loops on a longer stream."""
    from cut_detection_tpu_torch.models.assembly import load_default_net
    from cut_detection_tpu_torch.parallel.mesh import make_mesh
    from cut_detection_tpu_torch.pipeline import (
        batch_frames,
        classify_batches,
    )

    mesh = make_mesh(cards if len(cards) > 1 else cards * 2)
    shards = len(mesh.devices)
    log(f"parallel: mesh over {[str(d) for d in mesh.devices]}" + (
        " (the one card listed twice: the split and the gather run, the "
        "shards share the card)" if len(cards) == 1 else ""))
    long = np.concatenate([frames] * 5)
    out = {}
    for precision in ("float32", "int8_mxu"):
        net, _ = load_default_net(cards[0], precision)

        def run(stream, m=None):
            t0 = time.perf_counter()
            res = classify_batches(batch_frames(iter(stream), BATCH), net,
                                   batch_size=BATCH, length=len(stream),
                                   print_every=0, mesh=m)
            return res, time.perf_counter() - t0

        (conf1, pred1, _), _ = run(frames)
        zero_launches()
        (conf, pred, stats), _ = run(frames, mesh)
        launches = read_launches()
        check_launches(f"parallel {precision}", launches,
                       per_batch(stats.batches * shards, precision))
        if not np.array_equal(pred, pred1):
            raise AssertionError(f"parallel {precision}: classes differ "
                                 "from the unsharded loop")
        err = float(np.abs(conf - conf1).max())
        if err > PARALLEL_CONF_TOL[precision]:
            raise AssertionError(f"parallel {precision}: conf off by {err}")
        same = (_csv_bytes(conf, pred, os.path.join(workdir, "m.csv"))
                == _csv_bytes(conf1, pred1, os.path.join(workdir, "u.csv")))
        if not same:
            raise AssertionError(f"parallel {precision}: CSV differs")
        walls = {}
        for tag, m in (("unsharded", None), ("sharded", mesh),
                       ("sharded", mesh), ("unsharded", None)):
            walls.setdefault(tag, []).append(run(long, m)[1])
        fps = {tag: round(len(long) / min(w), 1) for tag, w in walls.items()}
        log(f"parallel: {precision} sharded over {shards}, {stats.batches} "
            f"batches: classes and CSV identical, conf max_abs_err "
            f"{err:.3e} (tol {PARALLEL_CONF_TOL[precision]:.0e}), "
            f"launches "
            f"{ {k: v for k, v in launches.items() if v} }; frames/s on "
            f"{len(long)} frames (best of 2): {fps}")
        out[precision] = {"conf_err": err, "fps": fps}
    return out


# (g) The tensor-parallel runs on one card: (rung, model columns) over
# [cuda:0] * 4, so model 2 has 2 data rows and model 4 one.
TP_RUNS = (("float32", 2), ("float32", 4), ("int8_mxu", 2),
           ("int8_mxu", 4), ("bfloat16", 2), ("bfloat16_full", 2),
           ("uint8_pool", 2), ("uint8_chain", 2))
# The block instances the tensor-parallel step launches, each at 24
# output channels (model 2) and 12 (model 4).
TP_INSTANCES = ("conv1_block[f32]", "conv1_block[bf16_xla]",
                "conv1_block[i8]", "conv_block[f32]",
                "conv_block[bf16_operands]", "conv_block[bf16_xla]",
                "conv_block[bf16_xla_f32]", "conv_block[i8]")


def tensor_parallel_kernels(dev, frames) -> dict:
    """Every block-kernel instance the tensor-parallel step launches, at
    the widths it launches them: the step at each kernel rung at model 2
    and 4 over ``[dev] * model`` on one batch, with the blocks' wrappers
    (``models.layers``' names) swapped for ones that also run the plain
    version on the same arguments and hold the kernel to it: ``F32_TOL``
    for ``f32`` and ``bf16_operands``, ``tolerance.xla_check`` for the
    ``bf16_xla`` instances, a max diff of 0 for the int8 ones.  Returns
    ``{(instance, output channels): worst error}``; raises where one
    disagrees or one of ``TP_INSTANCES`` at 24 or 12 channels was not
    launched."""
    from cut_detection_tpu_torch.models import layers
    from cut_detection_tpu_torch.models.assembly import load_default_net
    from cut_detection_tpu_torch.ops.kernels import conv_block as cb
    from cut_detection_tpu_torch.ops.kernels import conv_block_i8 as k8
    from cut_detection_tpu_torch.ops.kernels.conv1_block import (
        conv1_block_plain,
    )
    from cut_detection_tpu_torch.ops.kernels.conv1_block import (
        instance as conv1_instance,
    )
    from cut_detection_tpu_torch.ops.kernels.tolerance import xla_check
    from cut_detection_tpu_torch.parallel import (
        make_mesh,
        make_sharded_classify_step,
    )

    errs = {}

    def held(name, fn, plain, inst_of):
        def call(x, kernel, *args, **kw):
            got = fn(x, kernel, *args, **kw)
            want = plain(x, kernel, *args, **kw)
            inst = f"{name}[{inst_of(kw)}]"
            err = float((got.float() - want.float()).abs().max())
            if inst.endswith("[i8]"):
                ok = err == 0
            elif "bf16_xla" in inst:
                ok = xla_check(got, want, args[2], args[1], args[0])[0]
            else:
                ok = err <= F32_TOL
            if not ok:
                raise AssertionError(f"tensor parallel: {inst} at "
                                     f"{tuple(x.shape)} -> "
                                     f"{kernel.shape[-1]} channels off its "
                                     f"plain version by {err}")
            key = (inst, kernel.shape[-1])
            errs[key] = max(errs.get(key, 0.0), err)
            return got
        return call

    swaps = {
        "conv1_block": held("conv1_block", layers.conv1_block,
                            conv1_block_plain, lambda kw: conv1_instance(
                                kw.get("compute_dtype"),
                                kw.get("numerics", "pallas"))[0]),
        "conv_block": held("conv_block", layers.conv_block,
                           cb.conv_block_plain, lambda kw: cb.instance(
                               kw.get("compute_dtype"),
                               kw.get("out_dtype", torch.float32),
                               kw.get("numerics", "pallas"))[0]),
        "conv1_block_i8": held("conv1_block", layers.conv1_block_i8,
                               k8.conv1_block_i8_plain, lambda kw: "i8"),
        "conv_block_i8": held("conv_block", layers.conv_block_i8,
                              k8.conv_block_i8_plain, lambda kw: "i8"),
    }
    saved = {name: getattr(layers, name) for name in swaps}
    x = torch.from_numpy(frames).to(dev)
    try:
        for name, fn in swaps.items():
            setattr(layers, name, fn)
        for precision in ("float32", "bfloat16", "bfloat16_full",
                          "int8_mxu"):
            net, _ = load_default_net(dev, precision)
            for model in (2, 4):
                make_sharded_classify_step(
                    net, make_mesh([dev] * model, model_parallel=model),
                    tensor_parallel=True)(x)
        torch.cuda.synchronize()
    finally:
        for name, fn in saved.items():
            setattr(layers, name, fn)
    missing = {(i, c) for i in TP_INSTANCES for c in (24, 12)} - set(errs)
    if missing:
        raise AssertionError(f"tensor parallel: not launched {missing}")
    return errs


def parallel_tensor(cards, frames, workdir) -> dict:
    """(g) ``dryrun_multichip``'s tensor-parallel part
    (``__graft_entry__.py:72-84``): first each block-kernel instance of
    the step at 24 and 12 output channels against its plain version
    (``tensor_parallel_kernels``); then the slice stream through
    ``make_sharded_classify_step(..., tensor_parallel=True)`` at each of
    ``TP_RUNS`` over ``[cuda:0] * 4`` and, with two or more cards, at
    float32 and ``int8_mxu`` at model 2 over the cards (and model 4 over
    four): the classes and CSV bytes of the unsharded step on the first
    card, conf within ``PARALLEL_CONF_TOL``, each block kernel launched
    (data rows x model columns) times a batch for each layer that runs
    it, and ms a batch and frames/s of the unsharded, data-parallel (the
    same mesh, frames over its data rows) and tensor-parallel steps on a
    resident batch (median of 20)."""
    from cut_detection_tpu_torch.models.assembly import load_default_net
    from cut_detection_tpu_torch.parallel import (
        make_mesh,
        make_sharded_classify_step,
    )
    from cut_detection_tpu_torch.pipeline import make_classify_step

    errs = tensor_parallel_kernels(cards[0], frames[:BATCH])
    log("parallel (g): block kernels at the tensor-parallel widths against "
        "their plain versions, worst error by (instance, Cout): "
        + ", ".join(f"{i} {c}: {e:.3e}" for (i, c), e in sorted(
            errs.items())))
    runs = [(p, make_mesh([cards[0]] * 4, model_parallel=m))
            for p, m in TP_RUNS]
    n = len(cards)
    if n >= 2:
        runs += [(p, make_mesh(cards[:n - n % 2], model_parallel=2))
                 for p in ("float32", "int8_mxu")]
    if n >= 4:
        runs += [(p, make_mesh(cards[:n - n % 4], model_parallel=4))
                 for p in ("float32", "int8_mxu")]
    batches = [frames[i:i + BATCH] for i in range(0, len(frames), BATCH)]
    batches[-1] = np.concatenate([batches[-1], np.zeros(
        (BATCH - len(batches[-1]), *frames.shape[1:]), np.uint8)])
    resident = torch.from_numpy(batches[0]).to(cards[0])
    # "launches": by rung, the one-card model-2 run's, for the kernel rows.
    out = {"kernels": {f"{i} {c}": e for (i, c), e in errs.items()},
           "runs": {}, "launches": {}}
    for precision, mesh in runs:
        net, _ = load_default_net(cards[0], precision)
        one = make_classify_step(net)
        tp = make_sharded_classify_step(net, mesh, tensor_parallel=True)

        def stream(step, upload):
            got = [step(torch.from_numpy(b).to(cards[0]) if upload
                        else b) for b in batches]
            return tuple(torch.cat([g[k] for g in got]).cpu().numpy()
                         [:len(frames)] for k in range(2))

        conf1, pred1 = stream(one, True)
        zero_launches()
        conf, pred = stream(tp, False)
        torch.cuda.synchronize()
        launches = read_launches()
        rows, cols = mesh.shape["data"], mesh.shape["model"]
        where = (f"{precision} model {cols} x data {rows} over "
                 f"{sorted({str(d) for d in mesh.devices})}")
        check_launches(f"parallel (g) {where}", launches,
                       per_batch(len(batches) * rows * cols, precision))
        if not np.array_equal(pred, pred1):
            raise AssertionError(f"parallel (g) {where}: classes differ "
                                 "from the unsharded step")
        err = float(np.abs(conf - conf1).max())
        if err > PARALLEL_CONF_TOL[precision]:
            raise AssertionError(f"parallel (g) {where}: conf off by {err}")
        if (_csv_bytes(conf, pred, os.path.join(workdir, "tp.csv"))
                != _csv_bytes(conf1, pred1, os.path.join(workdir,
                                                          "tp1.csv"))):
            raise AssertionError(f"parallel (g) {where}: CSV differs")
        dp = make_classify_step(net, mesh=mesh)
        ms = {tag: host_ms(lambda: step(resident))
              for tag, step in (("unsharded", one), ("data_parallel", dp),
                                ("tensor_parallel", tp))}
        fps = {tag: round(1e3 * BATCH / t, 1) for tag, t in ms.items()}
        log(f"parallel (g): {where}, {len(batches)} batches: classes and "
            f"CSV identical, conf max_abs_err {err:.3e} (tol "
            f"{PARALLEL_CONF_TOL[precision]:.0e}), launches "
            f"{ {k: v for k, v in launches.items() if v} }; ms a batch "
            f"{ {k: round(v, 4) for k, v in ms.items()} }, frames/s {fps}")
        out["runs"][where] = {"conf_err": err, "launches": {
            k: v for k, v in launches.items() if v}, "ms": ms, "fps": fps}
        if cols == 2 and len(set(mesh.devices)) == 1:
            out["launches"][precision] = launches
    return out


def params_within(a, b, tol: float) -> bool:
    """``|a - b| <= tol`` plus two ulps of ``b`` on every element."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return bool(np.all(np.abs(a - b) <= tol + 2 * np.spacing(np.abs(b))))


def _step_held(what, res, prefix, loss_key, state, loss):
    """A rank's step (``res``) against the single-rank ``state``/``loss``:
    the loss within rtol 1e-5, each gradient leaf within
    ``PARALLEL_GRAD_RTOL`` of its norm, parameters ``PARALLEL_PARAM_TOL``,
    BN statistics ``PARALLEL_STAT_TOL``; returns the worst of each."""
    rel = abs(float(res[loss_key]) - loss) / max(abs(loss), 1e-30)
    leaf, grad = _worst_leaf({k: res[f"{prefix}_grad/{k}"]
                              for k, _ in state.net.named_parameters()},
                             _grads(state.net))
    worst = {"loss_rel": rel, "grad_rel": grad, "grad_leaf": leaf,
             "param": 0.0, "stat": 0.0}
    ok = rel <= 1e-5 and grad <= PARALLEL_GRAD_RTOL
    for k, v in state.net.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        a, b = res[f"{prefix}/{k}"], v.cpu().numpy()
        kind = "stat" if "running" in k else "param"
        worst[kind] = max(worst[kind], float(np.abs(a - b).max()))
        ok &= params_within(a, b, PARALLEL_PARAM_TOL if kind == "param"
                            else PARALLEL_STAT_TOL)
    if not ok:
        raise AssertionError(f"parallel {what}: 2 ranks against 1: {worst}")
    return worst


def parallel_train(dev, workdir) -> dict:
    """(b) A 2-rank group (``local_cluster``: NCCL with a card a rank, else
    gloo over CUDA tensors on the one card) runs the supervised step at
    the prod net's widths (batch 128 of 144x256) and the contrastive
    step at the contrastive defaults (32 frames of 360x640), each rank on
    its half, and a tiny ``train_supervised`` with tails; the steps
    against the single-rank step on the whole batch."""
    from cut_detection_tpu_torch.parallel import local_cluster as lc

    out_dir = tempfile.mkdtemp(dir=workdir)
    t0 = time.perf_counter()
    texts = lc.spawn_cluster(2, device="cuda", widths="prod", out=out_dir,
                             timeout=300)
    wall = time.perf_counter() - t0
    backend = re.search(r"backend=(\w+)", texts[0]).group(1)
    ranks = [dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
             for r in range(2)]
    for k in ranks[0]:
        if not np.array_equal(ranks[0][k], ranks[1][k]):
            raise AssertionError(f"parallel: ranks differ on {k}")
    cfg, x, y = lc.supervised_case("prod")
    state, m = lc.supervised_step(cfg, x, y, dev)
    sup = _step_held("supervised", ranks[0], "sup", "sup_loss", state,
                     float(m["loss"]))
    cfg, x = lc.contrastive_case("prod")
    state, m = lc.contrastive_step(cfg, x, dev)
    con = _step_held("contrastive", ranks[0], "con", "con_loss", state,
                     float(m["loss"]))
    history = json.loads(str(ranks[0]["tail_history"]))
    if int(ranks[0]["tail_steps"]) != 8 or not all(
            np.isfinite(h["train_loss"]) for h in history):
        raise AssertionError(f"parallel: tail run {history}")
    log(f"parallel: 2 ranks over {backend} ({wall:.1f} s with start-up): "
        f"supervised at batch {len(y)} {sup}, contrastive at batch "
        f"{len(x)} {con}; ranks equal; tail run 8 steps, validation tail "
        f"counted once")
    return {"backend": backend, "supervised": sup, "contrastive": con,
            "wall_s": wall}


def parallel_multi_host(workdir) -> None:
    """(c) ``segment_videos --multi-host --data-parallel`` as two processes
    with torchrun's variables over the golden clips: each takes its
    round-robin video, and the union of their CSVs is the single-process
    run's, byte for byte (and the references')."""
    import shutil

    from cut_detection_tpu_torch.cli import segment_videos
    from cut_detection_tpu_torch.parallel.distributed import free_port

    runs = {}
    for tag in ("single", "multi"):
        d = os.path.join(workdir, "mh_" + tag)
        os.makedirs(d)
        runs[tag] = [shutil.copy(os.path.join(GOLDEN, c), d)
                     for c in ("clip.mp4", "clip_odd.mp4")]
    flags = ["--transfer", "bgr", "--data-parallel"]
    segment_videos.main(runs["single"] + flags)
    port = str(free_port())
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=ROOT, RANK=str(rank),
                   WORLD_SIZE="2", LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE="2", MASTER_ADDR="localhost",
                   MASTER_PORT=port)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "cut_detection_tpu_torch.cli."
             "segment_videos", *runs["multi"], *flags, "--multi-host"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    texts = []
    try:
        for proc in procs:
            texts.append(proc.communicate(timeout=300)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for rank, (proc, text) in enumerate(zip(procs, texts)):
        if proc.returncode or f"process {rank} segments 1 of 2" not in text:
            raise AssertionError(f"multi-host rank {rank} rc "
                                 f"{proc.returncode}:\n{text[-3000:]}")
    def read(path):
        with open(path, "rb") as f:
            return f.read()

    for a, b, ref in zip(runs["single"], runs["multi"],
                         ("ref_segments.csv", "ref_segments_odd.csv")):
        got = [read(p[:-4] + "_segments.csv") for p in (a, b)]
        if not got[0] == got[1] == read(os.path.join(GOLDEN, ref)):
            raise AssertionError(f"multi-host: {os.path.basename(b)}'s CSV "
                                 "differs from the single process's")
    log("parallel: segment_videos --multi-host --data-parallel as 2 "
        "torchrun-style processes: one video each, the union of their "
        "CSVs the single process's and the references' byte for byte")


def parallel_train_cli(workdir, n: int) -> dict:
    """(e) ``train_supervised --data-parallel`` over the ``n`` cards (the
    CLI spawns a rank a card) on a tree of 171 labelled JPEGs, one epoch
    of one global batch of 128 and a validation split of 43 (which does
    not divide over the ranks), against the same CLI on one card: the
    step's gradients, read from the epoch snapshot's first Adam moment
    (``0.1 g`` after one step), each leaf within ``PARALLEL_GRAD_RTOL`` of
    its norm; every parameter of the two triplets within
    ``PARALLEL_PARAM_TOL``; the data-parallel triplet finite."""
    from cut_detection_tpu_torch.checkpoint.convert import params_from_jax
    from cut_detection_tpu_torch.checkpoint.io import load_bundle
    from cut_detection_tpu_torch.cli import train_supervised

    tree = os.path.join(workdir, "dp_tree")
    os.makedirs(tree)
    write_frame_tree(tree, 171)  # floor(171 * 0.75) = 128 to train
    walls, params, moments = {}, {}, {}
    for tag, flags in (("one card", []), (f"{n} ranks", ["--data-parallel"])):
        models = os.path.join(workdir, f"dp_models_{len(flags)}")
        t0 = time.perf_counter()
        train_supervised.main(["--data-dirs", tree, "--epochs", "1",
                               "--num-workers", "2", "--model-dir", models,
                               "--model-name", "dp", *flags])
        walls[tag] = time.perf_counter() - t0
        params[tag] = params_from_jax({
            part: load_bundle(os.path.join(
                models, f"dp_classifier_{part}.npz"))
            for part in ("conv", "linear")})
        with np.load(os.path.join(models, "train_state_0000.npz")) as z:
            moments[tag] = {k: z[k] for k in z.files
                            if k.startswith("optimizer/")
                            and k.endswith("/exp_avg")}
    a, b = params.values()
    keys = [k for k in a if "running" not in k]
    worst = max(float((a[k] - b[k]).abs().max()) for k in keys)
    ma, mb = moments.values()
    if not ma or ma.keys() != mb.keys():
        raise AssertionError(f"parallel: snapshot moments {list(ma)} / "
                             f"{list(mb)}")
    leaf, grad = _worst_leaf(mb, ma)
    top = sorted(((_rel(mb[k], ma[k]), k.split("/")[1]) for k in ma),
                 reverse=True)[:3]
    if grad > PARALLEL_GRAD_RTOL or not all(
            params_within(b[k], a[k], PARALLEL_PARAM_TOL)
            for k in keys) or not all(
            torch.isfinite(v).all() for v in b.values()):
        raise AssertionError(f"parallel: train_supervised over {n} ranks "
                             f"off the one-card run: parameters by {worst}, "
                             f"gradient leaf {leaf} rel {grad}")
    log(f"parallel: train_supervised --data-parallel over {n} ranks, 1 "
        f"step of 128: gradients worst leaves rel "
        f"{[(leaf, f'{r:.3e}') for r, leaf in top]} (tol "
        f"{PARALLEL_GRAD_RTOL:.0e}), parameters within {worst:.3e} of one "
        f"card's (tol {PARALLEL_PARAM_TOL:.0e}); wall with start-up "
        f"{ {k: round(v, 1) for k, v in walls.items()} } s")
    return {"grad_rel": grad, "param": worst, "wall_s": walls}


def video_frames(path: str) -> int:
    """The frame count of a video's container header (cv2)."""
    from cut_detection_tpu_torch.data.frames import cv2

    cap = cv2.VideoCapture(path)
    try:
        return int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    finally:
        cap.release()


def parallel_split_videos(workdir, devices) -> dict:
    """(f) ``segment_videos``' split of the videos over ``devices``
    (``segment_per_device``, which ``--data-parallel`` runs over several
    cards: a process a device, each its round-robin share) against the
    CLI on one card: the same CSV bytes; wall with start-up both ways,
    and the split's frames/s over its slowest process's time from loading
    the net (its interpreter's start-up excluded).
    Over distinct cards two copies a card of a seeded
    ``CLIP_FRAMES``-frame 1280x720 clip; over one card listed twice the
    golden clips (a check of the split: the processes' start-up is most
    of its wall)."""
    import shutil

    from cut_detection_tpu_torch.cli import segment_videos

    base = tempfile.mkdtemp(prefix="split_videos_", dir=workdir)
    if len(set(devices)) > 1:
        clip = os.path.join(base, "clip.mp4")
        write_game_clip(clip)
        sources = [clip] * (2 * len(devices))
    else:
        sources = [os.path.join(GOLDEN, c)
                   for c in ("clip.mp4", "clip_odd.mp4")]
    flags = ["--transfer", "bgr", "--data-parallel"]
    tags = ("one card", f"{len(devices)} processes")
    walls, csvs = {}, {}
    for k, tag in enumerate(tags):
        d = os.path.join(base, str(k))
        os.makedirs(d)
        paths = [shutil.copy(src, os.path.join(d, f"v{i}.mp4"))
                 for i, src in enumerate(sources)]
        t0 = time.perf_counter()
        if k == 0:
            outs = segment_videos.main(paths + flags[:2])
        else:
            ns = segment_videos.build_parser().parse_args(paths + flags)
            outs, busy = segment_videos.segment_per_device(ns, paths,
                                                           devices)
        walls[tag] = time.perf_counter() - t0
        csvs[tag] = []
        for out in outs:
            with open(out, "rb") as f:
                csvs[tag].append(f.read())
    if csvs[tags[0]] != csvs[tags[1]]:
        raise AssertionError("parallel: the videos split over "
                             f"{[str(d) for d in devices]} wrote other CSVs "
                             "than one card")
    frames = sum(video_frames(p) for p in sources)
    fps = {tag: round(frames / w, 1) for tag, w in walls.items()}
    fps[tags[1] + " after start-up"] = round(frames / busy, 1)
    log(f"parallel: segment_videos' split over "
        f"{[str(d) for d in devices]}, {len(sources)} videos of {frames} "
        f"frames in all: the one-card CSVs byte for byte; wall with "
        f"start-up {({t: round(w, 2) for t, w in walls.items()})} s, "
        f"{fps} frames/s")
    return {"wall_s": walls, "busy_s": busy, "fps": fps}


def phase_parallel(dev, frames, workdir):
    """Several cards and several processes: (a) the sharded classify
    loop, (g) the tensor-parallel step, (b) the 2-rank training steps, (c)
    ``segment_videos --multi-host``, (f) ``segment_videos``' split of the
    videos a process a card (one card twice where there is one), and
    (d), with two or more cards, every kernel route launched on
    ``cuda:1`` while ``cuda:0`` is current and (e) the training CLI's
    ``--data-parallel`` over every card."""
    import concurrent.futures

    n = torch.cuda.device_count()
    cards = [torch.device("cuda", i) for i in range(n)]
    out = {"cards": n, "classify": parallel_classify(cards, frames, workdir),
           "tensor": parallel_tensor(cards, frames, workdir)}
    # (b) and (c) wait mostly on their processes' start-up: side by side.
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        train = pool.submit(parallel_train, dev, workdir)
        multi_host = pool.submit(parallel_multi_host, workdir)
        out["train"] = train.result()
        multi_host.result()
    out["split"] = parallel_split_videos(workdir,
                                         cards if n >= 2 else cards * 2)
    if n >= 2:
        with torch.cuda.device(0):
            out["off_device"] = off_device_kernels(cards[1])
            if torch.cuda.current_device() != 0:
                raise AssertionError("a kernel launch left cuda:1 current")
        log(f"parallel: every kernel route on cuda:1 with cuda:0 current, "
            f"max_abs_err against the plain versions {out['off_device']}")
        out["train_cli"] = parallel_train_cli(workdir, n)
    else:
        log("parallel: one card: the launches on a card other than the "
            "current one (d) and the training CLI over several cards (e) "
            "not run")
    return out


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
    *((f"conv1_stages[{stage}]", "profile", "cut_detection_tpu_torch/csrc/"
       "conv_block.cu", "scripts/profile_fused_conv1.py:40")
      for stage in ("cast", "taps", "dotn", "dott", "tpose", "full")),
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
        prof_rows, paths["profile"] = timed("profile", phase_profile, dev)
        kres.update(prof_rows)
        timed("golden", phase_golden, wd)
        paths["serve"] = timed("serve", phase_serve, dev, wd)
        timed("device_glue", phase_device_glue, dev)
        timed("train", phase_train, dev, card, wd)
        timed("tools", phase_tools, dev, card, wd)
        timed("scripts", phase_scripts, dev, card, wd)
        tp = timed("parallel", phase_parallel, dev, frames,
                   wd)["tensor"]["launches"]
    rows = []
    for name, path, source, replaces in KERNEL_ROWS:
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "replaces_kind": "xla"
                     if name in XLA_ROWS else "pallas",
                     "launches": paths[path][name], **kres[name]})
        if tp.get(path, {}).get(name):
            # The tensor-parallel path's launches (parallel (g), model 2
            # over one card, 2 data rows): a batch of the slice stream
            # launches each layer's kernel 4 times.
            rows[-1]["tensor_parallel_launches"] = tp[path][name]
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
