"""The classify runner: the full-game device loop,
``pipeline.classify_batches``, fed from a pool of frames in host memory.

Set-up makes the pool and the served weights from the seed, builds the
program's net at the mix's rung and warms the loop on three batches (the
step, its rings and its buffers are memoized per net, so the window
builds nothing).  The window then hands ``(batch, valid)`` pairs to one
``classify_batches`` call, in order, cycling through the pool, until
``--seconds`` have passed; it ends when the call returns, after its one
fetch of the scores.  No harness thread runs meanwhile.

Every frame scored in the window is then compared with the reference's
logits of its pool frame (``checks.classify_gaps``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from cutbench.harness import checks, trace
from cutbench.harness import traffic as gen
from cutbench.harness import weights
from cutbench.reference import model as ref

# The reference's code levels at each quantized rung, and the control's:
# the next precision below the rung (uint8 -> int4).
LEVELS = {"uint8_chain": 255}
CONTROL_LEVELS = {"uint8_chain": 15}
WARM_BATCHES = 3


def build(config: dict, traffic: dict, seed: int, device):
    """The seeded pool (host) and served weights (device)."""
    frames, _ = gen.frame_pool(traffic, seed, device)
    state = weights.make_state(config["model"], gen.sub_seed(seed, 0), device,
                               served=True)
    first = torch.from_numpy(frames[0]).to(device)
    with ref.tf32(False):
        weights.calibrate(state, config["model"], ref.bgr_u8_to_input(first))
    return frames, state


def program_net(config: dict, traffic: dict, state: dict, device):
    """The program's net at the mix's rung, holding ``state``."""
    from cut_detection_tpu_torch.config import ModelParams
    from cut_detection_tpu_torch.models.assembly import GluedNet

    m = config["model"]
    params = ModelParams(conv_layers=m["conv_layers"],
                         conv_channels=m["conv_channels"],
                         avg_pool_size=m["avg_pool_size"],
                         linear_layers=m["linear_layers"],
                         linear_size=m["linear_size"],
                         linear_output_size=m["linear_output_size"])
    net = GluedNet(params, traffic["precision"]).to(device)
    load_state(net, state)
    return net


def load_state(net, state: dict) -> None:
    """Load the benchmark's state dict; only the BN step counters, which
    the program keeps for itself, may be missing."""
    result = net.load_state_dict(state, strict=False)
    missing = [k for k in result.missing_keys
               if not k.endswith("num_batches_tracked")]
    if missing or result.unexpected_keys:
        raise KeyError(f"state dict mismatch: missing {missing}, "
                       f"unexpected {result.unexpected_keys}")


def _batches(frames: np.ndarray, deadline: float, handoffs: list, tracer):
    """``(batch, valid)`` pairs from the pool, in order, cycling, until
    ``deadline`` (host clock); each hand-off's time goes to ``handoffs``
    and to the tracer."""
    n, batch = frames.shape[0], frames.shape[1]
    i = 0
    while True:
        now = time.perf_counter()
        if now >= deadline:
            return
        handoffs.append(now)
        tracer.tick(now)
        yield frames[i % n], batch
        i += 1


def reference_logits(config: dict, state: dict, frames: np.ndarray, device,
                     levels) -> torch.Tensor:
    """The reference's logits of every pool frame, a batch at a time, TF32
    off: the rung's numerics at ``levels`` code levels, or float32 where
    ``levels`` is None.  [pool frames, classes] on ``device``."""
    model = config["model"]
    with torch.no_grad(), ref.tf32(False):
        out = []
        for b in frames:
            x = torch.from_numpy(b).to(device)
            out.append(ref.forward_eval(state, model, ref.bgr_u8_to_input(x))
                       if levels is None else
                       ref.forward_chain(state, model, x, levels))
        return torch.cat(out)


def window_gaps(conf, pred, ref_all: torch.Tensor) -> dict:
    """Window frame ``k`` is pool frame ``k mod pool size``."""
    conf = torch.as_tensor(conf).to(ref_all.device)
    pred = torch.as_tensor(pred).to(ref_all.device)
    idx = torch.arange(conf.shape[0], device=ref_all.device) % ref_all.shape[0]
    return checks.classify_gaps(conf, pred, ref_all[idx])


def run_window(net, frames, traffic: dict, seconds: float, traced: bool,
               device, clock):
    """Warm the loop, then the timed window; returns the scores and the
    window's counts."""
    from cut_detection_tpu_torch.pipeline import classify_batches

    batch = traffic["batch"]
    warm = [(frames[i % frames.shape[0]], batch) for i in range(WARM_BATCHES)]
    classify_batches(iter(warm), net, batch_size=batch,
                     length=WARM_BATCHES * batch, print_every=0)
    tracer = trace.Tracer(traced, device, seconds)
    clock.mark("loop warmed up")
    handoffs: list = []
    t0 = time.perf_counter()
    clock.setup_done()
    tracer.begin(t0)
    conf, pred, stats = classify_batches(
        _batches(frames, t0 + seconds, handoffs, tracer), net,
        batch_size=batch, length=traffic["length"], print_every=0)
    t1 = time.perf_counter()
    tracer.finish()
    clock.mark("window closed" + (", trace reduced" if traced else ""))
    return conf, pred, {
        "window_s": t1 - t0, "items": int(stats.frames),
        "batches": int(stats.batches), "attempted": len(handoffs) * batch,
        "ticks": handoffs, "trace": tracer.summary}


def drive(run) -> dict:
    config, traffic = run.config, run.traffic
    frames, state = build(config, traffic, run.seed, run.device)
    run.clock.mark("frames and weights made")
    net = program_net(config, traffic, state, run.device)
    run.clock.mark("the program's net built")
    conf, pred, out = run_window(net, frames, traffic, run.seconds,
                                 run.trace, run.device, run.clock)
    out["memory_peak_bytes"] = run.memory_peak()
    del net
    ref_all = reference_logits(config, state, frames, run.device,
                               LEVELS.get(traffic["precision"]))
    out["gaps"] = window_gaps(conf, pred, ref_all)
    out["failed"] = out["attempted"] - len(conf)
    return out


def control_gaps(config: dict, traffic: dict, frames, state, device) -> dict:
    """The control: the reference at the next precision below the rung, in
    the program's place, over every pool frame."""
    low = reference_logits(config, state, frames, device,
                           CONTROL_LEVELS[traffic["precision"]])
    best = reference_logits(config, state, frames, device,
                            LEVELS.get(traffic["precision"]))
    conf, pred = low.max(dim=1)
    return checks.classify_gaps(conf, pred, best)
