"""The training runners: the supervised step (``train.supervised.
make_train_step``) and the SimCLR step (``train.contrastive.
make_contrastive_step``), fed from a pool of frames in host memory as
the loader hands them (one uint8 batch a step).

Set-up builds one training state from the seeded weights and drives it
through the first three steps with the window's own call, on pool
batches 0, 1 and 2; those steps are compared with the reference
(``checks.train_gaps``) and warm every shape.  The same state then steps
on through the window, cycling through the pool, until ``--seconds``
have passed; the window ends with a synchronize.
"""

from __future__ import annotations

import time

import torch

from cutbench.harness import checks, trace
from cutbench.harness import traffic as gen
from cutbench.harness import weights
from cutbench.harness.classify import load_state
from cutbench.reference import augment
from cutbench.reference import model as ref

COMPARED_STEPS = 3
BETA1 = 0.9
AUGMENT_STREAM = 3


def build(config: dict, traffic: dict, seed: int, device):
    frames, labels = gen.frame_pool(traffic, seed, device)
    state = weights.make_state(config["model"], gen.sub_seed(seed, 0), device,
                               served=False)
    return frames, labels, state


def program(config: dict, traffic: dict, state: dict, seed: int, device):
    """``(train state, call)``: ``call(train_state, i)`` runs one step of
    the program on pool batch ``i`` and returns ``(state, metrics)``."""
    from cut_detection_tpu_torch.models.assembly import GluedNet
    from cut_detection_tpu_torch.train.supervised import TrainState

    m, b = config["model"], traffic["batch"]
    if traffic["entry"] == "train_supervised":
        from cut_detection_tpu_torch.config import TrainConfig
        from cut_detection_tpu_torch.train import supervised as mod

        cfg = TrainConfig(conv_layers=m["conv_layers"],
                          conv_hidden_channels=m["conv_channels"],
                          avg_pool_size=m["avg_pool_size"],
                          linear_layers=m["linear_layers"],
                          linear_size=m["linear_size"],
                          output_size=m["linear_output_size"], batch_size=b)
        step = mod.make_train_step(cfg)

        def call(st, frames, labels, i):
            return step(st, frames[i], labels[i])
    else:
        from cut_detection_tpu_torch.config import ContrastiveConfig
        from cut_detection_tpu_torch.train import contrastive as mod

        cfg = ContrastiveConfig(conv_layers=m["conv_layers"],
                                conv_hidden_channels=m["conv_channels"],
                                linear_layers=m["linear_layers"],
                                linear_size=m["linear_size"],
                                output_size=m["linear_output_size"],
                                batch_size=b,
                                temperature=config["temperature"])
        step = mod.make_contrastive_step(cfg)
        views = torch.Generator().manual_seed(gen.sub_seed(seed,
                                                           AUGMENT_STREAM))

        def call(st, frames, labels, i):
            return step(st, views, frames[i])
    params = mod.model_params(cfg)
    for key, value in (("conv_layers", params.conv_layers),
                       ("conv_channels", params.conv_channels),
                       ("avg_pool_size", params.avg_pool_size),
                       ("linear_size", params.linear_size),
                       ("linear_output_size", params.linear_output_size)):
        if m[key] != value:
            raise ValueError(f"{key}: the configuration says {m[key]}, the "
                             f"program's {traffic["entry"]} builds {value}")
    net = GluedNet(params, "float32").to(device)
    load_state(net, state)
    net.train().requires_grad_(True)
    return TrainState(net, mod.make_optimizer(cfg, net.parameters())), call


def first_grads(st) -> dict[str, torch.Tensor]:
    """The first step's gradients as the optimizer got them: its first
    moment after one step is ``(1 - beta1) * grad``; a leaf the optimizer
    holds no moment for got none."""
    names = {id(p): k for k, p in st.net.named_parameters()}
    out = {}
    for group in st.optimizer.param_groups:
        for p in group["params"]:
            moment = st.optimizer.state.get(p, {}).get("exp_avg")
            out[names[id(p)]] = (torch.zeros_like(p) if moment is None else
                                 moment / (1 - BETA1)).detach().clone()
    return out


def run_steps(st, call, frames, labels, seconds: float, traced: bool,
              device, clock):
    """The compared steps, then the window."""
    losses, grads = [], None
    for i in range(COMPARED_STEPS):
        st, metrics = call(st, frames, labels, i)
        losses.append(metrics["loss"])
        if i == 0:
            grads = first_grads(st)
    after = {k: v.detach().clone() for k, v in st.net.state_dict().items()}
    tracer = trace.Tracer(traced, device, seconds)
    clock.mark("compared steps taken")
    compared = {"losses": [float(x) for x in losses], "grads": grads,
                "after": after}
    window_losses, ticks = [], []
    n = frames.shape[0]
    i = COMPARED_STEPS
    t0 = time.perf_counter()
    clock.setup_done()
    tracer.begin(t0)
    deadline = t0 + seconds
    while (now := time.perf_counter()) < deadline:
        ticks.append(now)
        tracer.tick(now)
        st, metrics = call(st, frames, labels, i % n)
        window_losses.append(metrics["loss"])
        i += 1
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    tracer.finish()
    clock.mark("window closed" + (", trace reduced" if traced else ""))
    steps = i - COMPARED_STEPS
    finite = (torch.isfinite(torch.stack(window_losses).float())
              if window_losses else torch.ones(0, dtype=torch.bool))
    return compared, {
        "window_s": t1 - t0, "items": steps * frames.shape[1],
        "steps": steps, "attempted": steps, "ticks": ticks,
        "failed": int((~finite).sum()), "trace": tracer.summary}


def reference(config: dict, traffic: dict, state: dict, frames, labels,
              seed: int, device, tf32: bool = False):
    """The reference's three steps from the same seeded weights, frames
    and augmentation draws; TF32 off (on only for the control)."""
    batches = []
    if traffic["entry"] == "train_supervised":
        for i in range(COMPARED_STEPS):
            batches.append((
                ref.rgb_u8_to_input(torch.from_numpy(frames[i]).to(device)),
                torch.from_numpy(labels[i]).to(device)))
        kind = "ce"
    else:
        draws = torch.Generator().manual_seed(gen.sub_seed(seed,
                                                           AUGMENT_STREAM))
        for i in range(COMPARED_STEPS):
            batches.append((augment.two_views(
                draws, torch.from_numpy(frames[i]).to(device)), None))
        kind = "ntxent"
    with ref.tf32(tf32):
        return ref.train_steps(state, config["model"], batches, loss=kind,
                               optim=config["optimizer"],
                               temperature=config.get("temperature", 1.0))


def gaps(config: dict, state: dict, compared: dict, ref_out) -> dict:
    ref_losses, ref_grads, ref_final = ref_out
    keys = ref.trainable_keys(config["model"]) + ref.stat_keys(config["model"])
    change = {k: compared["after"][k] - state[k] for k in keys}
    ref_change = {k: ref_final[k] - state[k] for k in keys}
    return checks.train_gaps(compared["losses"], ref_losses,
                             compared["grads"], ref_grads, change,
                             ref_change, ref.stat_keys(config["model"]))


def drive(run) -> dict:
    config, traffic = run.config, run.traffic
    frames, labels, state = build(config, traffic, run.seed, run.device)
    run.clock.mark("frames and weights made")
    st, call = program(config, traffic, state, run.seed, run.device)
    run.clock.mark("the program's training state built")
    compared, out = run_steps(st, call, frames, labels, run.seconds,
                              run.trace, run.device, run.clock)
    out["memory_peak_bytes"] = run.memory_peak()
    del st, call
    ref_out = reference(config, traffic, state, frames, labels, run.seed,
                        run.device)
    out["gaps"] = gaps(config, state, compared, ref_out)
    return out
