"""Readings that the correctness limits are set from, on the card.

    python3 cutbench/tools/readings.py --workload W --seeds 1,2,3 \\
        --seconds 3 [--control-seeds 4,5,6] [--out FILE]

For each seed, in one process: the program's gaps after a short window
at the cell's own load (``program``), and for the control seeds the
control's gaps (``control``): the reference in the program's place at
the next precision below the configuration's (int4 codes for the
``uint8_chain`` rung; TF32 for float32).  Training cells also read the
half-batch fault (``half_batch``: the reference on half of each batch,
its summed loss doubled, in the program's place).  One JSON line per
reading on standard output, and in ``--out`` when given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from cutbench.harness import main as harness  # noqa: E402


def classify_readings(cell, seed, seconds, device, control: bool):
    from cutbench.harness import classify

    frames, state = classify.build(cell.config, cell.traffic, seed, device)
    out = []
    net = classify.program_net(cell.config, cell.traffic, state, device)
    conf, pred, _ = classify.run_window(net, frames, cell.traffic, seconds,
                                        False, device,
                                        harness.Clock(time.time()))
    del net
    ref_all = classify.reference_logits(
        cell.config, state, frames, device,
        classify.LEVELS.get(cell.traffic["precision"]))
    out.append(("program", classify.window_gaps(conf, pred, ref_all)))
    if control:
        out.append(("control", classify.control_gaps(
            cell.config, cell.traffic, frames, state, device)))
    return out


def train_readings(cell, seed, seconds, device, control: bool):
    from cutbench.harness import train
    from cutbench.reference import model as ref

    config, traffic = cell.config, cell.traffic
    frames, labels, state = train.build(config, traffic, seed, device)
    st, call = train.program(config, traffic, state, seed, device)
    compared, _ = train.run_steps(st, call, frames, labels, seconds, False,
                                  device, harness.Clock(time.time()))
    del st, call
    ref_out = train.reference(config, traffic, state, frames, labels, seed,
                              device)
    out = [("program", dict(
        train.gaps(config, state, compared, ref_out),
        loss_gap_steps=[abs(a - b) / abs(b) for a, b in zip(
            compared["losses"], ref_out[0])]))]
    if not control:
        return out
    ref_losses, ref_grads, ref_final = ref_out

    def as_program(losses, grads, final):
        return {"losses": losses, "grads": grads, "after": final}

    low = train.reference(config, traffic, state, frames, labels, seed,
                          device, tf32=True)
    out.append(("control", train.gaps(config, state, as_program(*low),
                                      ref_out)))
    half = traffic["batch"] // 2
    if traffic["entry"] == "train_supervised":
        import torch

        batches = [(ref.rgb_u8_to_input(torch.from_numpy(
            frames[i][:half]).to(device)), torch.from_numpy(
                labels[i][:half]).to(device)) for i in range(
                    train.COMPARED_STEPS)]
        with ref.tf32(False):
            fault = ref.train_steps(state, config["model"], batches,
                                    loss="ce", optim=config["optimizer"],
                                    scale=2.0)
    else:
        import torch

        from cutbench.harness import traffic as gen
        from cutbench.reference import augment

        draws = torch.Generator().manual_seed(gen.sub_seed(
            seed, train.AUGMENT_STREAM))
        batches = []
        for i in range(train.COMPARED_STEPS):
            views = augment.two_views(draws, torch.from_numpy(
                frames[i]).to(device))
            b = traffic["batch"]
            batches.append((torch.cat([views[:half], views[b:b + half]]),
                            None))
        with ref.tf32(False):
            fault = ref.train_steps(
                state, config["model"], batches, loss="ntxent",
                optim=config["optimizer"],
                temperature=config.get("temperature", 1.0))
    out.append(("half_batch", train.gaps(config, state, as_program(*fault),
                                         ref_out)))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    harness.cache_env()
    import torch

    from cut_detection_tpu_torch.utils.device import strict_fp32

    strict_fp32()
    device = torch.device("cuda", 0)
    cell = harness.Cell.named(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    reader = (classify_readings if cell.traffic["entry"] == "classify"
              else train_readings)
    sink = open(args.out, "a") if args.out else None
    try:
        for seed in sorted(set(seeds) | controls):
            t = time.time()
            for kind, gaps in reader(cell, seed, args.seconds, device,
                                     seed in controls):
                line = json.dumps({"workload": args.workload, "seed": seed,
                                   "kind": kind, "gaps": gaps,
                                   "seconds": time.time() - t})
                print(line, flush=True)
                if sink:
                    sink.write(line + "\n")
            torch.cuda.empty_cache()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
