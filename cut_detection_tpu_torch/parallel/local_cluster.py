"""A multi-process group on one machine (counterpart of
``cut_detection_tpu/parallel/local_cluster.py``).

N processes join one ``torch.distributed`` group over localhost and run
what a multi-host job runs, each checking what it can see:

1. a collective on data that differs per rank, whose sum is right only
   if bytes crossed between the processes;
2. the data-parallel supervised step (``train.supervised``, global BN and
   summed gradients) on this rank's rows of a seeded batch;
3. the data-parallel contrastive step (``train.contrastive``);
4. a data-parallel ``train_supervised`` run whose train split leaves a
   tail batch (dropped) and whose validation tail does not divide over
   the ranks (computed whole on every rank, counted once);
5. ``partition_inputs``'s round-robin share of a work list.

With ``--out DIR`` each rank saves its results as ``DIR/rank{r}.npz``:
the steps' losses, parameters, BN statistics and all-reduced gradients,
which the tests hold against the single-process step and the JAX
package's sharded one.  On the CPU the group runs over gloo; with
``--device cuda`` each rank takes its own card over NCCL, or, with fewer
cards than ranks, shares card 0 over gloo (NCCL needs a card a rank).

    python -m cut_detection_tpu_torch.parallel.local_cluster --spawn 2

or one worker per terminal:

    python -m cut_detection_tpu_torch.parallel.local_cluster \\
        --process-id 0 --num-processes 2 --coordinator localhost:9911
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import torch

# Model widths and frame sizes of the two cases: "tiny" for the CPU
# tests, "prod" the bundled classifier's (TrainConfig's defaults) and the
# contrastive defaults at 360x640, as the training CLIs run them.
WIDTHS = {
    "tiny": dict(sup=dict(conv_layers=2, conv_hidden_channels=8,
                          avg_pool_size=2, linear_layers=2, linear_size=8,
                          output_size=3, batch_size=16), sup_hw=(27, 48),
                 con=dict(conv_layers=2, conv_hidden_channels=8,
                          linear_layers=2, linear_size=8, output_size=4,
                          batch_size=8), con_hw=(48, 80)),
    "prod": dict(sup={}, sup_hw=(144, 256), con={}, con_hw=(360, 640)),
}


@dataclasses.dataclass
class ArrayDataset:
    """A ``SupervisedFrameDataset``-like over arrays in memory."""

    x: np.ndarray
    y: np.ndarray

    def __getitem__(self, idx):
        return {"x": self.x[idx], "y": np.int64(self.y[idx])}

    def __len__(self):
        return len(self.x)


def supervised_case(widths: str = "tiny"):
    """``(cfg, x_u8, y)``: the seeded global batch of the supervised step."""
    from cut_detection_tpu_torch.config import TrainConfig

    w = WIDTHS[widths]
    cfg = TrainConfig(**w["sup"], epochs=1)
    rng = np.random.default_rng(2)
    x = rng.integers(0, 255, size=(cfg.batch_size, *w["sup_hw"], 3),
                     dtype=np.uint8)
    return cfg, x, rng.integers(0, 3, size=(cfg.batch_size,)).astype(np.int64)


def contrastive_case(widths: str = "tiny"):
    """``(cfg, x_u8)``: the seeded global batch of the contrastive step."""
    from cut_detection_tpu_torch.config import ContrastiveConfig

    w = WIDTHS[widths]
    cfg = ContrastiveConfig(**w["con"], epochs=1)
    rng = np.random.default_rng(3)
    return cfg, rng.integers(0, 256, size=(cfg.batch_size, *w["con_hw"], 3),
                             dtype=np.uint8)


def tail_case():
    """``(cfg, datasets)`` of the tail-batch run: 44 frames, 33 to train
    in batches of 8 (a tail of 1), 11 to validate (a tail of 3), two
    epochs of SGD (whose steps keep two runs' rounding apart as it is,
    where Adam's first steps amplify it)."""
    from cut_detection_tpu_torch.config import TrainConfig

    cfg = TrainConfig(**{**WIDTHS["tiny"]["sup"], "batch_size": 8},
                      epochs=2, learning_rate=3e-3, optimizer="sgd")
    rng = np.random.default_rng(60)
    x = rng.integers(0, 256, (44, 36, 64, 3), dtype=np.uint8)
    y = rng.integers(0, 3, 44).astype(np.int64)
    return cfg, [ArrayDataset(x[:30], y[:30]), ArrayDataset(x[30:], y[30:])]


def supervised_step(cfg, x, y, device, group=None):
    """One step from ``Generator().manual_seed(0)``'s weights on this
    rank's rows of ``(x, y)``; returns ``(state, metrics)``."""
    from cut_detection_tpu_torch.train import supervised

    state = supervised.init_train_state(torch.Generator().manual_seed(0),
                                        cfg, device)
    rows = supervised.rank_rows(len(x), group)
    return supervised.make_train_step(cfg, group)(state, x[rows], y[rows])


def contrastive_step(cfg, x, device, group=None):
    """One contrastive step from ``Generator().manual_seed(0)``'s weights,
    the views drawn from ``Generator().manual_seed(7)``, on this rank's
    rows of ``x``; returns ``(state, metrics)``."""
    from cut_detection_tpu_torch.train import contrastive, supervised

    state = contrastive.init_contrastive_state(
        torch.Generator().manual_seed(0), cfg, device)
    rows = supervised.rank_rows(len(x), group)
    step = contrastive.make_contrastive_step(cfg, group)
    return step(state, torch.Generator().manual_seed(7), x[rows])


def tail_run(device, group=None, state=None) -> dict:
    """``train_supervised`` on ``tail_case`` (from ``state``, or
    ``Generator().manual_seed(0)``'s weights)."""
    from cut_detection_tpu_torch.train import supervised

    cfg, datasets = tail_case()
    if state is None:
        state = supervised.init_train_state(
            torch.Generator().manual_seed(0), cfg, device)
    return supervised.train_supervised(cfg, datasets, num_workers=0,
                                       state=state, group=group)


def state_arrays(prefix: str, state) -> dict:
    """A state's parameters and BN statistics as ``{prefix/name: array}``."""
    return {f"{prefix}/{k}": v.detach().cpu().numpy()
            for k, v in state.net.state_dict().items()}


def grad_arrays(prefix: str, state) -> dict:
    """The gradients of a state's last step (all-reduced under a group:
    the optimizer leaves them in place) as ``{prefix_grad/name: array}``."""
    return {f"{prefix}_grad/{k}": p.grad.detach().cpu().numpy()
            for k, p in state.net.named_parameters()}


def run_worker(process_id: int, num_processes: int, coordinator: str, *,
               device: str = "cpu", widths: str = "tiny",
               out: str | None = None) -> None:
    """One rank; raises on any failure of the group's correctness."""
    import torch.distributed as dist

    from cut_detection_tpu_torch.parallel.distributed import (
        initialize,
        local_devices,
        partition_inputs,
    )

    if device == "cpu":
        backend = "gloo"
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // num_processes))
    else:
        from cut_detection_tpu_torch.utils.device import strict_fp32

        strict_fp32()
        backend = ("nccl" if torch.cuda.device_count() >= num_processes
                   else "gloo")
    pid = initialize(coordinator, num_processes, process_id, backend=backend)
    try:
        if pid != process_id or dist.get_world_size() != num_processes:
            raise RuntimeError(f"rank {pid} of {dist.get_world_size()}")
        dev = torch.device("cpu") if device == "cpu" else local_devices()[0]
        group = dist.group.WORLD
        res = {}

        # 1. Per-rank data: the sum is right only if bytes crossed.
        t = torch.full((8,), float(pid + 1), device=dev)
        dist.all_reduce(t)
        want = 8.0 * sum(p + 1 for p in range(num_processes))
        res["collective"] = float(t.sum())
        if res["collective"] != want:
            raise RuntimeError(f"all_reduce gave {res['collective']}, "
                               f"expected {want}")

        # 2., 3. The data-parallel steps.
        cfg, x, y = supervised_case(widths)
        state, m = supervised_step(cfg, x, y, dev, group)
        res.update(**state_arrays("sup", state), **grad_arrays("sup", state),
                   sup_loss=float(m["loss"]),
                   sup_correct=int(m["correct"]), sup_n=m["n"])
        cfg, x = contrastive_case(widths)
        state, m = contrastive_step(cfg, x, dev, group)
        res.update(**state_arrays("con", state), **grad_arrays("con", state),
                   con_loss=float(m["loss"]),
                   con_acc=float(m["align_acc"]))
        if not (np.isfinite(res["sup_loss"]) and np.isfinite(res["con_loss"])):
            raise RuntimeError(f"non-finite loss: {res}")

        # 4. The loop, with its tails (tiny widths at every size).
        result = tail_run(dev, group)
        res.update(state_arrays("tail", result["state"]),
                   tail_history=json.dumps(result["history"]),
                   tail_steps=result["state"].step)

        # 5. This process's share of a work list.
        videos = [f"game_{i}.mp4" for i in range(2 * num_processes + 1)]
        mine = partition_inputs(videos)
        if mine != videos[process_id::num_processes]:
            raise RuntimeError(f"partition_inputs gave {mine}")
        if out:
            np.savez(os.path.join(out, f"rank{pid}.npz"), **res)
        print(f"WORKER-OK pid={pid} backend={backend} device={dev} "
              f"sup_loss={res['sup_loss']:.6f} con_loss="
              f"{res['con_loss']:.6f} videos={mine}", flush=True)
    finally:
        dist.destroy_process_group()


def spawn_cluster(num_processes: int, *, device: str = "cpu",
                  widths: str = "tiny", out: str | None = None,
                  timeout: float = 600.0) -> list[str]:
    """Start ``num_processes`` workers over localhost and return their
    outputs; raises ``RuntimeError`` if any fails.  None is left running
    on return or on raise."""
    from cut_detection_tpu_torch.parallel.distributed import free_port

    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=repo_root)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
              "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    cmd = [sys.executable, "-m", "cut_detection_tpu_torch.parallel."
           "local_cluster", "--num-processes", str(num_processes),
           "--coordinator", f"localhost:{free_port()}", "--device", device,
           "--widths", widths] + (["--out", out] if out else [])
    procs = [subprocess.Popen(cmd + ["--process-id", str(p)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env,
                              cwd=repo_root)
             for p in range(num_processes)]
    outs, failed = [], []
    try:
        for p, proc in enumerate(procs):
            try:
                text, _ = proc.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                proc.kill()
                text, _ = proc.communicate()
                failed.append((p, "timeout", text))
                continue
            outs.append(text)
            if proc.returncode != 0 or "WORKER-OK" not in text:
                failed.append((p, proc.returncode, text))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        detail = "\n".join(f"worker {p} rc={rc}:\n{text[-3000:]}"
                           for p, rc, text in failed)
        raise RuntimeError(f"local cluster failed:\n{detail}")
    return outs


def main(args=None) -> None:
    ap = argparse.ArgumentParser(
        "A multi-process torch.distributed group on this machine.")
    ap.add_argument("--spawn", type=int, default=None, metavar="N",
                    help="Start an N-process group and run every worker.")
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--coordinator", type=str, default="localhost:9911")
    ap.add_argument("--device", choices=["cpu", "cuda"], default="cpu")
    ap.add_argument("--widths", choices=list(WIDTHS), default="tiny")
    ap.add_argument("--out", type=str, default=None,
                    help="Save each rank's results as OUT/rank{r}.npz.")
    ns = ap.parse_args(args)
    if ns.spawn is not None:
        for text in spawn_cluster(ns.spawn, device=ns.device,
                                  widths=ns.widths, out=ns.out):
            print(text, end="")
        return
    if ns.process_id is None:
        ap.error("--process-id is required when not using --spawn")
    run_worker(ns.process_id, ns.num_processes, ns.coordinator,
               device=ns.device, widths=ns.widths, out=ns.out)


if __name__ == "__main__":
    main()
