"""Processes that work together (counterpart of
``cut_detection_tpu/parallel/distributed.py``).

The JAX package wires its hosts into one runtime with
``jax.distributed.initialize`` and relies on global-batch semantics in its
sharded programs.  The port uses a ``torch.distributed`` process group
with one rank per card: ``initialize`` joins it (from torchrun's
environment, or a TCP rendezvous given explicitly), ``partition_inputs``
gives each process its round-robin share of a work list, and the two
collectives below carry training's global batch: the BN sums
(``ops.nn.batch_norm_train``) and the gradients (``train.supervised``).

The backend is chosen, never switched behind the caller's back: NCCL
where each rank owns a card of its own, gloo on the CPU.  Ranks that
share a card must ask for gloo (``backend="gloo"``), which also reduces
CUDA tensors, through the host.
"""

from __future__ import annotations

import datetime
import logging
import os

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

# torchrun's variables; RANK and WORLD_SIZE say a group is described.
_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
_LOOPBACK = ("localhost", "127.0.0.1", "::1")
TIMEOUT = datetime.timedelta(minutes=10)
# (local rank, local world size) of this process once it joined a group.
_LOCAL = (0, 1)


def env_describes_group() -> bool:
    """True when torchrun's variables describe a group of several ranks."""
    return (all(k in os.environ for k in _ENV)
            and int(os.environ["WORLD_SIZE"]) > 1)


def _local_layout(coordinator: str | None, num_processes: int | None,
                  process_id: int | None) -> tuple[int, int]:
    """(this process's index among the ranks on its host, how many ranks
    its host runs): torchrun's LOCAL_RANK / LOCAL_WORLD_SIZE, else, for an
    explicit rendezvous on a loopback address, every rank is local, else
    one rank a host."""
    if "LOCAL_RANK" in os.environ:
        return (int(os.environ["LOCAL_RANK"]),
                int(os.environ.get("LOCAL_WORLD_SIZE", 1)))
    host = (coordinator or "").split("://")[-1].rsplit(":", 1)[0]
    if host.strip("[]") in _LOOPBACK and num_processes:
        return int(process_id or 0), int(num_processes)
    return 0, 1


def local_devices() -> list[torch.device]:
    """The cards this process owns: with L ranks on the host and D visible
    cards, local rank r takes cards r, r + L, ... (one card each where D =
    L); where there are fewer cards than ranks, ranks share card r mod D.
    On a machine without a card, the CPU."""
    n = torch.cuda.device_count()
    if n == 0:
        return [torch.device("cpu")]
    lr, lws = _LOCAL
    ids = list(range(lr, n, lws)) or [lr % n]
    return [torch.device("cuda", i) for i in ids]


def _backend(backend: str | None, local_world: int) -> str:
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        n = torch.cuda.device_count()
        if n < local_world:
            raise RuntimeError(
                f"NCCL needs a card for each rank, and {local_world} ranks "
                f"on this host share {n} card(s): pass backend='gloo'")
    return backend


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *,
               backend: str | None = None) -> int:
    """Join the process group; return this process's rank.

    With no arguments, the group torchrun's environment describes
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``,
    ``LOCAL_RANK``); without such an environment a single-process no-op
    that returns 0.  With ``coordinator_address`` (``host:port``),
    ``num_processes`` and ``process_id``, a TCP rendezvous there.  Under
    NCCL the process's first owned card becomes its current device.
    Idempotent: a process already in a group gets its rank back.
    """
    global _LOCAL
    if dist.is_initialized():
        return dist.get_rank()
    if coordinator_address is None and num_processes in (None, 1):
        if not env_describes_group():
            return 0
        _LOCAL = _local_layout(None, None, None)
        backend = _backend(backend, _LOCAL[1])
        dist.init_process_group(backend, init_method="env://",
                                timeout=TIMEOUT)
    else:
        if coordinator_address is None or process_id is None:
            raise ValueError("an explicit rendezvous needs "
                             "coordinator_address, num_processes and "
                             "process_id")
        _LOCAL = _local_layout(coordinator_address, num_processes,
                               process_id)
        backend = _backend(backend, _LOCAL[1])
        address = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
        dist.init_process_group(backend, init_method=address,
                                world_size=num_processes, rank=process_id,
                                timeout=TIMEOUT)
    if backend == "nccl":
        torch.cuda.set_device(local_devices()[0])
    logger.info("distributed: rank %d of %d (%s), local rank %d of %d",
                dist.get_rank(), dist.get_world_size(), backend, *_LOCAL)
    return dist.get_rank()


def partition_inputs(items: list, *, process_id: int | None = None,
                     num_processes: int | None = None) -> list:
    """This process's share of a work list (videos, frame dirs, ...):
    round-robin, so long and short videos spread evenly."""
    joined = dist.is_initialized()
    pid = (dist.get_rank() if joined else 0) if process_id is None \
        else process_id
    n = (dist.get_world_size() if joined else 1) if num_processes is None \
        else num_processes
    return [it for i, it in enumerate(items) if i % n == pid]


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The SUM of ``t`` over ``group``'s ranks, differentiable
    (``torch.distributed.nn``'s all-reduce): the gradient of each rank's
    copy is the sum of the ranks' gradients."""
    import warnings

    from torch.distributed.nn.functional import all_reduce

    with warnings.catch_warnings():
        # Newer PyTorch deprecates it for functional collectives, which
        # have no backward.
        warnings.simplefilter("ignore", FutureWarning)
        return all_reduce(t, op=dist.ReduceOp.SUM, group=group)


class _GatherRows(torch.autograd.Function):
    """All-gather along the leading axis; the backward all-reduces the
    whole gradient and keeps this rank's rows, so it needs only an
    all-reduce, which every backend runs on CPU and CUDA tensors alike
    (``torch.distributed.nn``'s all-gather goes through an all-to-all
    under gloo)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group, ctx.n = group, t.shape[0]
        ctx.rank = dist.get_rank(group)
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(
            group))]
        dist.all_gather(parts, t.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad[ctx.rank * ctx.n:(ctx.rank + 1) * ctx.n], None


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` (the same shape on every rank) concatenated
    along the leading axis in rank order, differentiable: each rank's
    rows get the sum over the ranks of their gradients."""
    return _GatherRows.apply(t, group)


@torch.no_grad()
def all_reduce_grads(params, group) -> None:
    """SUM-all-reduce the gradients of ``params`` in place, as one flat
    buffer (one collective)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()


def free_port() -> int:
    """A free TCP port on localhost for a rendezvous."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawned(rank: int, nprocs: int, address: str, backend, fn, args):
    initialize(address, nprocs, rank, backend=backend)
    try:
        fn(*args, local_devices()[0], dist.group.WORLD)
    finally:
        dist.destroy_process_group()


def spawn(fn, nprocs: int, *args, backend: str | None = None) -> None:
    """``fn(*args, device, group)`` in ``nprocs`` new processes of this
    host (``torch.multiprocessing.spawn``), one rank each of a group that
    meets at a free localhost port, each on its own card
    (``local_devices``); raises when a rank fails.  ``fn`` and ``args``
    are pickled: ``fn`` must be a module-level function."""
    import torch.multiprocessing as mp

    mp.spawn(_spawned, nprocs=nprocs, join=True,
             args=(nprocs, f"localhost:{free_port()}", backend, fn, args))


def run_ranks(fn, *args, cpu: bool = False) -> bool:
    """``fn(*args, device, group)`` once per rank where ``--data-parallel``
    has several: in the group torchrun's environment describes (this
    process is one rank), or else over every visible card, a process
    each (``spawn``).  Returns False, having run nothing, where there is
    one device (or ``cpu``): the caller then runs unsharded."""
    if cpu:
        return False
    if env_describes_group():
        initialize()
        try:
            fn(*args, local_devices()[0], dist.group.WORLD)
        finally:
            dist.destroy_process_group()
        return True
    n = torch.cuda.device_count()
    if n > 1:
        spawn(fn, n, *args)
        return True
    return False
