"""Device meshes (counterpart of ``cut_detection_tpu/parallel/mesh.py``).

A mesh here is a list of devices along one ``data`` axis: the inference
step keeps one replica of the net on each and splits every frame batch
over them (``parallel.sharding``).  The same device may appear more than
once (``[cpu] * 8`` in the CPU tests, as JAX's 8 virtual CPU devices;
``[cuda:0, cuda:0]`` on a one-card machine), each entry with a replica
of its own.  Tensor parallelism (a ``model`` axis over which the
channels shard) is not ported: ROADMAP.md Queue 1 lists it.
"""

from __future__ import annotations

import dataclasses

import torch


def mesh_shape_for(n_devices: int,
                   model_parallel: int = 1) -> tuple[int, int]:
    """(data, model) factorization of ``n_devices``."""
    if n_devices % model_parallel != 0:
        raise ValueError(
            f"model_parallel={model_parallel} must divide n_devices={n_devices}"
        )
    return n_devices // model_parallel, model_parallel


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices`` along the data axis; ``shape`` names the axes' sizes as
    the JAX mesh does (``mesh.shape["data"]``).  Hashable: the pipeline
    memoizes its steps per mesh."""

    devices: tuple[torch.device, ...]

    @property
    def shape(self) -> dict[str, int]:
        return {"data": len(self.devices), "model": 1}


def make_mesh(devices=None, *, model_parallel: int = 1) -> Mesh:
    """A data mesh over ``devices`` (default: every visible CUDA device).

    ``model_parallel > 1`` (tensor parallelism) is not ported and raises.
    """
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass "
                               "the devices (e.g. [torch.device('cpu')] * 8)")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("make_mesh needs at least one device")
    data, model = mesh_shape_for(len(devices), model_parallel)
    if model > 1:
        raise NotImplementedError(
            "model_parallel > 1 (tensor parallelism) is not ported; "
            "ROADMAP.md Queue 1 lists it")
    return Mesh(devices)
