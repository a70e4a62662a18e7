"""Device meshes (counterpart of ``cut_detection_tpu/parallel/mesh.py``).

A mesh here is a grid of devices with a ``data`` and a ``model`` axis,
listed in JAX's order: data row ``i``, model column ``j`` is
``devices[i * model + j]``, as ``np.asarray(devices).reshape(data,
model)`` lays them out.  The data-parallel steps split every frame batch
over the data rows, each row's share on its first column's device with
a replica of the net (``data_devices``, ``parallel.sharding``); the
tensor-parallel step (``make_sharded_classify_step(...,
tensor_parallel=True)``) also splits each layer's output channels over a
row's model columns.  The same device may appear more than once
(``[cpu] * 8`` in the CPU tests, as JAX's 8 virtual CPU devices;
``[cuda:0] * 4`` on a one-card machine), each entry with weights of its
own.
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
    """``devices``, the grid in row-major (data, model) order, with
    ``model`` columns a row; ``shape`` names the axes' sizes as the JAX
    mesh does (``mesh.shape["data"]``).  Hashable: the pipeline memoizes
    its steps per mesh."""

    devices: tuple[torch.device, ...]
    model: int = 1

    @property
    def shape(self) -> dict[str, int]:
        return {"data": len(self.devices) // self.model, "model": self.model}

    @property
    def data_devices(self) -> tuple[torch.device, ...]:
        """Each data row's first device, where the sharded steps take the
        row's share of a batch (frames shard over ``data`` alone, as JAX's
        ``P("data")``) and the data-parallel step keeps the row's replica
        (its columns would hold the same one)."""
        return self.devices[::self.model]


def make_mesh(devices=None, *, model_parallel: int = 1) -> Mesh:
    """A (data, model) mesh over ``devices`` (default: every visible CUDA
    device), ``model_parallel`` columns a data row; raises where that
    does not divide the device count."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass "
                               "the devices (e.g. [torch.device('cpu')] * 8)")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("make_mesh needs at least one device")
    _, model = mesh_shape_for(len(devices), model_parallel)
    return Mesh(devices, model)
