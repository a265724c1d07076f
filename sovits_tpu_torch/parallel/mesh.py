"""Process groups, the device mesh and batch sharding (counterpart of
``sovits_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a ``Mesh`` with a "data" axis
(the batch is sharded over it, gradients are summed) and a "model" axis
(FSDP-style parameter sharding, ``sharding.py``). Here the same mesh is a
``torch.distributed`` ``DeviceMesh`` with dims ("data", "model") over the
default process group: one process per card, started by ``torchrun``
(NCCL on the cards, gloo on the CPU).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard


def launched_by_torchrun() -> bool:
    """True in a process that ``torchrun`` started (its environment is set)."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"))


def local_device(device_type: str = "cuda") -> torch.device:
    """This process's device: ``cuda:LOCAL_RANK`` (0 outside torchrun) on
    the cards, else the CPU."""
    if device_type == "cpu":
        return torch.device("cpu")
    return torch.device(device_type, int(os.environ.get("LOCAL_RANK", 0)))


def init_process_group(device_type: str = "cuda", init_method: str | None = None,
                       rank: int | None = None, world_size: int | None = None) -> bool:
    """Initialise the default process group once: from ``torchrun``'s
    environment, or from an explicit ``init_method`` (``file://...`` or
    ``tcp://...``) with ``rank`` and ``world_size``. NCCL for the cards,
    gloo for the CPU. With neither, no group is made and False is returned:
    the world is this one process."""
    if dist.is_initialized():
        return True
    if init_method is None and not launched_by_torchrun():
        return False
    backend = "nccl" if device_type == "cuda" else "gloo"
    if device_type == "cuda":
        torch.cuda.set_device(local_device(device_type))
    kw = {} if init_method is None else dict(init_method=init_method, rank=rank,
                                             world_size=world_size)
    dist.init_process_group(backend, **kw)
    return True


def launch_mesh(device: str) -> tuple[torch.device, DeviceMesh | None]:
    """A CLI's device and mesh: under ``torchrun`` the data-parallel mesh
    over every rank and this rank's device (``cuda:LOCAL_RANK`` for a
    "cuda" device), else ``device`` itself and no mesh."""
    device_type = torch.device(device).type
    if not launched_by_torchrun():
        return torch.device(device), None
    return local_device(device_type), make_mesh(device_type=device_type)


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def make_mesh(n_data: int | None = None, n_model: int = 1, device_type: str = "cuda",
              init_method: str | None = None, rank: int | None = None,
              world_size: int | None = None) -> DeviceMesh | None:
    """A ("data", "model") mesh over the default process group, initialised
    as :func:`init_process_group` does. ``n_data`` defaults to the world
    size over ``n_model``. Returns None when there is no process group
    (one process and no ``init_method``): the JAX ``make_mesh()`` on one
    device, on which every helper below is the identity."""
    if not init_process_group(device_type, init_method, rank, world_size):
        if (n_data or 1) * n_model != 1:
            raise ValueError(f"a ({n_data}, {n_model}) mesh needs a process group")
        return None
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh ({n_data}, {n_model}) does not cover the world of {world} ranks")
    return init_device_mesh(device_type, (n_data, n_model), mesh_dim_names=("data", "model"))


def data_size(mesh: DeviceMesh | None) -> int:
    return 1 if mesh is None else mesh["data"].size()


def data_rank(mesh: DeviceMesh | None) -> int:
    return 0 if mesh is None else mesh["data"].get_local_rank()


def data_sharding(mesh: DeviceMesh | None = None) -> tuple:
    """The batch's placement: sharded over "data", replicated over "model"."""
    return (Shard(0), Replicate())


def replicated(mesh: DeviceMesh | None = None) -> tuple:
    return (Replicate(), Replicate())


def shard_batch(batch: dict, mesh: DeviceMesh | None) -> dict:
    """This rank's rows of a global batch (``P("data")``): the rows of its
    "data" coordinate, the same for every rank along "model"."""
    n = data_size(mesh)
    if n == 1:
        return batch
    r = data_rank(mesh)
    out = {}
    for k, v in batch.items():
        if len(v) % n:
            raise ValueError(f"batch entry {k!r} of {len(v)} rows does not split over {n} ranks")
        rows = len(v) // n
        out[k] = v[r * rows : (r + 1) * rows]
    return out


def replicate_tree(module: torch.nn.Module, mesh: DeviceMesh | None) -> torch.nn.Module:
    """Broadcast ``module``'s parameters and buffers from rank 0, in place."""
    if mesh is None or mesh.size() == 1:
        return module
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)
    return module

