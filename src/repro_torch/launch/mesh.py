"""Meshes over the process group (port of ``repro.launch.mesh``).

Single pod  : (data=16, model=16)            = 256 ranks
Multi-pod   : (pod=2, data=16, model=16)     = 512 ranks
Host mesh   : (data=world // model, model)   = whatever the world is

Ranks are processes. ``init_process_group`` reads the rendezvous from the
environment: ``RANK`` and ``WORLD_SIZE`` (without them the process is a
world of one), then either
``REPRO_TORCH_STORE`` (a ``FileStore`` path; tests, where several groups
run at once and no fixed port is free) or ``MASTER_ADDR``/``MASTER_PORT``
(what ``torchrun`` sets). The backend is whatever the caller names;
``default_backend`` works it out: NCCL with one rank per card, gloo for
ranks on the CPU or for several ranks sharing one card (NCCL refuses two
ranks on one GPU). Nothing here picks a device on its own.

Gloo carries CUDA tensors by copying them through host memory (inside
torch's gloo backend). With torch 2.11 (cu128) its functional
``all_gather_into_tensor`` (what DTensor's Shard -> Replicate issues)
crashes the process on a CUDA tensor, while the plain
``dist.all_gather_into_tensor`` and every other collective DTensor issues
work; ``init_process_group(..., cuda_gloo=True)`` therefore points the
functional op's CUDA kernel at the plain collective
(``_route_functional_all_gather``). NCCL is untouched: the route is only
installed for gloo ranks on the card.

``make_production_mesh`` is a function, not a module constant, so
importing this module never touches the process group.
"""
from __future__ import annotations

import datetime
import os
import torch
import torch.distributed as dist

STORE_ENV = "REPRO_TORCH_STORE"


def default_backend(device: torch.device) -> str:
    """The backend for this node's ranks on ``device``: gloo on the CPU,
    and on the card when the node's ranks (torchrun's ``LOCAL_WORLD_SIZE``)
    outnumber its cards; NCCL otherwise."""
    if device.type != "cuda":
        return "gloo"
    ranks = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    return "gloo" if ranks > torch.cuda.device_count() else "nccl"


_ROUTED = []


def _route_functional_all_gather() -> None:
    """Serve ``_c10d_functional.all_gather_into_tensor`` on CUDA tensors
    with the plain, blocking ``dist.all_gather_into_tensor`` (the result
    is complete when returned, so the later ``wait_tensor`` finds no work
    pending)."""
    if _ROUTED:
        return
    from torch.distributed.distributed_c10d import _resolve_process_group

    def all_gather_into_tensor(inp, group_size, group_name):
        out = inp.new_empty((group_size * inp.shape[0],) + inp.shape[1:])
        dist.all_gather_into_tensor(out, inp.contiguous(),
                                    group=_resolve_process_group(group_name))
        return out
    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", all_gather_into_tensor, "CUDA")
    _ROUTED.append(lib)   # the override lives as long as the library


def init_process_group(backend: str, *, cuda_gloo: bool = False,
                       timeout_s: float = 600.0) -> None:
    """Join the process group described by the environment (see the module
    docstring); a no-op if this process has joined already. ``cuda_gloo``:
    the ranks are gloo ranks with their tensors on the card."""
    if backend == "gloo" and cuda_gloo:
        _route_functional_all_gather()
    if dist.is_initialized():
        return
    timeout = datetime.timedelta(seconds=timeout_s)
    if "RANK" not in os.environ:     # a process on its own: a world of one
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=timeout)
        return
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    path = os.environ.get(STORE_ENV)
    if path:
        store = dist.FileStore(path, world)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world, timeout=timeout)
    else:
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world, timeout=timeout)


def _device_type(device) -> str:
    return torch.device(device).type


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """(data 16, model 16), or (pod 2, data 16, model 16) with
    ``multi_pod``, over a world of exactly that size."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"the production mesh {shape} needs {n} ranks, "
                         f"the world has {world}")
    return init_device_mesh(_device_type(device), shape,
                            mesh_dim_names=axes)


def make_host_mesh(model: int, device):
    """(data = world // model, model) over every rank of the group, on
    ``device``'s type (the caller's device: nothing here picks one)."""
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    if model < 1 or world % model:
        raise ValueError(f"model axis {model} does not divide the world "
                         f"of {world} ranks")
    return init_device_mesh(_device_type(device), (world // model, model),
                            mesh_dim_names=("data", "model"))


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def destroy() -> None:
    """Leave the process group (after a barrier, so no rank tears down a
    transport another still reads)."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
