"""Device meshes over ``torch.distributed``.

Functions, not module-level constants: importing this module touches no
process group, so the tests and the single-device paths never see one.

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` whose
dimensions carry the JAX package's axis names: ``data`` carries DP/FSDP
(and sequence sharding for long-context decode), ``model`` carries TP/EP,
``pod`` is cross-pod DP.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _device_type(device_type: str | None) -> str:
    """``None`` -> ``cuda``; asking for CUDA where there is none raises."""
    device_type = device_type or "cuda"
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh needs a CUDA device and NCCL; pass "
                           "device_type='cpu' for a gloo mesh")
    return device_type


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device_type: str | None = None) -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` over the current process group:
    NCCL on the card (the default), gloo where the caller says ``cpu``.

    A one-device mesh starts its own one-rank process group when none is
    running; a larger one needs the group already started (``torchrun``, or
    ``init_process_group`` with its address, world size and rank).
    """
    device_type = _device_type(device_type)
    if not dist.is_initialized():
        if math.prod(shape) != 1:
            raise RuntimeError(f"a {shape} mesh needs a process group of "
                               f"{math.prod(shape)} ranks; none is running")
        backend = "nccl" if device_type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    if device_type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None) -> DeviceMesh:
    """16×16 = 256 ranks single pod; (2, 16, 16) = 512 ranks across 2
    pods, over the current process group."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def data_axes(mesh: DeviceMesh) -> tuple[str, ...]:
    """Mesh axes that carry the batch dimension."""
    names = mesh.mesh_dim_names
    return tuple(a for a in ("pod", "data") if a in names)


def model_axis(mesh: DeviceMesh) -> str:
    return "model"


def mesh_devices(mesh: DeviceMesh) -> int:
    return mesh.size()
