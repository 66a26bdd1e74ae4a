"""Production mesh construction (port of ``repro/launch/mesh.py``), as a
``torch.distributed`` device mesh.

Functions, not module-level constants: importing this module touches no
process group and no device. Nothing here creates a process group either:
the caller initialises one (``torch.distributed.init_process_group`` with
its address, world size and rank) before asking for a mesh of its ranks.
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.core.types import MULTI_POD, SINGLE_POD, MeshConfig


def _world_size() -> int:
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return 0
    return dist.get_world_size()


def _device_mesh(mcfg: MeshConfig, device_type: str):
    """The device mesh of ``mcfg`` over the first ``mcfg.n_devices`` ranks
    of the initialised process group."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    n, world = mcfg.n_devices, _world_size()
    if world < n:
        raise RuntimeError(
            f"mesh {mcfg.shape} needs {n} ranks but the process group has "
            f"{world or 'none'}: initialise torch.distributed with a world "
            f"of at least {n} (its address, world size and rank) before "
            "building it")
    if world == n:
        return init_device_mesh(device_type, mcfg.shape,
                                mesh_dim_names=mcfg.axes)
    return DeviceMesh(device_type, torch.arange(n).reshape(mcfg.shape),
                      mesh_dim_names=mcfg.axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The 16 x 16 ("data", "model") mesh, or with ``multi_pod`` the
    2 x 16 x 16 ("pod", "data", "model") one; raises a RuntimeError
    without a process group of 256 (512) ranks."""
    return _device_mesh(mesh_config(multi_pod=multi_pod), device_type)


def mesh_config(*, multi_pod: bool = False) -> MeshConfig:
    return MULTI_POD if multi_pod else SINGLE_POD


def make_smoke_mesh(shape: Sequence[int] = (1, 1),
                    axes: Sequence[str] = ("data", "model"),
                    device_type: str = "cuda"):
    """A small mesh of ``shape`` over the first ranks of the process
    group."""
    return _device_mesh(MeshConfig(tuple(shape), tuple(axes)), device_type)
