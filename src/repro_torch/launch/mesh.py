"""Mesh construction over ``{axis: size}`` dicts.

Counterpart of ``repro/launch/mesh.py``.  This package's meshes are plain
``{axis: size}`` dicts at the spec level (``repro_torch/parallel/sharding.py``):
such a mesh holds no device, and on one device nothing is placed.
``make_host_mesh`` checks that the devices it names exist, as the JAX function
does: the processes of the ``torch.distributed`` group when one is up (one
process a device), else the CUDA devices, or one on the CPU.
``device_mesh`` places a dict mesh on the group: a ``DeviceMesh`` whose named
dimensions give each axis's process group, row-major over the ranks, as a JAX
mesh lays out its devices.

Meshes:
  * single-pod:  (data=16, model=16)            -- 256 devices
  * multi-pod:   (pod=2, data=16, model=16)     -- 512 devices

The "model" axis carries TP/EP/SP; "data" (x "pod") carries DP/ZeRO.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import torch
import torch.distributed as dist

from repro_torch.compat import resolve_device
from repro_torch.parallel.dist import is_distributed

__all__ = ["device_mesh", "make_production_mesh", "make_host_mesh", "mesh_num_chips"]


def make_production_mesh(*, multi_pod: bool = False) -> Dict[str, int]:
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def make_host_mesh(
    data: int = 2, model: int = 2, pod: Optional[int] = None, device: Union[str, torch.device] = "cuda"
) -> Dict[str, int]:
    """Small mesh over the devices at hand (tests / examples): the group's
    processes when a ``torch.distributed`` group is up, else the CUDA devices,
    or one on the CPU.  Raises if the mesh needs more."""
    if is_distributed():
        n = dist.get_world_size()
    else:
        n = torch.cuda.device_count() if resolve_device(device).type == "cuda" else 1
    want = data * model * (pod or 1)
    if n < want:
        raise ValueError(f"need {want} devices, have {n}")
    if pod:
        return {"pod": pod, "data": data, "model": model}
    return {"data": data, "model": model}


def mesh_num_chips(mesh: Dict[str, int]) -> int:
    n = 1
    for v in mesh.values():
        n *= v
    return n


def device_mesh(mesh: Mapping[str, int], device: Union[str, torch.device] = "cuda"):
    """The ``DeviceMesh`` of ``mesh`` over the running process group (one
    process a device of ``device``'s type), its dimensions named by the axes.
    The mesh must span the group."""
    from torch.distributed.device_mesh import init_device_mesh

    if not is_distributed():
        raise RuntimeError("device_mesh places a mesh on a process group: call "
                           "repro_torch.parallel.dist.init_distributed first")  # fmt: skip
    if mesh_num_chips(mesh) != dist.get_world_size():
        raise ValueError(f"mesh {dict(mesh)} has {mesh_num_chips(mesh)} places, the group "
                         f"{dist.get_world_size()} processes")  # fmt: skip
    return init_device_mesh(resolve_device(device).type, tuple(mesh.values()), mesh_dim_names=tuple(mesh))
