"""Mesh construction over ``{axis: size}`` dicts.

Counterpart of ``repro/launch/mesh.py``.  This package's meshes are plain
``{axis: size}`` dicts everywhere (``repro_torch/train/step.py``): the spec
functions read the axis sizes, and one device applies no placement.  So a
mesh here holds no device; ``make_host_mesh`` only checks that the devices
it names exist, as the JAX function does.

Meshes:
  * single-pod:  (data=16, model=16)            -- 256 devices
  * multi-pod:   (pod=2, data=16, model=16)     -- 512 devices

The "model" axis carries TP/EP/SP; "data" (x "pod") carries DP/ZeRO.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from repro_torch.compat import resolve_device

__all__ = ["make_production_mesh", "make_host_mesh", "mesh_num_chips"]


def make_production_mesh(*, multi_pod: bool = False) -> Dict[str, int]:
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def make_host_mesh(
    data: int = 2, model: int = 2, pod: Optional[int] = None, device: Union[str, torch.device] = "cuda"
) -> Dict[str, int]:
    """Small mesh over the devices at hand (tests / examples): the CUDA
    devices, or one on the CPU.  Raises if the mesh needs more."""
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
