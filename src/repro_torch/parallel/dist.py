"""Process groups under the mesh axes: one process a device, ``torch.distributed``.

The JAX package runs one program over a ``Mesh`` of devices and lets XLA
place the collectives.  The port runs one process a device, joined in a
``torch.distributed`` group, with a ``DeviceMesh`` whose named dimensions give
the process group of each mesh axis (``repro_torch.launch.mesh.device_mesh``).
This module joins the group and holds the collectives over one or more mesh
axes that the sharding, the sync policies and the train step share:

  * ``init_distributed``: the backend follows the device -- NCCL for a card
    (and a run that cannot get NCCL raises: there is no quiet ``gloo`` on a
    card), ``gloo`` for the CPU -- always with a finite timeout.  An ``env://``
    run (``torchrun``) and a ``file://`` run (the tests) both work.  Only a
    caller that names ``backend=`` gets another: ``chip_smoke.py`` runs two
    processes on one card in a ``gloo`` group, because NCCL refuses two ranks
    on one device;
  * ``all_reduce``, ``all_gather``, ``reduce_scatter`` over a tuple of mesh
    axes: a tuple such as ``("pod", "data")`` counts major to minor, as a
    ``PartitionSpec`` entry does, so a collective over it is the collectives
    over each axis in turn.  A collective over an axis of one process still
    runs (a copy), so that a one-card run goes through the same calls;
  * the forward over ``model`` uses ``all_reduce`` and nothing else: it
    gathers blocks by an ``all_reduce`` into a zeroed buffer in which each
    process has written its own block (``sharding.Shards.gather``).
    ``all_reduce`` and ``broadcast`` are the only collectives ``gloo`` runs
    on CUDA tensors, so the same path runs under NCCL on cards and under
    ``gloo`` on one card.
"""

from __future__ import annotations

import datetime
import math
import os
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.compat import resolve_device

__all__ = [
    "DEFAULT_TIMEOUT_S",
    "Pending",
    "all_gather",
    "all_reduce",
    "axis_group",
    "init_distributed",
    "is_distributed",
    "join_if_launched",
    "reduce_scatter",
]

DEFAULT_TIMEOUT_S = 120.0


def is_distributed() -> bool:
    """Whether this process is in a ``torch.distributed`` group."""
    return dist.is_available() and dist.is_initialized()


def init_distributed(
    device: Union[str, torch.device] = "cuda",
    rank: Optional[int] = None,
    world: Optional[int] = None,
    init_method: Optional[str] = None,
    timeout: float = DEFAULT_TIMEOUT_S,
    backend: Optional[str] = None,
) -> torch.device:
    """Join the process group and return this process's device.

    ``init_method`` defaults to ``env://``, where ``torchrun`` has set the
    rank, the world size and the rendezvous; ``rank`` and ``world`` are then
    read from there unless given.  A card takes NCCL, bound to the card
    (``device_id``; ``cuda`` without an index is ``cuda:$LOCAL_RANK``), and
    the CPU takes ``gloo``.  ``timeout`` (seconds) must be finite: a peer that
    died leaves the others waiting that long and no longer.

    ``backend`` overrides that choice, and nothing here ever picks it: it is
    for a caller that knows why, such as two processes sharing one card in a
    ``gloo`` group over CUDA tensors (NCCL refuses two ranks on one device),
    where only ``all_reduce`` and ``broadcast`` run.
    """
    if not (0 < timeout < math.inf):
        raise ValueError(f"the process group needs a finite timeout, got {timeout!r} s")
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        dev = resolve_device(dev)
        if backend is None and not dist.is_nccl_available():
            raise RuntimeError("this torch has no NCCL: a process group on a card runs on NCCL, and the port "
                               "takes no gloo in its place")  # fmt: skip
        torch.cuda.set_device(dev)
        backend = backend or "nccl"
    elif dev.type == "cpu":
        backend = backend or "gloo"
    else:
        raise ValueError(f"no process-group backend for a {dev.type} device")
    kwargs = dict(backend=backend, init_method=init_method or "env://", timeout=datetime.timedelta(seconds=timeout))
    if rank is not None:
        kwargs["rank"] = rank
    if world is not None:
        kwargs["world_size"] = world
    if backend == "nccl":
        kwargs["device_id"] = dev
    dist.init_process_group(**kwargs)
    return dev


def join_if_launched(device: Union[str, torch.device] = "cuda") -> Tuple[torch.device, bool]:
    """(this process's device, whether a group was joined here): a process
    that ``torchrun`` started (``WORLD_SIZE`` is set) joins its group through
    ``env://`` unless one is up already; any other resolves ``device``."""
    if "WORLD_SIZE" in os.environ and not is_distributed():
        return init_distributed(device), True
    return resolve_device(device), False


def _axes(axes: Union[str, Sequence[str]]) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_group(mesh, axis: str):
    """The process group of this process's row along ``axis`` of a ``DeviceMesh``."""
    return mesh.get_group(axis)


class Pending:
    """A collective in flight: ``wait()`` returns its result once it has landed."""

    def __init__(self, works: list, finish):
        self._works, self._finish = works, finish

    def wait(self) -> torch.Tensor:
        for work in self._works:
            work.wait()
        return self._finish()


def _done(result: torch.Tensor) -> Pending:
    return Pending([], lambda: result)


def all_reduce(x: torch.Tensor, mesh, axes, op=dist.ReduceOp.SUM, async_op: bool = False):
    """``x`` reduced over the processes of ``axes``, in place; returns ``x``
    (with ``async_op``, a :class:`Pending` of it, in flight over one axis)."""
    axes = _axes(axes)
    if async_op and len(axes) == 1:
        return Pending([dist.all_reduce(x, op=op, group=axis_group(mesh, axes[0]), async_op=True)], lambda: x)
    for axis in axes:
        dist.all_reduce(x, op=op, group=axis_group(mesh, axis))
    return _done(x) if async_op else x


def _gather_into(out: torch.Tensor, x: torch.Tensor, group) -> None:
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, x, group=group)


def _size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def all_gather(x: torch.Tensor, dim: int, mesh, axes) -> torch.Tensor:
    """The blocks of ``axes``'s processes joined along ``dim`` in axis order,
    a new tensor: the minor axis first, then each one above it."""
    out = x.movedim(dim, 0).contiguous()
    for axis in reversed(_axes(axes)):
        joined = out.new_empty((_size(mesh, axis) * out.shape[0],) + tuple(out.shape[1:]))
        _gather_into(joined, out, axis_group(mesh, axis))
        out = joined
    return out.movedim(0, dim).contiguous()


def reduce_scatter(x: torch.Tensor, dim: int, mesh, axes, async_op: bool = False):
    """``x`` summed over ``axes``'s processes, each keeping its block along
    ``dim`` (major axis first), a new tensor (with ``async_op``, a
    :class:`Pending` of it, in flight over one axis)."""
    fn = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    out = x.movedim(dim, 0).contiguous()
    works = []
    for axis in _axes(axes):
        n = _size(mesh, axis)
        if out.shape[0] % n:
            raise ValueError(f"reduce_scatter: {out.shape[0]} rows do not split over the {n} processes of {axis!r}")
        block = out.new_empty((out.shape[0] // n,) + tuple(out.shape[1:]))
        one_in_flight = async_op and len(_axes(axes)) == 1
        works.append(fn(block, out, group=axis_group(mesh, axis), async_op=one_in_flight))
        out = block
    pending = Pending([w for w in works if w is not None], lambda: out.movedim(0, dim).contiguous())
    return pending if async_op else pending.wait()

