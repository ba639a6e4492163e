"""The axis shim of the chip-level barriers: stacked parties, or one party a process.

Counterpart of the collectives that ``repro``'s chip barriers call inside
``shard_map`` (``repro/compat.py`` ``axis_size``, ``jax.lax.axis_index``,
``psum``, ``ppermute``).  What ``axis`` is picks the backend:

  * a ``str`` -- the ``n`` parties of the named axis are the rows of the
    leading axis of one tensor on one device: a party's local value of
    shape ``s`` is row ``i`` of an ``(n, *s)`` tensor, and every function
    takes and returns such stacked tensors.  On one device the name is only
    checked to be a string;
  * a :class:`MeshAxis` -- a named dimension of a ``torch.distributed``
    ``DeviceMesh``: each process is one party and holds its local value, as
    a function under ``shard_map`` does.  ``psum`` is an ``all_reduce`` over
    the axis's process group, ``axis_index`` / ``axis_size`` come from that
    group, and ``ppermute`` is one ``batch_isend_irecv`` (group ranks mapped
    to global ranks; a pair ``(i, i)`` is a local copy, since a process does
    not send to itself).

So a chip barrier written against this shim reads as the reference's does,
in either form.  ``jax.lax.optimization_barrier`` has no eager counterpart
and is dropped: it only kept XLA from fusing or reordering the rounds, and
eager PyTorch runs every round in program order anyway.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Sequence, Tuple, Union

import torch
import torch.distributed as dist

__all__ = ["MeshAxis", "axis_index", "axis_size", "is_stacked", "ppermute", "psum"]


@dataclasses.dataclass(frozen=True)
class MeshAxis:
    """The dimension ``name`` of a ``DeviceMesh``, bound as a party axis:
    one party a process, each holding its own local value."""

    mesh: Any
    name: str

    @property
    def group(self):
        return self.mesh.get_group(self.name)

    @property
    def size(self) -> int:
        return self.mesh.size(self.mesh.mesh_dim_names.index(self.name))

    @property
    def index(self) -> int:
        """This process's coordinate on the axis."""
        return self.mesh.get_local_rank(self.name)


Axis = Union[str, MeshAxis]


def is_stacked(axis: Axis) -> bool:
    """Whether ``axis`` names stacked parties (a ``str``) rather than a process axis."""
    if isinstance(axis, MeshAxis):
        return False
    if isinstance(axis, str):
        return True
    raise TypeError(f"axis must name the party axis or be a MeshAxis, got {axis!r}")


def _check(x: torch.Tensor, axis: Axis) -> bool:
    stacked = is_stacked(axis)
    if stacked and x.dim() < 1:
        raise ValueError("a stacked party tensor has the parties on a leading axis")
    return stacked


def axis_size(x: torch.Tensor, axis: Axis) -> int:
    """Number of parties: the length of the leading axis, or the size of the process axis."""
    return x.shape[0] if _check(x, axis) else axis.size


def axis_index(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Each party's index: stacked, ``arange(n)`` shaped ``(n, 1, ..., 1)`` to
    broadcast with ``x``; on a process axis, this process's, a 0-d tensor."""
    if _check(x, axis):
        return torch.arange(x.shape[0], device=x.device).reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.tensor(axis.index, device=x.device)


def psum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Every party gets the sum over all parties."""
    if _check(x, axis):
        return x.sum(0, keepdim=True).expand_as(x).clone()
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=axis.group)
    return out


def ppermute(x: torch.Tensor, axis: Axis, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``jax.lax.ppermute``: for each ``(src, dst)`` pair party ``dst`` receives
    party ``src``'s value; a party that no pair sends to receives zeros."""
    pairs = tuple((int(s), int(d)) for s, d in perm)
    if _check(x, axis):
        src, dst = _routes(pairs, x.shape[0], x.device)
        return torch.zeros_like(x).index_copy_(0, dst, x.index_select(0, src))
    _check_perm(pairs, axis.size)
    me, group = axis.index, axis.group
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    for s, d in pairs:
        if s == me and d == me:
            out.copy_(x)
        elif s == me:
            ops.append(dist.P2POp(dist.isend, x, dist.get_global_rank(group, d)))
        elif d == me:
            ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(group, s)))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


def _check_perm(perm: Tuple[Tuple[int, int], ...], n: int) -> None:
    src = [s for s, _ in perm]
    dst = [d for _, d in perm]
    if len(set(src)) != len(src) or len(set(dst)) != len(dst):
        raise ValueError(f"ppermute: a party sends or receives twice in {list(perm)}")
    if not all(0 <= i < n for i in src + dst):
        raise ValueError(f"ppermute: {list(perm)} names a party outside 0..{n - 1}")


@functools.lru_cache(maxsize=512)
def _routes(perm: Tuple[Tuple[int, int], ...], n: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The senders and receivers of ``perm`` as index tensors on ``device``,
    made once: a chip barrier's rounds reuse a handful of permutations."""
    _check_perm(perm, n)
    return (torch.tensor([s for s, _ in perm], dtype=torch.long, device=device),
            torch.tensor([d for _, d in perm], dtype=torch.long, device=device))  # fmt: skip
