"""The axis shim of the chip-level barriers: parties stacked on a leading axis.

Counterpart of the collectives that ``repro``'s chip barriers call inside
``shard_map`` (``repro/compat.py`` ``axis_size``, ``jax.lax.axis_index``,
``psum``, ``ppermute``).  Here the ``n`` parties of the named axis are the
rows of the leading axis of one tensor on one device: a party's local value
of shape ``s`` is row ``i`` of an ``(n, *s)`` tensor.  Every function takes
and returns such stacked tensors, so a chip barrier written against this
shim reads as the reference's does.

``axis`` names the party axis, as the reference's collectives name theirs;
on one device it is always the leading one, and the name is only checked to
be a string.  A backend over ``torch.distributed`` (one party a process)
would read it; there is none yet.

``jax.lax.optimization_barrier`` has no eager counterpart and is dropped: it
only kept XLA from fusing or reordering the rounds, and eager PyTorch runs
every round in program order anyway.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch

__all__ = ["axis_index", "axis_size", "ppermute", "psum"]


def _check(x: torch.Tensor, axis: str) -> None:
    if not isinstance(axis, str):
        raise TypeError(f"axis must name the party axis, got {axis!r}")
    if x.dim() < 1:
        raise ValueError("a stacked party tensor has the parties on a leading axis")


def axis_size(x: torch.Tensor, axis: str) -> int:
    """Number of parties: the length of the leading axis."""
    _check(x, axis)
    return x.shape[0]


def axis_index(x: torch.Tensor, axis: str) -> torch.Tensor:
    """Each party's index, ``arange(n)`` shaped ``(n, 1, ..., 1)`` to broadcast with ``x``."""
    _check(x, axis)
    return torch.arange(x.shape[0], device=x.device).reshape((-1,) + (1,) * (x.dim() - 1))


def psum(x: torch.Tensor, axis: str) -> torch.Tensor:
    """Every party gets the sum over all parties."""
    _check(x, axis)
    return x.sum(0, keepdim=True).expand_as(x).clone()


def ppermute(x: torch.Tensor, axis: str, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``jax.lax.ppermute``: for each ``(src, dst)`` pair party ``dst`` receives
    party ``src``'s value; a party that no pair sends to receives zeros."""
    _check(x, axis)
    src, dst = _routes(tuple((int(s), int(d)) for s, d in perm), x.shape[0], x.device)
    return torch.zeros_like(x).index_copy_(0, dst, x.index_select(0, src))


@functools.lru_cache(maxsize=512)
def _routes(perm: Tuple[Tuple[int, int], ...], n: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The senders and receivers of ``perm`` as index tensors on ``device``,
    made once: a chip barrier's rounds reuse a handful of permutations."""
    src = [s for s, _ in perm]
    dst = [d for _, d in perm]
    if len(set(src)) != len(src) or len(set(dst)) != len(dst):
        raise ValueError(f"ppermute: a party sends or receives twice in {list(perm)}")
    if not all(0 <= i < n for i in src + dst):
        raise ValueError(f"ppermute: {list(perm)} names a party outside 0..{n - 1}")
    return (torch.tensor(src, dtype=torch.long, device=device),
            torch.tensor(dst, dtype=torch.long, device=device))  # fmt: skip
