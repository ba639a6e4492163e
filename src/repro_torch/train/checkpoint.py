"""Checkpointing with atomic commit, in the JAX package's on-disk format.

Counterpart of ``repro/train/checkpoint.py``.  The format is that module's,
so that either package reads the other's checkpoints:

  * ``<dir>/step_%09d/`` is committed by one atomic ``os.replace`` from
    ``<dir>/step_%09d.tmp_<hex>/`` -- a crash mid-save never corrupts the
    newest committed step, which is what a restart resumes from;
  * ``host_0.npz`` holds each leaf under ``<path joined by "/">@@<slot>``;
  * ``index.json`` holds ``step`` and ``arrays: {key: {shape, dtype,
    shards}}``, the keys in the order of the tree's leaves (dict keys sorted
    at every level, as ``jax.tree_util`` walks them);
  * bfloat16 (and float8) leaves are stored as their unsigned integer bits
    under the dtype's name (``"bfloat16"``).  Numpy has no bfloat16 of its
    own and torch's uint16 support is partial, so the bits go through int16
    on both sides: ``t.view(torch.int16)`` to save, ``view(np.int16)`` then
    ``view(torch.bfloat16)`` to restore.

A tensor is saved as the JAX function saves a ``jax.Array`` on one device:
one shard, slot 0, whose index spans the whole shape.  A numpy array or a
Python number is saved as there too, with the index ``null``.

In a ``torch.distributed`` group (one process a device) a save takes the
tree's ``shardings`` (``repro_torch.parallel.sharding.NamedSharding`` trees
over a ``DeviceMesh``, the leaves being each process's block): rank 0
gathers every rank's block of a leaf and writes one slot a rank, in rank
order, with the block's index -- what a sharded JAX run writes from its
``addressable_shards`` on one host, duplicates of a replicated leaf
included.  Rank 0 alone writes and commits; the others wait for the commit.
``restore_checkpoint`` reassembles each array whole from its slots (so any
topology's checkpoint restores) and, given ``NamedSharding`` trees as
``shardings``, keeps only this process's block; spec trees (one device)
place nothing, and every leaf goes to one ``device``.

``CheckpointManager.save`` snapshots the tree into host memory with a real
copy of every tensor before it returns, then writes on a background thread.
A copy is needed where the reference's ``np.asarray`` of an immutable
``jax.Array`` is one anyway: ``adamw_update`` updates the master and the
moments in place, and ``Tensor.numpy()`` of a CPU tensor is a view, so a
write racing the next step would tear.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.compat import resolve_device
from repro_torch.parallel.dist import is_distributed
from repro_torch.parallel.sharding import NamedSharding, mesh_coords

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "CheckpointManager"]

_SEP = "/"

# numpy's format cannot store these: kept as their bits, which pass between
# numpy and torch as a signed (or byte) integer type both have
_EXOTIC = {
    "bfloat16": (torch.bfloat16, torch.int16, np.int16),
    "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, torch.uint8, np.uint8),
}
_EXOTIC_NAMES = {torch_type: name for name, (torch_type, _, _) in _EXOTIC.items()}


def _encode(leaf: Any) -> Tuple[np.ndarray, str]:
    """A leaf as the array ``host_0.npz`` stores and its dtype name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        name = _EXOTIC_NAMES.get(t.dtype)
        if name is not None:
            # stored as unsigned bits, as the reference stores them
            arr = t.view(_EXOTIC[name][1]).cpu().numpy()
            return arr.view(f"u{arr.dtype.itemsize}"), name
        arr = t.cpu().numpy()
        return arr, arr.dtype.name
    arr = np.asarray(leaf)
    return arr, arr.dtype.name


def _decode(arr: np.ndarray, name: str) -> torch.Tensor:
    """A stored array (the bits of an exotic type) as a CPU tensor of type ``name``."""
    if name in _EXOTIC:
        torch_type, _, np_bits = _EXOTIC[name]
        return torch.from_numpy(arr.view(np_bits)).view(torch_type)
    return torch.from_numpy(arr.astype(np.dtype(name), copy=False))


def _flatten_with_paths(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """``{path: leaf}`` in ``jax.tree_util`` order: dict keys sorted, joined by ``/``."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for key in sorted(tree):
        out.update(_flatten_with_paths(tree[key], f"{prefix}{_SEP}{key}" if prefix else str(key)))
    return out


def _unflatten_like(target: Any, leaves: Dict[str, Any], prefix: str = "") -> Any:
    if not isinstance(target, dict):
        return leaves[prefix]
    return {key: _unflatten_like(value, leaves, f"{prefix}{_SEP}{key}" if prefix else str(key))
            for key, value in target.items()}  # fmt: skip


class _Shards:
    """A leaf gathered from a process group: its whole shape and every rank's
    block in host memory, in rank order, each with its index ``[[start, stop], ...]``."""

    def __init__(self, shape, pieces):
        self.shape, self.pieces = tuple(shape), pieces


def _rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def _gather_leaf(leaf: Any, sharding: Any) -> Optional[_Shards]:
    """Every rank's block of ``leaf`` placed by ``sharding``, on rank 0 (None
    elsewhere): a ``dist.gather`` of the blocks, then a copy to host memory."""
    x = leaf.detach().contiguous()
    blocks = [torch.empty_like(x) for _ in range(dist.get_world_size())] if _rank() == 0 else None
    dist.gather(x, blocks, dst=0)
    if blocks is None:
        return None
    shape = sharding.global_shape(x.shape)
    pieces = []
    for r, block in enumerate(blocks):
        index = sharding.index(shape, mesh_coords(sharding.mesh, r))
        pieces.append(([[sl.start, sl.stop] for sl in index], block.to("cpu", copy=True)))
    del blocks
    return _Shards(shape, pieces)


def _snapshot(tree: Any, shardings: Optional[Any]) -> Optional[Dict[str, Any]]:
    """``{path: leaf}`` of ``tree`` in host memory, a copy of every tensor.  In
    a process group: on rank 0 only (None elsewhere), each leaf placed by a
    ``NamedSharding`` of ``shardings`` gathered from every rank (collective:
    every rank calls this in the same order)."""
    flat_sh = _flatten_with_paths(shardings) if shardings is not None else {}
    writer = _rank() == 0
    out: Dict[str, Any] = {}
    for key, leaf in _flatten_with_paths(tree).items():
        sharding = flat_sh.get(key)
        if is_distributed() and isinstance(sharding, NamedSharding) and isinstance(leaf, torch.Tensor):
            out[key] = _gather_leaf(leaf, sharding)
        elif writer:
            out[key] = _host_copy(leaf)
    return out if writer else None


def _write(directory: str, step: int, flat: Dict[str, Any]) -> Path:
    """Write a snapshot and commit it atomically.  Returns the committed directory."""
    base = Path(directory)
    base.mkdir(parents=True, exist_ok=True)
    tmp = base / f"step_{step:09d}.tmp_{uuid.uuid4().hex[:8]}"
    final = base / f"step_{step:09d}"
    tmp.mkdir()

    index: Dict[str, Any] = {"step": step, "arrays": {}}
    payload: Dict[str, np.ndarray] = {}
    for key, leaf in flat.items():
        if isinstance(leaf, _Shards):
            slots = []
            for slot, (shard_index, block) in enumerate(leaf.pieces):
                payload[f"{key}@@{slot}"], dname = _encode(block)
                slots.append({"slot": slot, "index": shard_index})
            index["arrays"][key] = {"shape": list(leaf.shape), "dtype": dname, "shards": slots}
            continue
        enc, dname = _encode(leaf)
        payload[f"{key}@@0"] = enc
        shape = list(enc.shape)
        # a tensor is one shard spanning the array, as a jax.Array on one device
        shard_index = [[0, d] for d in shape] if isinstance(leaf, torch.Tensor) else None
        index["arrays"][key] = {"shape": shape, "dtype": dname, "shards": [{"slot": 0, "index": shard_index}]}
    np.savez(tmp / "host_0.npz", **payload)
    (tmp / "index.json").write_text(json.dumps(index))
    os.replace(tmp, final)  # atomic commit
    return final


def save_checkpoint(directory: str, step: int, tree: Any, shardings: Optional[Any] = None) -> Path:
    """Atomic save.  Returns the committed directory.  In a process group
    every rank calls it (see the module note): rank 0 writes, and every rank
    returns once the step is committed."""
    flat = _snapshot(tree, shardings)
    final = Path(directory) / f"step_{step:09d}"
    if flat is not None:
        final = _write(directory, step, flat)
    if is_distributed():
        dist.barrier()
    return final


def latest_step(directory: str) -> Optional[int]:
    """The newest committed step in ``directory`` (step 0 is one), or None."""
    base = Path(directory)
    if not base.exists():
        return None
    steps = [
        int(p.name.split("_")[1])
        for p in base.iterdir()
        if p.name.startswith("step_") and ".tmp_" not in p.name
    ]
    return max(steps) if steps else None


def restore_checkpoint(
    directory: str,
    step: int,
    target: Any,
    shardings: Optional[Any] = None,
    device: Union[str, torch.device] = "cuda",
) -> Any:
    """Restore into the structure of ``target`` (tensors, ``meta`` ones
    included: only its structure is read), every leaf on ``device``.

    The data is reassembled whole from its shards, so a checkpoint written
    by a sharded JAX run restores here too.  A leaf whose ``shardings`` entry
    is a ``NamedSharding`` keeps only this process's block of it; spec trees
    (one device) are accepted and applied to nothing.
    """
    device = resolve_device(device)
    base = Path(directory) / f"step_{step:09d}"
    index = json.loads((base / "index.json").read_text())
    flat_sh = _flatten_with_paths(shardings) if shardings is not None else {}

    restored: Dict[str, torch.Tensor] = {}
    with np.load(base / "host_0.npz") as data:
        for key, meta in index["arrays"].items():
            shape = tuple(meta["shape"])
            name = meta["dtype"]
            pieces = [(sh["index"], data[f"{key}@@{sh['slot']}"]) for sh in meta["shards"]]
            if len(pieces) == 1 and pieces[0][1].size == int(np.prod(shape)):
                full = pieces[0][1].reshape(shape)  # one shard holds it all: no copy
            else:
                full = np.zeros(shape, pieces[0][1].dtype)
                for idx, piece in pieces:
                    full[tuple(slice(a, b) for a, b in idx)] = piece
            sharding = flat_sh.get(key)
            if isinstance(sharding, NamedSharding) and shape:
                full = np.ascontiguousarray(full[sharding.index(shape)])
            restored[key] = _decode(full, name).to(device)
            del full, pieces
    return _unflatten_like(target, restored)


class CheckpointManager:
    """Keep-last-k manager with optional async disk writes.

    ``snapshot_s`` and ``write_s`` hold the last save's times (host clock):
    the copy into host memory, and the write to disk on the background thread.
    """

    def __init__(self, directory: str, keep: int = 3, async_write: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_write = async_write
        self.snapshot_s: Optional[float] = None
        self.write_s: Optional[float] = None
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def save(self, step: int, tree: Any, shardings: Optional[Any] = None) -> None:
        """Snapshot ``tree`` now (in a process group: every rank, gathering
        the blocks of each leaf ``shardings`` places onto rank 0) and write it
        on a background thread (rank 0)."""
        # snapshot to host memory synchronously, a copy of every tensor: the
        # next step updates the optimizer state in place
        t0 = time.perf_counter()
        flat = _snapshot(tree, shardings)
        self.snapshot_s = time.perf_counter() - t0
        self._join()
        self._raise()
        if flat is None:  # not the writing rank
            return

        def work():
            t0 = time.perf_counter()
            try:
                _write(self.directory, step, flat)
                self._gc()
            except Exception as err:  # raised again by wait()
                self._error = err
            self.write_s = time.perf_counter() - t0

        if self.async_write:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
            self._raise()

    def wait(self) -> None:
        """Wait for the write in flight; raise what it raised.  In a process
        group every rank calls it and returns once rank 0's write is committed."""
        self._join()
        if is_distributed():
            dist.barrier()
        self._raise()

    def _join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _raise(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        base = Path(self.directory)
        steps = sorted(
            p for p in base.iterdir()
            if p.name.startswith("step_") and ".tmp_" not in p.name
        )
        for p in steps[: -self.keep]:
            for f in p.iterdir():
                f.unlink()
            p.rmdir()


def _host_copy(leaf: Any) -> Any:
    """A leaf in host memory: a copy, never a view of it."""
    if isinstance(leaf, torch.Tensor):
        # synchronous from the card (no non_blocking): the copy is whole on return
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)
