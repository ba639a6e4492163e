"""Sharding rules: logical parameter roles -> per-axis placements.

Counterpart of the spec functions of ``repro/parallel/sharding.py``:
``dp_axes``, ``model_axis_size``, ``_spec_for``, ``param_specs``,
``zero_spec``, ``batch_spec``, with the same rules.  Without jax there is no
``Mesh`` or ``PartitionSpec``:

  * a mesh is an ordered ``Mapping[str, int]`` of axis sizes, e.g.
    ``{"data": 2, "model": 2}`` (the order of a JAX mesh's ``axis_names``);
  * a spec is a :class:`Spec`, a tuple with one entry a dimension: ``None``
    (replicated), an axis name, or a tuple of axis names, as the entries of
    a ``PartitionSpec``.

Parallelism layout (as in the reference):

  * ``("pod", "data")`` -- data parallelism (+ ZeRO for optimizer state),
  * ``"model"``         -- tensor parallelism: attention heads, MLP hidden,
                           MoE experts (EP), vocab.

Specs are derived from the parameter tree by path+shape rules (the tree is
the one ``repro_torch.models.lm.init_lm`` builds); any axis whose size does
not divide the mesh axis falls back to replication.  Applying the specs
(``param_shardings``, ``tree_size_bytes`` in the reference) needs more than
one device and waits for a ``torch.distributed`` backend.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Mapping, Optional, Tuple

__all__ = [
    "Spec",
    "batch_spec",
    "is_spec",
    "dp_axes",
    "model_axis_size",
    "param_specs",
    "tree_map_with_path",
    "zero_spec",
]

Mesh = Mapping[str, int]


class Spec(tuple):
    """The placement of one array: one entry a dimension, as ``PartitionSpec(*entries)``.

    Entries are kept as ``PartitionSpec`` keeps them: a tuple of one axis name
    is that name, an empty tuple is ``None`` (replicated).
    """

    def __new__(cls, *entries):
        def canonical(e):
            if isinstance(e, tuple) and len(e) <= 1:
                return e[0] if e else None
            return e

        return super().__new__(cls, (canonical(e) for e in entries))

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def is_spec(x: Any) -> bool:
    return isinstance(x, Spec)


# ---------------------------------------------------------------------------
# Nested-dict trees (the port's parameter trees)
# ---------------------------------------------------------------------------


def tree_map_with_path(fn: Callable[..., Any], tree: Any, *rest: Any,
                       is_leaf: Optional[Callable[[Any], bool]] = None,
                       path: Tuple[str, ...] = ()) -> Any:
    """A tree of ``tree``'s structure with ``fn(path, leaf, *rest_leaves)`` at
    every leaf; the ``rest`` trees have the same structure (``jax.tree.map``
    with paths).  ``is_leaf`` stops the descent at a node of ``tree``."""
    if is_leaf is not None and is_leaf(tree):
        return fn(path, tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest), is_leaf=is_leaf, path=path + (str(k),))
                for k, v in tree.items()}  # fmt: skip
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            tree_map_with_path(fn, v, *(r[i] for r in rest), is_leaf=is_leaf, path=path + (f"[{i}]",))
            for i, v in enumerate(tree)
        )
    return fn(path, tree, *rest)


# ---------------------------------------------------------------------------
# The rules
# ---------------------------------------------------------------------------


def dp_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh if a in ("pod", "data"))


def model_axis_size(mesh: Mesh) -> int:
    return mesh.get("model", 1)


def _div(n: int, m: int) -> bool:
    return m > 0 and n % m == 0


# parameter-name -> (shard output dim over model?) rules; see module doc.
_COL_SHARDED = {"wq", "wk", "wv", "gate", "up", "in_z", "in_x", "w_uk", "w_uv"}
_ROW_SHARDED = {"wo", "down", "out_proj"}
_REPLICATED = {"router", "w_dkv", "w_kr", "in_B", "in_C", "in_dt"}
_VOCAB_TABLES = {"embed", "lm_head"}
# head-aligned sharding guards: sharding a head-structured projection over
# "model" is only profitable when the head count divides the axis
_Q_HEAD_PARAMS = {"wq", "wo", "w_uk", "w_uv"}
_KV_HEAD_PARAMS = {"wk", "wv"}


def _replicated(shape: Tuple[int, ...]) -> Spec:
    return Spec(*([None] * len(shape)))


def _spec_for(path: Tuple[str, ...], shape: Tuple[int, ...], model: int, cfg=None) -> Spec:
    """Sharding spec for one parameter, ignoring any stacked layer axis."""
    leaf = path[-1]
    parent = path[-2] if len(path) >= 2 else ""
    if cfg is not None and model > 1:
        role = parent if parent in (_Q_HEAD_PARAMS | _KV_HEAD_PARAMS) else (
            leaf if leaf in (_Q_HEAD_PARAMS | _KV_HEAD_PARAMS) else None
        )
        if role in _Q_HEAD_PARAMS and cfg.n_heads % model != 0:
            return _replicated(shape)
        if role in _KV_HEAD_PARAMS and cfg.n_kv_heads % model != 0:
            return _replicated(shape)

    if parent in _VOCAB_TABLES and leaf == "table":
        return Spec("model", None) if _div(shape[0], model) else Spec(None, None)

    if parent in _REPLICATED or leaf in _REPLICATED:
        return _replicated(shape)

    # MoE expert stacks: (E, d_in, d_out) -> experts over model (EP)
    if parent in ("gate", "up", "down") and len(shape) == 3 or (
        leaf in ("gate", "up", "down") and len(shape) == 3
    ):
        return Spec("model", None, None) if _div(shape[0], model) else Spec(None, None, None)

    if (parent in _COL_SHARDED or leaf in _COL_SHARDED) and len(shape) == 2:
        return Spec(None, "model") if _div(shape[1], model) else Spec(None, None)
    if (parent in _COL_SHARDED) and len(shape) == 1:  # bias of a col-sharded proj
        return Spec("model") if _div(shape[0], model) else Spec(None)

    if (parent in _ROW_SHARDED or leaf in _ROW_SHARDED) and len(shape) == 2:
        return Spec("model", None) if _div(shape[0], model) else Spec(None, None)
    if parent in _ROW_SHARDED and len(shape) == 1:
        return Spec(None)

    if leaf in ("conv_x",):  # (d_conv, d_inner): channel = model axis
        return Spec(None, "model") if _div(shape[1], model) else Spec(None, None)
    if leaf in ("conv_bx", "norm_scale"):
        return Spec("model") if _div(shape[0], model) else Spec(None)
    # everything else (norms, scalars, conv_B/C, A_log, D, dt_bias): replicate
    return _replicated(shape)


def param_specs(params_tree: Any, mesh: Mesh, fsdp: bool = True, cfg=None) -> Any:
    """Spec tree matching ``params_tree`` (any leaves with a ``shape``).

    With ``fsdp=True`` (default) every parameter additionally shards its
    first yet-unsharded, divisible axis over the data axes (weight-sharded
    data parallelism), never the stacked layer axis.
    """
    model = model_axis_size(mesh)

    def one(names: Tuple[str, ...], leaf: Any) -> Spec:
        shape = tuple(leaf.shape)
        if "blocks" in names:  # stacked: leading layer axis
            inner = _spec_for(names, shape[1:], model, cfg)
            if fsdp and len(shape) >= 3:
                inner = zero_spec(inner, shape[1:], mesh)
            return Spec(None, *inner)
        spec = _spec_for(names, shape, model, cfg)
        if fsdp and len(shape) >= 2:
            spec = zero_spec(spec, shape, mesh)
        return spec

    return tree_map_with_path(one, params_tree)


def batch_spec(mesh: Mesh, extra_dims: int = 1) -> Spec:
    """Batch sharded over all data axes; remaining dims replicated."""
    return Spec(dp_axes(mesh), *([None] * extra_dims))


def zero_spec(spec: Spec, shape: Tuple[int, ...], mesh: Mesh) -> Spec:
    """Upgrade a param spec with ZeRO sharding of the optimizer state: shard
    the first yet-unsharded axis divisible by the DP world size over the data
    axes.  Falls back to the original spec."""
    dp = dp_axes(mesh)
    dp_size = math.prod(mesh[a] for a in dp)
    if dp_size <= 1:
        return spec
    # already ZeRO/FSDP-sharded somewhere: a mesh axis may appear only once
    used = set()
    for e in spec:
        for n in e if isinstance(e, tuple) else ((e,) if e else ()):
            used.add(n)
    if used & set(dp):
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for i, (s, dim) in enumerate(zip(entries, shape)):
        if s is None and _div(dim, dp_size):
            entries[i] = dp
            return Spec(*entries)
    return spec
