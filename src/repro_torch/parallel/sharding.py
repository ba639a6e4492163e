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
not divide the mesh axis falls back to replication.

Applying the specs: the spec functions take the ``{axis: size}`` mapping or
a ``torch.distributed`` ``DeviceMesh`` with named dimensions (one process a
device, ``repro_torch.launch.mesh.device_mesh``); :func:`axis_sizes` reads
either.  A placed array is a plain local tensor -- this process's block --
beside a :class:`NamedSharding` record of (mesh, spec), not a ``DTensor``:
the kernels take raw pointers and the decode step is a captured CUDA graph,
which a tensor subclass's dispatch reaches neither of.  ``shard_local`` takes
this process's block of a whole array at its mesh coordinates, ``gather``
joins the blocks again, and ``param_shardings`` / ``tree_size_bytes`` are
the reference's.

Using the specs: :class:`Shards` walks a spec tree beside the parameter (or
cache) tree, so that a layer reads which head, channel, expert or vocabulary
block this process holds from the leaf's own spec (:func:`model_block`) and
can never split otherwise than ``_spec_for`` placed it.
``check_data_parallel`` says which steps run across processes: serving and
training, each on any ``{"data", "model"}`` mesh.

Collectives over ``model`` that autograd sees (training): a layer's work is
either the same on every model process (the residual stream, the norms on
it, a whole projection) or its own (its heads, channels, experts or
vocabulary rows).  Three operations join the two, after Megatron-LM's f and
g (Shoeybi et al., 2019):

  * (f) :meth:`Shards.enter` -- identity forward, ``all_reduce`` of the
    gradient backward: where a whole tensor (an activation, or a whole leaf
    used by this process's block alone) first meets the process's own work,
    so that its gradient sums every process's part;
  * (g) :meth:`Shards.reduce` -- ``all_reduce`` forward, identity backward:
    where the processes' partial results are summed and the sum is then
    used alike on every process (a row-split projection, the vocab-split
    embedding, the MoE combine, the vocab-parallel cross-entropy's sums);
  * (s) :meth:`Shards.reduce_both` -- ``all_reduce`` both ways: where the sum
    feeds each process's own work again (Mamba-2's gated norm), so that the
    gradient of the whole sum is the sum of the processes' gradients.

Without gradients (serving) each is the plain collective or nothing: (f)
returns its input, (g) and (s) reduce in place as :meth:`Shards.psum` does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.parallel import dist as pdist

__all__ = [
    "NamedSharding",
    "Shards",
    "Spec",
    "axis_sizes",
    "batch_spec",
    "check_data_parallel",
    "dp_axes",
    "enter",
    "gather",
    "held",
    "is_spec",
    "mesh_coords",
    "model_axis_size",
    "model_block",
    "param_shardings",
    "param_specs",
    "shard_local",
    "sub",
    "tree_map_with_path",
    "tree_size_bytes",
    "within",
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


def axis_sizes(mesh: Any) -> Dict[str, int]:
    """A mesh as its ``{axis: size}`` mapping: the mapping itself, or a
    ``DeviceMesh``'s named dimensions in order."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def dp_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in axis_sizes(mesh) if a in ("pod", "data"))


def model_axis_size(mesh: Mesh) -> int:
    return axis_sizes(mesh).get("model", 1)


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
    dp_size = math.prod(axis_sizes(mesh)[a] for a in dp)
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


# ---------------------------------------------------------------------------
# Placements
# ---------------------------------------------------------------------------


def entry_axes(entry: Any) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, major to minor (``None`` is none)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """``jax.sharding.NamedSharding``: a spec placed on a mesh.

    ``mesh`` is a ``DeviceMesh`` (the placement of a process group) or an
    ``{axis: size}`` mapping (spec level: every block is named by explicit
    coordinates).  Dimension ``d`` of an array of ``shape`` is split into
    ``shape[d] / prod(sizes of its axes)`` blocks; the block a process holds
    is numbered by its coordinates on those axes, major to minor.
    """

    mesh: Any
    spec: Spec

    def _entries(self, ndim: int) -> list:
        if len(self.spec) > ndim:
            raise ValueError(f"{self.spec} has more entries than the {ndim} dimensions of the array")
        return list(self.spec) + [None] * (ndim - len(self.spec))

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The shape of one process's block of an array of ``shape``."""
        sizes = axis_sizes(self.mesh)
        out = []
        for dim, entry in zip(shape, self._entries(len(shape))):
            n = math.prod(sizes[a] for a in entry_axes(entry))
            if dim % n:
                raise ValueError(f"dimension {dim} of {tuple(shape)} does not split over {entry!r} ({n} blocks)")
            out.append(dim // n)
        return tuple(out)

    def global_shape(self, shard_shape: Sequence[int]) -> Tuple[int, ...]:
        """The whole array's shape from the shape of one process's block."""
        sizes = axis_sizes(self.mesh)
        return tuple(d * math.prod(sizes[a] for a in entry_axes(e))
                     for d, e in zip(shard_shape, self._entries(len(shard_shape))))  # fmt: skip

    def index(self, shape: Sequence[int], coords: Optional[Mapping[str, int]] = None) -> Tuple[slice, ...]:
        """The slices of the block at ``coords`` (``{axis: index}``; default:
        this process's coordinates on the ``DeviceMesh``) of an array of ``shape``."""
        if coords is None:
            coords = dict(zip(self.mesh.mesh_dim_names, self.mesh.get_coordinate()))
        sizes = axis_sizes(self.mesh)
        out = []
        for dim, block, entry in zip(shape, self.shard_shape(shape), self._entries(len(shape))):
            pos = 0
            for a in entry_axes(entry):
                pos = pos * sizes[a] + coords[a]
            out.append(slice(pos * block, (pos + 1) * block) if block != dim else slice(0, dim))
        return tuple(out)

    def sharded_axes(self) -> Tuple[str, ...]:
        """Every mesh axis the spec splits an array over."""
        return tuple(a for entry in self.spec for a in entry_axes(entry))


def mesh_coords(mesh: Any, rank: int) -> Dict[str, int]:
    """The coordinates ``{axis: index}`` of global ``rank`` on a ``DeviceMesh``."""
    pos = (mesh.mesh == rank).nonzero()
    if pos.shape[0] != 1:
        raise ValueError(f"rank {rank} is not on the mesh {mesh}")
    return dict(zip(mesh.mesh_dim_names, pos[0].tolist()))


def param_shardings(params_tree: Any, mesh: Any, cfg=None) -> Any:
    """A :class:`NamedSharding` tree over ``mesh`` for ``param_specs``'s tree."""
    specs = param_specs(params_tree, axis_sizes(mesh), cfg=cfg)
    return tree_map_with_path(lambda path, s: NamedSharding(mesh, s), specs, is_leaf=is_spec)


def tree_size_bytes(tree: Any, shardings: Optional[Any] = None) -> int:
    """Bytes of the whole (global) arrays of ``tree``.  Its leaves are whole
    (``meta`` tensors too), or, with ``shardings``, each process's block of
    an array placed by the sharding at the same path."""

    sizes = []

    def one(path, leaf, *sh):
        shape = sh[0].global_shape(leaf.shape) if sh else leaf.shape
        sizes.append(math.prod(shape) * leaf.element_size())

    tree_map_with_path(one, tree, *((shardings,) if shardings is not None else ()))
    return sum(sizes)


def shard_local(x: torch.Tensor, sharding: NamedSharding, coords: Optional[Mapping[str, int]] = None) -> torch.Tensor:
    """This process's block (or the one at ``coords``) of the whole array ``x``,
    a contiguous copy: the whole array may be freed after."""
    return x[sharding.index(tuple(x.shape), coords)].clone(memory_format=torch.contiguous_format)


def within(sharding: NamedSharding, held_by: NamedSharding) -> NamedSharding:
    """The placement ``sharding`` relative to the block that ``held_by``
    places: ``shard_local(x, within(s, h))`` of this process's block ``x`` at
    ``h`` is its block at ``s``.  ``s`` must split every dimension as ``h``
    does, or over more axes where ``h`` leaves it whole (a ZeRO block of a
    parameter's block over ``model``)."""
    ndim = max(len(sharding.spec), len(held_by.spec))
    entries = []
    for e, h in zip(sharding._entries(ndim), held_by._entries(ndim)):
        if entry_axes(h) and entry_axes(e) != entry_axes(h):
            raise ValueError(f"{sharding.spec} does not refine {held_by.spec}")
        entries.append(None if entry_axes(h) else e)
    return NamedSharding(sharding.mesh, Spec(*entries))


def gather(local: torch.Tensor, sharding: NamedSharding, axes: Optional[Sequence[str]] = None) -> torch.Tensor:
    """The whole array from every process's block (``all_gather`` over the
    axis groups of the ``DeviceMesh``): a new tensor, or ``local`` itself
    where no dimension is split.  With ``axes``, only the dimensions split
    over axes among them are joined."""
    out = local
    for d, entry in enumerate(sharding._entries(local.dim())):
        names = entry_axes(entry)
        if not names or (axes is not None and not set(names) <= set(axes)):
            continue
        out = pdist.all_gather(out, d, sharding.mesh, names)
    return out


def check_data_parallel(mesh: Any, step: str = "train") -> None:
    """Raise unless a ``step`` ("train" or "serve") across processes runs on
    ``mesh``.  Both run on any ``{"data", "model"}`` mesh: the batch split
    over the data axes, the layers over ``model`` (:class:`Shards`; a train
    step's backward through the collectives of the module note)."""
    if step not in ("train", "serve"):
        raise ValueError(f"step is 'train' or 'serve', got {step!r}")


def model_block(spec: Spec, dim: int, whole: int, mesh: Any) -> slice:
    """The range of dimension ``dim`` (``whole`` long) of an array placed by
    ``spec`` that this process holds over ``model``: its head, channel,
    expert or vocabulary block where the entry names ``model``, the whole
    dimension where it does not.  Data axes in other entries are ignored (a
    layer joins them first, :meth:`Shards.local`); an entry that names
    ``model`` beside another axis is refused (the rules make none)."""
    entries = list(spec) + [None] * (dim + 1 - len(spec))
    names = entry_axes(entries[dim])
    if "model" not in names:
        return slice(0, whole)
    if names != ("model",):
        raise ValueError(f"{spec}: dimension {dim} is split over {names}, not over 'model' alone")
    n = model_axis_size(mesh)
    if whole % n:
        raise ValueError(f"{spec}: dimension {dim} of {whole} does not split over {n} model processes")
    i = _model_index(mesh)
    return slice(i * (whole // n), (i + 1) * (whole // n))


def _model_index(mesh: Any) -> int:
    if "model" not in axis_sizes(mesh):
        return 0
    return mesh.get_coordinate()[list(mesh.mesh_dim_names).index("model")]


def held(shards: Optional["Shards"], path: Sequence[str], leaf: torch.Tensor, dim: int) -> Tuple[slice, int]:
    """:meth:`Shards.held`, and the whole dimension where ``shards`` is None (one process)."""
    if shards is None:
        return slice(0, leaf.shape[dim]), leaf.shape[dim]
    return shards.held(path, leaf, dim)


def sub(shards: Optional["Shards"], key: str) -> Optional["Shards"]:
    """``shards[key]``, None where ``shards`` is None."""
    return None if shards is None else shards[key]


class Shards:
    """A parameter (or cache) subtree's placement on a ``DeviceMesh``, walked
    beside the subtree: ``shards["mixer"]["wq"]`` belongs to
    ``params["mixer"]["wq"]``.  ``specs`` is the subtree's :class:`Spec` tree
    (``param_specs`` / ``cache_specs``), or None where every leaf is whole.

    A layer asks it which block of a leaf this process holds over ``model``
    (:meth:`block`, from the leaf's own spec: the port can never split a
    layer otherwise than ``_spec_for`` placed it), joins the data-axis
    (FSDP) blocks of its parameters before use (:meth:`local`), and reduces
    or gathers over ``model`` (:meth:`psum`, :meth:`gather`: ``all_reduce``
    alone, see ``parallel/dist.py``; with gradients :meth:`enter`,
    :meth:`reduce` and :meth:`reduce_both`, the module note).  Over a model
    axis of one process the collectives are skipped: nothing is split.
    """

    def __init__(self, mesh: Any, specs: Any = None):
        if isinstance(mesh, Mapping):
            raise TypeError("Shards places a subtree on a DeviceMesh, not on an {axis: size} mapping")
        self.mesh, self.specs = mesh, specs
        sizes = axis_sizes(mesh)
        self.model = sizes.get("model", 1)
        self.model_index = _model_index(mesh)
        self.dp = dp_axes(sizes)
        self.dp_size = math.prod(sizes[a] for a in self.dp)

    @classmethod
    def of(cls, shardings: Any) -> Optional["Shards"]:
        """The shards of a :class:`NamedSharding` tree (``param_shardings``),
        None for None."""
        if shardings is None:
            return None
        found = []
        specs = tree_map_with_path(lambda path, s: found.append(s.mesh) or s.spec, shardings,
                                   is_leaf=lambda x: isinstance(x, NamedSharding))  # fmt: skip
        return cls(found[0], specs)

    def _with(self, specs: Any) -> "Shards":
        out = object.__new__(Shards)
        out.__dict__.update(self.__dict__, specs=specs)
        return out

    def __getitem__(self, key: str) -> "Shards":
        return self._with(None if self.specs is None else self.specs[key])

    def group(self) -> "Shards":
        """The shards of one entry of a stacked subtree (its leading group axis dropped)."""
        if self.specs is None:
            return self
        return self._with(tree_map_with_path(lambda path, s: Spec(*s[1:]), self.specs, is_leaf=is_spec))

    def spec(self, *path: str) -> Spec:
        node = self.specs
        for key in path:
            if node is None:
                break
            node = node[key]
        return Spec() if node is None else node

    def block(self, path: Sequence[str], dim: int, whole: int) -> slice:
        """This process's range of dimension ``dim`` (``whole`` long) of the
        leaf at ``path`` (a key or a tuple of keys), by its spec."""
        path = (path,) if isinstance(path, str) else tuple(path)
        return model_block(self.spec(*path), dim, whole, self.mesh)

    def held(self, path: Sequence[str], leaf: torch.Tensor, dim: int) -> Tuple[slice, int]:
        """(this process's range of dimension ``dim``, the whole length) of
        ``leaf``, the block at ``path`` (its data-axis blocks joined)."""
        path = (path,) if isinstance(path, str) else tuple(path)
        spec = self.spec(*path)
        entry = spec[dim] if dim < len(spec) else None
        whole = leaf.shape[dim] * (self.model if "model" in entry_axes(entry) else 1)
        return model_block(spec, dim, whole, self.mesh), whole

    def local(self, tree: Any) -> Any:
        """``tree`` (this subtree's parameters, each leaf this process's block)
        with every dimension split over the data axes joined: each leaf split
        over ``model`` alone, as the layers take it (the reference's FSDP
        rule gathers a weight in the forward the same way)."""
        if self.specs is None or self.dp_size == 1:
            return tree
        dp = set(self.dp)

        def one(path, leaf, spec):
            if not any(set(entry_axes(e)) & dp for e in spec):
                return leaf
            return gather(leaf, NamedSharding(self.mesh, spec), self.dp)

        return tree_map_with_path(one, tree, self.specs)

    def psum(self, x: torch.Tensor, op=None) -> torch.Tensor:
        """``x`` reduced over ``model`` in place (sum by default), returned.
        Autograd does not see it: a value with a gradient takes :meth:`reduce`."""
        if self.model == 1:
            return x
        return pdist.all_reduce(x, self.mesh, "model", op=op if op is not None else pdist.dist.ReduceOp.SUM)

    def _traced(self, x: torch.Tensor) -> bool:
        return self.model > 1 and torch.is_grad_enabled() and x.requires_grad

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """(f): ``x``, a tensor whole and alike on every model process, as it
        enters this process's own work; its gradient is summed over ``model``."""
        return _Enter.apply(x, self) if self._traced(x) else x

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """(g): the sum over ``model`` of every process's ``x``, used alike on
        every process after; its gradient passes to each ``x`` as it is."""
        return _Reduce.apply(x, self, False) if self._traced(x) else self.psum(x)

    def reduce_both(self, x: torch.Tensor) -> torch.Tensor:
        """(s): the sum over ``model`` of every process's ``x``, used by each
        process's own work after; its gradient is summed over ``model`` too."""
        return _Reduce.apply(x, self, True) if self._traced(x) else self.psum(x)

    def gather(self, x: torch.Tensor, dim: int, part: slice, whole: int) -> torch.Tensor:
        """The whole of dimension ``dim`` (``whole`` long) from every model
        process's ``part`` of it (``x``, this process's), a new tensor; ``x``
        itself where ``part`` is already the whole."""
        return self.gather_all([(x, dim, part, whole)])[0]

    def gather_all(self, items: Sequence[Tuple[torch.Tensor, int, slice, int]]) -> list:
        """:meth:`gather` of each ``(x, dim, part, whole)`` (tensors of one
        type), by one ``all_reduce`` of one zeroed buffer that holds them all:
        a decode step's collectives are few and small, so their count is
        their cost."""
        shapes = [tuple(x.shape[:d]) + (whole,) + tuple(x.shape[d + 1 :]) for x, d, _, whole in items]
        todo = [i for i, (x, _, part, whole) in enumerate(items) if part != slice(0, whole)]
        if not todo:
            return [x for x, *_ in items]
        sizes = [math.prod(shapes[i]) for i in todo]
        flat = items[todo[0]][0].new_zeros(sum(sizes))
        out = [x for x, *_ in items]
        for i, view in zip(todo, flat.split(sizes)):
            x, d, part, _ = items[i]
            out[i] = view.view(shapes[i])
            out[i].narrow(d, part.start, part.stop - part.start).copy_(x)
        self.psum(flat)
        return out

    def psum_all(self, tensors: Sequence[torch.Tensor]) -> list:
        """Each of ``tensors`` (of one type) summed over ``model``, by one
        ``all_reduce`` of their concatenation: new tensors."""
        flat = self.psum(torch.cat([t.reshape(-1) for t in tensors]))
        return [part.view(t.shape) for part, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def enter(shards: Optional[Shards], x: torch.Tensor) -> torch.Tensor:
    """:meth:`Shards.enter`, ``x`` itself where ``shards`` is None (one process)."""
    return x if shards is None else shards.enter(x)


def _summed(x: torch.Tensor, shards: Shards) -> torch.Tensor:
    return shards.psum(x.clone(memory_format=torch.contiguous_format))


class _Enter(torch.autograd.Function):
    """(f): identity forward, the gradient summed over ``model`` backward."""

    @staticmethod
    def forward(ctx, x, shards):
        ctx.shards = shards
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad, ctx.shards), None


class _Reduce(torch.autograd.Function):
    """(g) and (s): the sum over ``model`` forward; backward the gradient as
    it is (g) or summed over ``model`` too (s)."""

    @staticmethod
    def forward(ctx, x, shards, both):
        ctx.shards, ctx.both = shards, both
        return _summed(x, shards)

    @staticmethod
    def backward(ctx, grad):
        return (_summed(grad, ctx.shards) if ctx.both else grad), None, None
