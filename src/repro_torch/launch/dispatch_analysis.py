"""What the port's eager step dispatches, counted op by op: the twin of
``repro/launch/hlo_analysis.py``.

The reference reads the optimized HLO of a compiled step; PyTorch runs
eagerly, so this module watches the ops the step dispatches, on fake
tensors (``torch._subclasses.fake_tensor.FakeTensorMode``: shapes, types and
devices, no storage, nothing launched), with one ``TorchDispatchMode``:

  * FLOPs per device, from the formulas of ``torch.utils.flop_counter``
    (its ``flop_registry``, which ``FlopCounterMode`` reads too: the aten
    products, and the ones the kernels' custom ops register: K1's forward counts the
    products of the (query, key) pairs its mask keeps, its backward 2.5x
    those, K2 the chunked scan's), split by the type of the op's first
    operand: bf16 products run on the tensor cores, float32 ones on the CUDA
    cores at a fifteenth of the rate;
  * bytes accessed per device: the operand and result bytes of every op
    that moves data (the kernels' custom ops among them; not a view, a
    metadata query or an allocation alone), a broadcast operand's bytes
    once;
  * transcendental elements: the output elements of exp, log, tanh,
    sigmoid, softmax and their kin;
  * collectives by kind (all-reduce, all-gather, reduce-scatter, all-to-all,
    broadcast), each with its count, result bytes and wire bytes from its
    group's size, by the reference's ring formulas
    (``repro/launch/dryrun.py:parse_collectives``; a broadcast moves its
    whole buffer over each link);
  * memory: the bytes of the step's arguments and of its outputs, and the
    peak of live bytes during the step: every storage an op creates is
    counted from its creation until it is freed (a finalizer on the
    storage); the temp bytes are the peak less the arguments.

Eager loops unroll, so the reference's while-loop trip counts have no
counterpart: every microbatch and every layer is dispatched.  What the
count cannot see: allocations made and freed inside one custom op's
implementation (its scratch), the caching allocator's rounding, and kernels
that PyTorch's own ops launch more than once.
"""

from __future__ import annotations

import weakref
from typing import Any, Dict, Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

# the kernels' custom ops register their flop formulas when their modules are
# imported, so before any step runs
import repro_torch.kernels.flash_attention.kernel  # noqa: E402,F401
import repro_torch.kernels.ssd_scan.kernel  # noqa: E402,F401

__all__ = ["COLLECTIVES", "DispatchAnalysis", "analyze", "wire_bytes"]

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "broadcast")
# ops whose outputs are transcendental functions of their inputs, one each an element
_TRANSCENDENTAL = {"exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "tanh", "sigmoid", "sin", "cos",
                   "rsqrt", "sqrt", "erf", "erfinv", "silu", "gelu", "softplus", "mish", "softmax", "log_softmax",
                   "logsumexp", "pow"}  # by name, underscores stripped (``_softmax``, ``exp_``)
# ops that only allocate: no byte is read or written
_ALLOCATIONS = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided"}
_HALF = (torch.bfloat16, torch.float16)


def _collective_kind(name: str):
    for key, kind in (("allreduce", "all-reduce"), ("all_reduce", "all-reduce"), ("allgather", "all-gather"),
                      ("all_gather", "all-gather"), ("reduce_scatter", "reduce-scatter"),
                      ("alltoall", "all-to-all"), ("all_to_all", "all-to-all"), ("broadcast", "broadcast")):
        if key in name:
            return kind
    return None


def wire_bytes(kind: str, result_bytes: float, group: int) -> float:
    """Bytes one device puts on its links for a collective of ``result_bytes``
    over a group of ``group`` (ring formulas, as the reference's)."""
    g = max(group, 1)
    if kind == "all-reduce":
        return 2.0 * result_bytes * (g - 1) / g
    if kind in ("all-gather", "all-to-all"):
        return result_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return float(result_bytes * (g - 1))  # the operand is the result times g
    return float(result_bytes) if g > 1 else 0.0  # broadcast


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    """The bytes ``t`` spans: a broadcast (zero-stride) dimension is read once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _aliases(func, args, kwargs, out) -> bool:
    """Whether ``func`` only reads metadata or returns its input's storage
    unwritten (a view, ``_unsafe_view``, ``prim.device``): no byte moves."""
    if func.is_view or func.namespace == "prim":
        return True
    outs = _tensors(out)
    if not outs or func._schema.is_mutable:
        return False
    held = {t.untyped_storage()._cdata for t in _tensors((args, kwargs))}
    return all(t.untyped_storage()._cdata in held for t in outs)


def _group_size(args, kwargs) -> int:
    import torch.distributed as dist

    for a in tree_leaves((args, kwargs)):
        if isinstance(a, torch.ScriptObject) and "ProcessGroup" in str(a._type()):  # how the c10d ops carry a group
            return dist.ProcessGroup.unbox(a).size()
        if isinstance(a, dist.ProcessGroup):
            return a.size()
        if isinstance(a, str):  # a functional collective names its group
            try:
                return dist.distributed_c10d._resolve_process_group(a).size()
            except Exception:  # noqa: BLE001 - a string that names no group
                continue
    return 1


class DispatchAnalysis(TorchDispatchMode):
    """Counts what runs under it (module note).  ``hold(tree)`` first names
    the step's arguments; ``finish(outputs)`` then returns the record."""

    def __init__(self):
        super().__init__()
        self.flops = {"bf16": 0, "f32": 0, "other": 0}
        self.bytes_accessed = 0
        self.transcendental_elems = 0
        self.collectives = {k: {"count": 0, "result_bytes": 0, "wire_bytes": 0.0, "group_sizes": []}
                            for k in COLLECTIVES}  # fmt: skip
        self.ops = 0
        self._args: Dict[int, int] = {}  # storage id -> bytes, the arguments'
        self._live: Dict[int, int] = {}  # storage id -> bytes, created during the step and not yet freed
        self._live_bytes = 0
        self._peak = 0

    # -- memory --------------------------------------------------------------
    def hold(self, tree: Any) -> None:
        """Count the storages of ``tree`` (the step's arguments) as arguments."""
        for t in _tensors(tree):
            st = t.untyped_storage()
            self._args.setdefault(st._cdata, st.nbytes())
        self._peak = max(self._peak, self.argument_bytes)

    @property
    def argument_bytes(self) -> int:
        return sum(self._args.values())

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._args or key in self._live:
            return
        self._live[key] = st.nbytes()
        self._live_bytes += self._live[key]
        self._peak = max(self._peak, self.argument_bytes + self._live_bytes)
        weakref.finalize(st, self._freed, key)

    def _freed(self, key: int) -> None:
        self._live_bytes -= self._live.pop(key, 0)

    # -- dispatch --------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.overloadpacket not in flop_registry and func is not torch.ops.prim.device.default:
            # a composite op (``matmul`` under inference mode): count what it
            # decomposes into, as FlopCounterMode does
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        self.ops += 1
        packet = func.overloadpacket
        name = packet.__name__
        namespace = func.namespace
        kind = _collective_kind(name) if namespace in ("c10d", "_c10d_functional") else None
        if kind is not None:
            result = _tensors(args[0] if namespace == "c10d" else out)
            rb = sum(map(_nbytes, result))
            g = _group_size(args, kwargs)
            row = self.collectives[kind]
            row["count"] += 1
            row["result_bytes"] += rb
            row["wire_bytes"] += wire_bytes(kind, rb, g)
            if g not in row["group_sizes"]:
                row["group_sizes"].append(g)
        elif name not in _ALLOCATIONS and not _aliases(func, args, kwargs, out):
            self.bytes_accessed += sum(map(_nbytes, _tensors((args, kwargs)))) + sum(map(_nbytes, _tensors(out)))
        if packet in flop_registry:
            n = flop_registry[packet](*args, **kwargs, out_val=out)
            first = next(iter(_tensors((args, kwargs))), None)
            dtype = None if first is None else first.dtype
            self.flops["bf16" if dtype in _HALF else ("f32" if dtype == torch.float32 else "other")] += n
        if name.strip("_") in _TRANSCENDENTAL:
            self.transcendental_elems += sum(t.numel() for t in _tensors(out))
        for t in _tensors(out):
            self._track(t)
        return out

    def finish(self, outputs: Any) -> Dict[str, Any]:
        """The record's ``memory`` and ``dispatch_analysis`` entries (the
        reference's ``memory`` and ``hlo_analysis``)."""
        seen, out_bytes = set(), 0
        for t in _tensors(outputs):
            st = t.untyped_storage()
            if st._cdata not in self._args and st._cdata not in seen:
                seen.add(st._cdata)
                out_bytes += st.nbytes()
        wire = sum(c["wire_bytes"] for c in self.collectives.values())
        memory = {"argument_bytes": self.argument_bytes, "output_bytes": out_bytes, "peak_bytes": self._peak,
                  "temp_bytes": self._peak - self.argument_bytes}
        analysis = {
            "flops_per_device": sum(self.flops.values()),
            "bf16_flops_per_device": self.flops["bf16"],
            "f32_flops_per_device": self.flops["f32"] + self.flops["other"],
            "bytes_accessed_per_device": self.bytes_accessed,
            "transcendental_elems": self.transcendental_elems,
            "collectives": self.collectives,
            "wire_bytes_per_device": wire,
            "collective_count": sum(c["count"] for c in self.collectives.values()),
            "ops_dispatched": self.ops,
        }
        return {"memory": memory, "dispatch_analysis": analysis}


def analyze(fn, *args: Iterable[Any]) -> Dict[str, Any]:
    """Run ``fn(*args)`` (on fake tensors, inside a ``FakeTensorMode``) under
    a :class:`DispatchAnalysis`; ``(outputs, record)``."""
    analysis = DispatchAnalysis()
    analysis.hold(args)
    with analysis:
        outputs = fn(*args)
    return outputs, analysis.finish(outputs)
