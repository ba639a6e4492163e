"""Binding of the Hopper flash-attention kernels, forward and backward.

Counterpart of ``repro/kernels/flash_attention/kernel.py``: the Pallas kernel
there becomes ``csrc/flash_attention_fwd.cu`` here, compiled with ``nvcc`` for
``sm_90a`` at first use and called through ``ctypes``.  The note at the top of
the CUDA source says what the kernel computes, what bounds it and why it is
laid out as it is.

``flash_attention_fwd`` takes CUDA tensors only and launches the kernel or
raises.  It counts its launches in ``flash_attention_fwd.launches``.  Which
of the source's two kernels takes a call is ``kernel_path(dtype, dqk, dv)``:
bf16 goes to the Hopper kernel (``wgmma``, TMA, warp specialisation), f32 to
the full-precision one.  The Hopper kernel is persistent: ``fwd_items`` are
its work items in the order they are dealt (``fwd_deal``), in bands of
``fwd_band`` q tiles.  No path falls back to another.  Both are built at
the instances ``HEAD_DIMS`` (square) and ``HEAD_DIM_PAIRS``, and a call takes
the smallest that holds both of its head dims (``kernel_instance``): every
qk and v width up to 160, as the reference takes any, and a qk width up to
192 beside a v width up to 128 (MLA's).  Wider calls raise, naming the
limit: a wider instance leaves the kernel too few K/V stages in shared
memory.  In bf16 a width that is not a multiple of 8 is zero-padded to one
here (the bf16 kernels store 8 columns at a time, and TMA wants rows on
16-byte boundaries); zero columns change no score and give output columns
that are cut off.  The float32 kernels load and store a float at a time,
bounded by the true widths, and take any width as it is.

The backward is ``csrc/flash_attention_bwd.cu``, a library of its own (the
forward's object code does not move with it): ``flash_attention_bwd``
launches it on CUDA tensors or raises, and counts its calls in
``flash_attention_bwd.launches``.  ``kernel_bwd_path(dtype, dqk, dv)`` says
which of its paths takes a call, a static table by instance: bf16 the one
pass (``"wgmma1"``: dQ, dK and dV in one walk over key tiles, dQ's shares
added in a fixed order onto a float32 accumulator in the scratch, so two
calls give the same bits; above 128 a share is taken in slices of 64
columns), float32 the FMA passes (``"fma"``), at the forward's instances
and widths.  ``scratch_floats`` is the scratch a call takes, as
the C entry lays it out; ``bwd_groups`` is the source's rule that splits a
kv head's q heads over the one pass's items.

Both launches are PyTorch custom ops (``torch.ops.repro_torch.
flash_attention_fwd`` and ``flash_attention_bwd``, CUDA only), each with a
fake version that runs the same checks and allocations on fake tensors and
builds and launches nothing (the dry run, ``launch/dryrun.py``), and a flop
formula (``kernels/costs.py``: the products of the (query, key) pairs the
mask keeps, and 2.5x those for the backward).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from repro_torch.compat import on_card

from .._build import load_library, rows_aligned
from ..costs import attention_flops

__all__ = [
    "BWD_PATHS",
    "HEAD_DIMS",
    "HEAD_DIM_PAIRS",
    "ONE_PASS_WIDTHS",
    "PATHS",
    "build",
    "build_bwd",
    "bwd_groups",
    "dq_slices",
    "flash_attention_bwd",
    "flash_attention_fwd",
    "fwd_band",
    "fwd_deal",
    "fwd_items",
    "kernel_bwd_path",
    "kernel_instance",
    "kernel_path",
    "scratch_floats",
]

HEAD_DIMS = (32, 64, 80, 96, 128, 160)  # the square instances (dqk == dv) that both CUDA sources build
HEAD_DIM_PAIRS = ((192, 128),)  # the instances with dqk != dv: MLA's
MAX_SQUARE = HEAD_DIMS[-1]  # every qk and v width up to this is taken
_ALIGN = 8  # widths reach the kernels as multiples of this; the wrappers pad others
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention_fwd.cu"
_BWD_SOURCE = _SOURCE.with_name("flash_attention_bwd.cu")
# the source's kernels, by the id that its `flash_attention_path` returns
PATHS = ("f32", "wgmma")
# the backward source's paths, by the id that `flash_attention_bwd_path` returns
BWD_PATHS = ("fma", "wgmma1")
# the one pass's instances (by qk width) and their padded rows
ONE_PASS_WIDTHS = {32: 32, 64: 64, 80: 96, 96: 96, 128: 128, 160: 160, 192: 192}
_ITEM_SMS = 132  # the H100's SMs, which the source's rule that sizes the one pass's items counts on
_FWD_BLOCK = 128  # q rows a forward item and keys a KV tile (the source's kHBlockM and kHBlockN)
_KV_SHARE = 8  # CTAs that read one kv head's K and V tiles at once in the forward (the source's kKVShare)
# what the C entry returns besides a cudaError_t
_ERRORS = {
    -1: "this (dtype, head dim) is not built",
    -2: "libcuda has no cuTensorMapEncodeTiled",
    -3: "a TMA tensor map could not be encoded for these pointers and strides",
    -4: "a bf16 head dim is not a multiple of 8",
}


def kernel_instance(dqk: int, dv: Optional[int] = None) -> Tuple[int, int]:
    """The instance ``(DQK, DV)`` of both CUDA sources that takes head dims
    ``(dqk, dv)``: the smallest square of ``HEAD_DIMS`` that holds both, else
    (192, 128) where it holds them.  Raises, naming the limit, for widths
    no instance holds.  The C entries' ``flash_attention_instance`` is the
    same table."""
    dv = dqk if dv is None else dv
    if dqk < 1 or dv < 1:
        raise ValueError(f"head dims (qk {dqk}, v {dv}) are not built: widths start at 1")
    for sq in HEAD_DIMS:
        if max(dqk, dv) <= sq:
            return sq, sq
    for pair in HEAD_DIM_PAIRS:
        if dqk <= pair[0] and dv <= pair[1]:
            return pair
    raise ValueError(f"head dims (qk {dqk}, v {dv}) are not built: the kernels take every qk and v width up "
                     f"to {MAX_SQUARE}, and qk up to {HEAD_DIM_PAIRS[0][0]} with v up to {HEAD_DIM_PAIRS[0][1]}; "
                     f"a wider instance leaves too few K/V stages in the 232,448 bytes of shared memory")


def kernel_path(dtype: torch.dtype, dqk: int, dv: Optional[int] = None) -> str:
    """The kernel that takes ``(dtype, dqk, dv)`` (``dv`` defaults to
    ``dqk``): ``"wgmma"`` (bf16) or ``"f32"``, at the instance
    ``kernel_instance(dqk, dv)``.  Raises for anything the source does not
    build.  The C entry's ``flash_attention_path_dqk_dv`` is the same
    table."""
    if dtype not in _DTYPES:
        raise ValueError(f"q, k, v must share float32 or bfloat16, got {dtype}")
    kernel_instance(dqk, dv)
    return "f32" if dtype == torch.float32 else "wgmma"


def kernel_bwd_path(dtype: torch.dtype, dqk: int, dv: Optional[int] = None) -> str:
    """The backward's path for ``(dtype, dqk, dv)``: ``"wgmma1"`` (bf16, at
    every instance: the one pass) or ``"fma"`` (float32).  Raises, before
    any build, for what ``kernel_path`` refuses: the two sources build the
    same instances.  The C entry's ``flash_attention_bwd_path`` is the same
    table."""
    kernel_path(dtype, dqk, dv)
    return "fma" if dtype == torch.float32 else "wgmma1"


def fwd_band(h: int, kvh: int, sq: int) -> int:
    """The bf16 forward's band (the source's ``band_of``): how many q tiles of
    one (batch, q head) go out side by side, so that with the q heads of a kv
    head next to each other about eight CTAs read the same K and V tiles at
    once (``ceil(8 / group)``, at most the q tiles there are)."""
    n_qt, g = -(-sq // _FWD_BLOCK), h // kvh
    return min(n_qt, max(1, -(-_KV_SHARE // g)))


def fwd_items(b: int, h: int, kvh: int, sq: int, sk: int, causal: bool) -> list:
    """The bf16 forward's work items by number (the source's ``item``), each
    ``(batch, q head, q tile, key tiles)``: heavy first, in bands of
    ``fwd_band`` q tiles from the last (the most keys under a causal mask),
    every (batch, q head) at one band before any at the next, a band's q
    tiles of one (batch, q head) next to each other."""
    band = fwd_band(h, kvh, sq)
    n_qt, n_kt = -(-sq // _FWD_BLOCK), -(-sk // _FWD_BLOCK)
    items = []
    for w in range(n_qt * b * h):
        bnd, r = divmod(w, band * b * h)
        width = min(band, n_qt - bnd * band)  # the last band may have fewer q tiles
        bh, off = divmod(r, width)
        qt = n_qt - 1 - bnd * band - off
        items.append((bh // h, bh % h, qt, min(n_kt, qt + 1) if causal else n_kt))
    return items


def fwd_deal(n_items: int, n_units: int) -> list:
    """The item numbers each of ``n_units`` CTAs takes, in order (the source's
    ``number_of``): rounds of one item a CTA, every other round in reverse."""
    rounds = -(-n_items // n_units)
    return [[w for k in range(rounds) if (w := k * n_units + (n_units - 1 - u if k & 1 else u)) < n_items]
            for u in range(n_units)]


def _pad_to(x: torch.Tensor, width: int) -> torch.Tensor:
    return x if x.shape[-1] == width else F.pad(x, (0, width - x.shape[-1]))


def _aligned(d: int) -> int:
    return -(-d // _ALIGN) * _ALIGN


@functools.lru_cache(maxsize=None)
def build(source: Path = _SOURCE):
    """Compile (if needed) and load the kernel's library; returns its entry
    point for one head dim, with the entry for a (dqk, dv) pair as
    ``.dqk_dv``, the path tables as ``.path`` and ``.path_dqk_dv``, the
    instance table as ``.instance`` and the bf16 kernel's band rule as
    ``.band``."""
    lib = load_library("flash_attention_fwd", [source])
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    head = [ptr, ptr, ptr, ptr, ptr, c_int, c_int, c_int, c_int, c_int, c_int]  # q k v o lse dtype b h kvh sq sk
    tail = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, c_int, ptr]  # strides scale causal stream
    fn = lib.flash_attention_fwd
    fn.argtypes = head + [c_int] + tail  # d
    fn.restype = c_int
    # an earlier source (benchmarked with --other) may not export these
    fn.dqk_dv = getattr(lib, "flash_attention_fwd_dqk_dv", None)
    fn.path = getattr(lib, "flash_attention_path", None)
    fn.path_dqk_dv = getattr(lib, "flash_attention_path_dqk_dv", None)
    fn.instance = getattr(lib, "flash_attention_instance", None)
    fn.band = getattr(lib, "flash_attention_fwd_band", None)
    if fn.dqk_dv is not None:
        fn.dqk_dv.argtypes = head + [c_int, c_int] + tail  # dqk dv
        fn.dqk_dv.restype = c_int
    for table, n_args in ((fn.path, 2), (fn.path_dqk_dv, 3), (fn.instance, 2), (fn.band, 3)):
        if table is not None:
            table.argtypes = [c_int] * n_args
            table.restype = c_int
    return fn


def _in_place(x: torch.Tensor, path: str) -> bool:
    """Whether ``path``'s kernels read or write ``x`` where it lies: the
    float32 ones need only a contiguous head dim; TMA and the bf16 stores also
    need rows on 16-byte boundaries and no zero stride."""
    return (rows_aligned(x) and _no_broadcast(x)) if path.startswith("wgmma") else x.stride(-1) == 1


def _check_fwd(q, k, v, causal, out) -> Tuple[str, bool]:
    """The forward's checks, on real and fake tensors alike: ``(path, padded)``."""
    if not (on_card(q) and on_card(k) and on_card(v)):
        raise ValueError("flash_attention_fwd launches a CUDA kernel: the tensors must be on the card")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"bad shapes q={tuple(q.shape)} k={tuple(k.shape)} v={tuple(v.shape)}")
    b, h, sq, d = q.shape
    kvh, sk, dv = k.shape[1], k.shape[2], v.shape[3]
    if k.shape[0] != b or k.shape[3] != d or kvh == 0 or h % kvh != 0:
        raise ValueError(f"bad shapes q={tuple(q.shape)} k={tuple(k.shape)}")
    if min(b, h, sq, sk) == 0:
        raise ValueError("empty attention problem")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share float32 or bfloat16, got {q.dtype} {k.dtype} {v.dtype}")
    path = kernel_path(q.dtype, d, dv)
    if causal and sq != sk:
        raise ValueError(f"causal attention needs sq == sk, got {sq} and {sk}")
    padded = path == "wgmma" and bool(d % _ALIGN or dv % _ALIGN)
    if out is not None and (out.shape != (b, h, sq, dv) or out.dtype != q.dtype or out.device != q.device
                            or not (padded or _in_place(out, path))):
        raise ValueError("out must be (b, h, sq, dv) in q's type and device, with rows its kernel writes in place")
    return path, padded


def flash_attention_fwd(
    q: torch.Tensor,  # (b, h, sq, dqk)
    k: torch.Tensor,  # (b, kvh, sk, dqk)
    v: torch.Tensor,  # (b, kvh, sk, dv)
    *,
    causal: bool = True,
    out: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Head-major flash attention on the card.  Returns ``(out, lse)``.

    ``out`` is ``(b, h, sq, dv)`` in ``q.dtype``; ``lse`` is ``(b, h, sq)``
    float32, ``m + log(max(l, 1e-30))``; the scores are scaled by
    ``dqk ** -0.5``.  Any ``dqk`` and ``dv`` that ``kernel_instance`` takes
    are taken.  The tensors may be strided views (a transposed
    ``(b, s, h, d)`` tensor is taken as it is) as long as the head dim is
    contiguous; ``out``, when given, is written in place.  Any ``sq`` and
    ``sk`` are taken; ``causal`` needs ``sq == sk``.  The launch is the
    custom op ``torch.ops.repro_torch.flash_attention_fwd``, which runs the
    checks; its fake version runs the same checks and allocations and
    launches nothing.
    """
    if out is None:
        out = torch.empty(q.shape[:3] + v.shape[3:], dtype=q.dtype, device=q.device)
    return out, torch.ops.repro_torch.flash_attention_fwd(q, k, v, causal, out)


def _fwd(q, k, v, causal, out, launch):
    path, padded = _check_fwd(q, k, v, causal, out)
    d, dv = q.shape[3], v.shape[3]
    if padded:  # zero columns: the same scores, output columns cut off
        o, lse = _launch_fwd(_pad_to(q, _aligned(d)), _pad_to(k, _aligned(d)), _pad_to(v, _aligned(dv)),
                             None, causal, d**-0.5, path, launch)
        out.copy_(o[..., :dv])
        return lse
    return _launch_fwd(q, k, v, out, causal, d**-0.5, path, launch)[1]


# on every device, so that a CPU tensor meets the checks' ValueError
@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=("out",))
def _fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, out: torch.Tensor) -> torch.Tensor:
    return _fwd(q, k, v, causal, out, launch=True)


@_fwd_op.register_fake
def _(q, k, v, causal, out):
    return _fwd(q, k, v, causal, out, launch=False)


@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
def _(q_shape, k_shape, v_shape, causal, *args, **kwargs) -> int:
    b, h, sq, d = q_shape
    return attention_flops(b, h, sq, k_shape[2], d, v_shape[3], causal)


def _launch_fwd(q, k, v, out, causal, scale, path, launch):
    """The copies, the allocations and (with ``launch``) the launch: ``(out, lse)``."""
    b, h, sq, d = q.shape
    kvh, sk, dv = k.shape[1], k.shape[2], v.shape[3]
    # TMA follows any stride that is a multiple of 16 bytes, but not a zero
    # one (a broadcast head): such a tensor is handed over as a copy too
    q, k, v = (x if _in_place(x, path) else x.contiguous() for x in (q, k, v))
    if out is None:
        out = torch.empty((b, h, sq, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if not launch:
        return out, lse
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3]
    )
    fn = build()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            _DTYPES[q.dtype], b, h, kvh, sq, sk)  # fmt: skip
    tail = (strides, scale, int(causal), torch.cuda.current_stream().cuda_stream)
    with torch.cuda.device(q.device):
        if dv == d:
            err = fn(*args, d, *tail)
        elif fn.dqk_dv is None:
            raise RuntimeError("this build of the kernel has no entry for distinct qk and v head dims")
        else:
            err = fn.dqk_dv(*args, d, dv, *tail)
    if err != 0:
        why = _ERRORS.get(err, f"CUDA error {err}")
        raise RuntimeError(f"flash_attention_fwd ({path} kernel): launch failed: {why}")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


@functools.lru_cache(maxsize=None)
def build_bwd(source: Path = _BWD_SOURCE):
    """Compile (if needed) and load the backward's library; returns its entry
    point, with the path table as ``.path``."""
    lib = load_library("flash_attention_bwd", [source])
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    fn = lib.flash_attention_bwd
    fn.argtypes = ([ptr] * 10  # q k v out dout lse dq dk dv scratch
                   + [c_int] * 8  # dtype b h kvh sq sk dqk dv
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, c_int, ptr])  # strides scale causal stream
    fn.restype = c_int
    fn.path = lib.flash_attention_bwd_path
    fn.path.argtypes = [c_int] * 3
    fn.path.restype = c_int
    # an earlier source (benchmarked with --other) may not export it
    fn.scratch = getattr(lib, "flash_attention_bwd_scratch_floats", None)
    if fn.scratch is not None:
        fn.scratch.argtypes = [c_int] * 9  # dtype b h kvh sq sk dqk dv causal
        fn.scratch.restype = ctypes.c_longlong
    return fn


def bwd_groups(b: int, kvh: int, g: int, n_qt: int, n_kt: int, causal: bool) -> int:
    """G, the groups into which the one pass splits a kv head's ``g`` q heads
    (the source's ``groups_of``): the fewest, a divisor of ``g``, such that
    the heaviest item (key tile 0's, ``g / G`` heads of ``n_qt`` q tiles) is
    no heavier than the work spread evenly over the H100's 132 SMs."""
    per_head = sum(n_qt - 2 * kt if causal else n_qt for kt in range(n_kt))
    total = per_head * b * kvh * g
    for groups in range(1, g):
        if g % groups == 0 and (g // groups) * n_qt * _ITEM_SMS <= total:
            return groups
    return g


def scratch_floats(path: str, b: int, h: int, kvh: int, sq: int, sk: int, dqk: int, dv: int, causal: bool) -> int:
    """Floats of scratch a backward call takes, as its C entry lays them out
    (the source's ``layout_of``): lse * log2(e) and delta, each (b, h, sq)
    padded to a multiple of 128 rows; for the one pass (``"wgmma1"``) also
    the counters (one a (batch, q head, q tile of 64) and dQ slice, then,
    where G > 1, one a (batch, kv head, key tile of 128); padded to 4), dQ's
    float32 accumulator (b h n_qt blocks of 64 rows x the instance's padded
    qk width) and, where G > 1, dK's and dV's (b kvh n_kt blocks of 128 rows
    x twice that width).  ``dqk`` and ``dv`` are the widths the C entry is given
    (multiples of 8)."""
    total = 2 * b * h * (-(-sq // 128) * 128)
    if path != "wgmma1":
        return total
    width = ONE_PASS_WIDTHS[kernel_instance(dqk, dv)[0]]
    n_qt, n_kt = -(-sq // 64), -(-sk // 128)
    groups = bwd_groups(b, kvh, h // kvh, n_qt, n_kt, causal)
    dq_blocks = b * h * n_qt
    dq_ctr = dq_blocks * dq_slices(width)
    dkv_n = b * kvh * n_kt if groups > 1 else 0
    return total + -(-(dq_ctr + dkv_n) // 4) * 4 + dq_blocks * 64 * width + dkv_n * 128 * 2 * width


def dq_slices(width: int) -> int:
    """The slices in which the one pass takes a dQ share of a padded qk
    ``width`` (the source's ``slices_of``): one up to 128, slices of 64
    columns above, each added behind a counter of its own."""
    return -(-width // 64) if width > 128 else 1


def _check_bwd(q, k, v, out, lse, dout, causal, dq, dk, dv) -> Tuple[str, bool]:
    """The backward's checks, on real and fake tensors alike: ``(path, padded)``."""
    tensors = (q, k, v, out, lse, dout)
    if not all(on_card(x) for x in tensors):
        raise ValueError("flash_attention_bwd launches a CUDA kernel: the tensors must be on the card")
    if any(x.device != q.device for x in tensors):
        raise ValueError(f"the tensors must lie on one card, got {[str(x.device) for x in tensors]}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"bad shapes q={tuple(q.shape)} k={tuple(k.shape)} v={tuple(v.shape)}")
    b, h, sq, d = q.shape
    kvh, sk, d_v = k.shape[1], k.shape[2], v.shape[3]
    if k.shape[0] != b or k.shape[3] != d or kvh == 0 or h % kvh != 0:
        raise ValueError(f"bad shapes q={tuple(q.shape)} k={tuple(k.shape)}")
    if min(b, h, sq, sk) == 0:
        raise ValueError("empty attention problem")
    if k.dtype != q.dtype or v.dtype != q.dtype or out.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError(f"q, k, v, out, dout must share float32 or bfloat16, got "
                         f"{[x.dtype for x in (q, k, v, out, dout)]}")
    path = kernel_bwd_path(q.dtype, d, d_v)
    if causal and sq != sk:
        raise ValueError(f"causal attention needs sq == sk, got {sq} and {sk}")
    if out.shape != (b, h, sq, d_v) or dout.shape != out.shape:
        raise ValueError(f"out and dout must be (b, h, sq, dv) = {(b, h, sq, d_v)}, got "
                         f"{tuple(out.shape)} and {tuple(dout.shape)}")
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be (b, h, sq) = {(b, h, sq)} float32, got {tuple(lse.shape)} {lse.dtype}")
    padded = path.startswith("wgmma") and bool(d % _ALIGN or d_v % _ALIGN)
    for given, like, name in ((dq, q, "dq"), (dk, k, "dk"), (dv, v, "dv")):
        if given is not None and (given.shape != like.shape or given.dtype != like.dtype
                                  or given.device != like.device or not (padded or _in_place(given, path))):
            raise ValueError(f"{name} must have the shape, type and device of its input, with rows its kernel "
                             "writes in place")
    return path, padded


def flash_attention_bwd(
    q: torch.Tensor,  # (b, h, sq, dqk)
    k: torch.Tensor,  # (b, kvh, sk, dqk)
    v: torch.Tensor,  # (b, kvh, sk, dv)
    out: torch.Tensor,  # (b, h, sq, dv)
    lse: torch.Tensor,  # (b, h, sq) float32
    dout: torch.Tensor,  # (b, h, sq, dv)
    *,
    causal: bool = True,
    dq: Optional[torch.Tensor] = None,
    dk: Optional[torch.Tensor] = None,
    dv: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of ``flash_attention_fwd`` on the card: ``(dq, dk, dv)``
    in the types and shapes of ``q``, ``k``, ``v``, from the forward's
    ``out`` and ``lse``.  The function of ``models/layers/flash_core.py``'s
    ``flash_attention_bwd`` (the JAX ``_bwd``) in the head-major layout.

    Takes what the forward takes: any ``sq`` and, when not causal, any
    ``sk``; strided views whose head dim is contiguous (the models'
    transposed ``(b, s, h, d)`` tensors go in with no copy); a ``dout``
    with a zero stride (autograd's broadcast) is handed over as a copy.
    ``dq``, ``dk``, ``dv``, when given, are written in place.  One call is
    three device launches (delta, then the one pass and dq's convert, or
    float32's dk/dv and dq passes) and counts one in
    ``flash_attention_bwd.launches``.  The launch is the custom op
    ``torch.ops.repro_torch.flash_attention_bwd``, which runs the checks.
    """
    grads = [torch.empty(like.shape, dtype=like.dtype, device=like.device) if given is None else given
             for given, like in zip((dq, dk, dv), (q, k, v))]
    torch.ops.repro_torch.flash_attention_bwd(q, k, v, out, lse, dout, causal, *grads)
    return tuple(grads)


def _bwd(q, k, v, out, lse, dout, causal, dq, dk, dv, launch):
    path, padded = _check_bwd(q, k, v, out, lse, dout, causal, dq, dk, dv)
    d, d_v = q.shape[3], v.shape[3]
    if padded:  # zero columns: the same P and dS, gradient columns cut off
        wq, wv = _aligned(d), _aligned(d_v)
        grads = _launch_bwd(_pad_to(q, wq), _pad_to(k, wq), _pad_to(v, wv), _pad_to(out, wv), lse,
                            _pad_to(dout, wv), causal, d**-0.5, path, (None, None, None), launch)
        for g, given, width in zip(grads, (dq, dk, dv), (d, d, d_v)):
            given.copy_(g[..., :width])
    else:
        _launch_bwd(q, k, v, out, lse, dout, causal, d**-0.5, path, (dq, dk, dv), launch)


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=("dq", "dk", "dv"))
def _bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
            dout: torch.Tensor, causal: bool, dq: torch.Tensor, dk: torch.Tensor, dv: torch.Tensor) -> None:
    _bwd(q, k, v, out, lse, dout, causal, dq, dk, dv, launch=True)


@_bwd_op.register_fake
def _(q, k, v, out, lse, dout, causal, dq, dk, dv):
    _bwd(q, k, v, out, lse, dout, causal, dq, dk, dv, launch=False)


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _(q_shape, k_shape, v_shape, out_shape_, lse_shape, dout_shape, causal, *args, **kwargs) -> int:
    """The function's five products, 2.5x the forward's (``costs.attention_bwd_bound``)."""
    b, h, sq, d = q_shape
    return int(2.5 * attention_flops(b, h, sq, k_shape[2], d, v_shape[3], causal))


def _launch_bwd(q, k, v, out, lse, dout, causal, scale, path, given_grads, launch):
    b, h, sq, d = q.shape
    kvh, sk, d_v = k.shape[1], k.shape[2], v.shape[3]
    # TMA follows any stride that is a multiple of 16 bytes, but not a zero
    # one (a broadcast head, autograd's broadcast dout): such a tensor is
    # handed over as a copy, as the forward does
    q, k, v, out, dout = (x if _in_place(x, path) else x.contiguous() for x in (q, k, v, out, dout))
    lse = lse.contiguous()
    grads = [torch.empty(like.shape, dtype=like.dtype, device=like.device) if given is None else given
             for given, like in zip(given_grads, (q, k, v))]
    scratch = _scratch(scratch_floats(path, b, h, kvh, sq, sk, d, d_v, causal), q.device)
    if not launch:
        return grads
    fn = build_bwd()
    strides = (ctypes.c_longlong * 24)(*(st for x in (q, k, v, out, dout, *grads) for st in x.stride()[:3]))
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                 *(x.data_ptr() for x in grads), scratch.data_ptr(), _DTYPES[q.dtype], b, h, kvh, sq, sk, d, d_v,
                 strides, scale, int(causal), torch.cuda.current_stream().cuda_stream)  # fmt: skip
    if err != 0:
        why = _ERRORS.get(err, f"CUDA error {err}")
        raise RuntimeError(f"flash_attention_bwd ({path} kernels): launch failed: {why}")
    flash_attention_bwd.launches += 1
    return tuple(grads)


flash_attention_bwd.launches = 0


def _scratch(n_floats: int, device: torch.device) -> torch.Tensor:
    """The backward's scratch, uninitialised: its C entry writes every float it reads."""
    return torch.empty(n_floats, dtype=torch.float32, device=device)


def _no_broadcast(x: torch.Tensor) -> bool:
    return all(st != 0 or n == 1 for n, st in zip(x.shape, x.stride()))
