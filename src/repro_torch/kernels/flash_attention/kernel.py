"""Binding of the Hopper flash-attention kernels, forward and backward.

Counterpart of ``repro/kernels/flash_attention/kernel.py``: the Pallas kernel
there becomes ``csrc/flash_attention_fwd.cu`` here, compiled with ``nvcc`` for
``sm_90a`` at first use and called through ``ctypes``.  The note at the top of
the CUDA source says what the kernel computes, what bounds it and why it is
laid out as it is.

``flash_attention_fwd`` takes CUDA tensors only and launches the kernel or
raises.  It counts its launches in ``flash_attention_fwd.launches``.  Which
of the source's three kernels takes a call is ``kernel_path(dtype, dqk,
dv)``: bf16 at head dims 64, 80 and 128 and at MLA's pair (qk 192, v 128)
goes to the Hopper kernel (``wgmma``, TMA, warp specialisation), bf16 at 16
to the ``mma.sync`` kernel, f32 to the full-precision one.  No path falls
back to another.

The backward is ``csrc/flash_attention_bwd.cu``, a library of its own (the
forward's object code does not move with it): ``flash_attention_bwd``
launches it on CUDA tensors or raises, and counts its calls in
``flash_attention_bwd.launches``.  ``kernel_bwd_path(dtype, dqk, dv)`` says
which of its families takes a call: bf16 at every built head dim the Hopper
passes (``wgmma``, TMA), float32 the FMA passes.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Tuple

import torch

from .._build import load_library, rows_aligned

__all__ = [
    "BWD_PATHS",
    "HEAD_DIMS",
    "HEAD_DIM_PAIRS",
    "PATHS",
    "build",
    "build_bwd",
    "flash_attention_bwd",
    "flash_attention_fwd",
    "kernel_bwd_path",
    "kernel_path",
]

HEAD_DIMS = (16, 64, 80, 128)  # the head dims (dqk == dv) that the CUDA source instantiates
HEAD_DIM_PAIRS = ((192, 128),)  # the (dqk, dv) pairs with dqk != dv it instantiates: MLA's
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention_fwd.cu"
_BWD_SOURCE = _SOURCE.with_name("flash_attention_bwd.cu")
# the source's kernels, by the id that its `flash_attention_path` returns
PATHS = ("f32", "mma_sync", "wgmma")
# the backward source's kernel families, by the id that `flash_attention_bwd_path` returns
BWD_PATHS = ("fma", "wgmma")
# what the C entry returns besides a cudaError_t
_ERRORS = {
    -1: "this (dtype, head dim) is not built",
    -2: "libcuda has no cuTensorMapEncodeTiled",
    -3: "a TMA tensor map could not be encoded for these pointers and strides",
}


def kernel_path(dtype: torch.dtype, dqk: int, dv: Optional[int] = None) -> str:
    """The kernel that takes ``(dtype, dqk, dv)`` (``dv`` defaults to
    ``dqk``): ``"wgmma"`` (bf16, d 64, 80 and 128, and (192, 128)),
    ``"mma_sync"`` (bf16, d 16) or ``"f32"``.  Raises for anything the
    source does not build.  The C entry's ``flash_attention_path_dqk_dv`` is
    the same table."""
    dv = dqk if dv is None else dv
    if dtype not in _DTYPES:
        raise ValueError(f"q, k, v must share float32 or bfloat16, got {dtype}")
    if dqk == dv and dqk not in HEAD_DIMS:
        raise ValueError(f"head dim {dqk} is not built; the kernel takes {HEAD_DIMS}")
    if dqk != dv and (dqk, dv) not in HEAD_DIM_PAIRS:
        raise ValueError(f"head dims (qk {dqk}, v {dv}) are not built; the kernel takes "
                         f"{HEAD_DIMS} and the pairs {HEAD_DIM_PAIRS}")
    if dtype == torch.float32:
        return "f32"
    return "mma_sync" if dqk == 16 else "wgmma"


def kernel_bwd_path(dtype: torch.dtype, dqk: int, dv: Optional[int] = None) -> str:
    """The backward's kernel family for ``(dtype, dqk, dv)``: ``"wgmma"``
    (bf16 at d 16, 64, 80 and 128 and (192, 128)) or ``"fma"`` (float32 at
    every built dim).  Raises, before any build, for what ``kernel_path``
    refuses: the two sources build the same head dims.  The C entry's
    ``flash_attention_bwd_path`` is the same table."""
    kernel_path(dtype, dqk, dv)
    return "fma" if dtype == torch.float32 else "wgmma"


@functools.lru_cache(maxsize=None)
def build(source: Path = _SOURCE):
    """Compile (if needed) and load the kernel's library; returns its entry
    point for one head dim, with the entry for a (dqk, dv) pair as
    ``.dqk_dv`` and the path tables as ``.path`` and ``.path_dqk_dv``."""
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
    if fn.dqk_dv is not None:
        fn.dqk_dv.argtypes = head + [c_int, c_int] + tail  # dqk dv
        fn.dqk_dv.restype = c_int
    for table, n_dims in ((fn.path, 1), (fn.path_dqk_dv, 2)):
        if table is not None:
            table.argtypes = [c_int] * (1 + n_dims)
            table.restype = c_int
    return fn


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
    ``dqk ** -0.5``.  ``dv`` may differ from ``dqk`` only for a built pair
    (``HEAD_DIM_PAIRS``).  The tensors may be strided views (a transposed
    ``(b, s, h, d)`` tensor is taken as it is) as long as the head dim is
    contiguous; ``out``, when given, is written in place.  Any ``sq`` and
    ``sk`` are taken; ``causal`` needs ``sq == sk``.
    """
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
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

    # TMA follows any stride that is a multiple of 16 bytes, but not a zero
    # one (a broadcast head): such a tensor is handed over as a copy too
    q, k, v = (x if rows_aligned(x) and (path != "wgmma" or _no_broadcast(x)) else x.contiguous()
               for x in (q, k, v))
    if out is None:
        out = torch.empty((b, h, sq, dv), dtype=q.dtype, device=q.device)
    elif (out.shape != (b, h, sq, dv) or out.dtype != q.dtype or out.device != q.device
          or not rows_aligned(out)):
        raise ValueError("out must be (b, h, sq, dv) in q's type and device, with aligned rows")
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3]
    )
    fn = build()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            _DTYPES[q.dtype], b, h, kvh, sq, sk)  # fmt: skip
    tail = (strides, d**-0.5, int(causal), torch.cuda.current_stream().cuda_stream)
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
    point, with the path table as ``.path`` and the scratch size as
    ``.scratch_floats``."""
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
    fn.scratch_floats = lib.flash_attention_bwd_scratch_floats
    fn.scratch_floats.argtypes = [c_int] * 3
    fn.scratch_floats.restype = ctypes.c_longlong
    return fn


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
    three device launches (delta, the dk/dv pass, the dq pass) and counts
    one in ``flash_attention_bwd.launches``.
    """
    tensors = (q, k, v, out, lse, dout)
    if not all(x.is_cuda for x in tensors):
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

    # TMA follows any stride that is a multiple of 16 bytes, but not a zero
    # one (a broadcast head, autograd's broadcast dout): such a tensor is
    # handed over as a copy, as the forward does
    q, k, v, out, dout = (x if rows_aligned(x) and (path != "wgmma" or _no_broadcast(x)) else x.contiguous()
                          for x in (q, k, v, out, dout))
    lse = lse.contiguous()
    grads = []
    for given, like, name in ((dq, q, "dq"), (dk, k, "dk"), (dv, v, "dv")):
        if given is None:
            given = torch.empty(like.shape, dtype=like.dtype, device=like.device)
        elif (given.shape != like.shape or given.dtype != like.dtype or given.device != like.device
              or not rows_aligned(given)):
            raise ValueError(f"{name} must have the shape, type and device of its input, with aligned rows")
        grads.append(given)
    fn = build_bwd()
    scratch = torch.empty(fn.scratch_floats(b, h, sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(*(st for x in (q, k, v, out, dout, *grads) for st in x.stride()[:3]))
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                 *(x.data_ptr() for x in grads), scratch.data_ptr(), _DTYPES[q.dtype], b, h, kvh, sq, sk, d, d_v,
                 strides, d**-0.5, int(causal), torch.cuda.current_stream().cuda_stream)  # fmt: skip
    if err != 0:
        why = _ERRORS.get(err, f"CUDA error {err}")
        raise RuntimeError(f"flash_attention_bwd ({path} kernels): launch failed: {why}")
    flash_attention_bwd.launches += 1
    return tuple(grads)


flash_attention_bwd.launches = 0


def _no_broadcast(x: torch.Tensor) -> bool:
    return all(st != 0 or n == 1 for n, st in zip(x.shape, x.stride()))
