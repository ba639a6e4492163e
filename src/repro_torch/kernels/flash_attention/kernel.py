"""Binding of the Hopper flash-attention kernel (forward).

Counterpart of ``repro/kernels/flash_attention/kernel.py``: the Pallas kernel
there becomes ``csrc/flash_attention_fwd.cu`` here, compiled with ``nvcc`` for
``sm_90a`` at first use and called through ``ctypes``.  The note at the top of
the CUDA source says what the kernel computes, what bounds it and why it is
laid out as it is.

``flash_attention_fwd`` takes CUDA tensors only and launches the kernel or
raises.  It counts its launches in ``flash_attention_fwd.launches``.  Which
of the source's three kernels takes a call is ``kernel_path(dtype, d)``:
bf16 at head dims 64 and 128 goes to the Hopper kernel (``wgmma``, TMA,
warp specialisation), bf16 at 16 and 80 to the ``mma.sync`` kernel, f32 to
the full-precision one.  No path falls back to another.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Tuple

import torch

from .._build import load_library, rows_aligned

__all__ = ["HEAD_DIMS", "PATHS", "build", "flash_attention_fwd", "kernel_path"]

HEAD_DIMS = (16, 64, 80, 128)  # the head dims that the CUDA source instantiates
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention_fwd.cu"
# the source's kernels, by the id that its `flash_attention_path` returns
PATHS = ("f32", "mma_sync", "wgmma")
# what the C entry returns besides a cudaError_t
_ERRORS = {
    -1: "this (dtype, head dim) is not built",
    -2: "libcuda has no cuTensorMapEncodeTiled",
    -3: "a TMA tensor map could not be encoded for these pointers and strides",
}


def kernel_path(dtype: torch.dtype, d: int) -> str:
    """The kernel that takes ``(dtype, d)``: ``"wgmma"`` (bf16, d 64 and 128),
    ``"mma_sync"`` (bf16, d 16 and 80) or ``"f32"``.  Raises for anything
    the source does not build.  The C entry's ``flash_attention_path`` is the
    same table."""
    if dtype not in _DTYPES:
        raise ValueError(f"q, k, v must share float32 or bfloat16, got {dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} is not built; the kernel takes {HEAD_DIMS}")
    if dtype == torch.float32:
        return "f32"
    return "wgmma" if d in (64, 128) else "mma_sync"


@functools.lru_cache(maxsize=None)
def build(source: Path = _SOURCE):
    """Compile (if needed) and load the kernel's library; returns its entry point."""
    lib = load_library("flash_attention_fwd", [source])
    fn = lib.flash_attention_fwd
    ptr = ctypes.c_void_p
    fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ctypes.c_int,  # q k v o lse dtype
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,  # b h kvh
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,  # sq sk d
                   ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,  # strides scale
                   ctypes.c_int, ptr]  # causal stream
    fn.restype = ctypes.c_int
    # the path table; an earlier source (benchmarked with --other) may not export it
    fn.path = getattr(lib, "flash_attention_path", None)
    if fn.path is not None:
        fn.path.argtypes = [ctypes.c_int, ctypes.c_int]
        fn.path.restype = ctypes.c_int
    return fn


def flash_attention_fwd(
    q: torch.Tensor,  # (b, h, sq, d)
    k: torch.Tensor,  # (b, kvh, sk, d)
    v: torch.Tensor,  # (b, kvh, sk, d)
    *,
    causal: bool = True,
    out: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Head-major flash attention on the card.  Returns ``(out, lse)``.

    ``out`` is ``(b, h, sq, d)`` in ``q.dtype``; ``lse`` is ``(b, h, sq)``
    float32, ``m + log(max(l, 1e-30))``.  The tensors may be strided views
    (a transposed ``(b, s, h, d)`` tensor is taken as it is) as long as the
    head dim is contiguous; ``out``, when given, is written in place.
    Any ``sq`` and ``sk`` are taken; ``causal`` needs ``sq == sk``.
    """
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention_fwd launches a CUDA kernel: the tensors must be on the card")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"bad shapes q={tuple(q.shape)} k={tuple(k.shape)} v={tuple(v.shape)}")
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or kvh == 0 or h % kvh != 0:
        raise ValueError(f"bad shapes q={tuple(q.shape)} k={tuple(k.shape)}")
    if min(b, h, sq, sk) == 0:
        raise ValueError("empty attention problem")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share float32 or bfloat16, got {q.dtype} {k.dtype} {v.dtype}")
    path = kernel_path(q.dtype, d)
    if causal and sq != sk:
        raise ValueError(f"causal attention needs sq == sk, got {sq} and {sk}")

    # TMA follows any stride that is a multiple of 16 bytes, but not a zero
    # one (a broadcast head): such a tensor is handed over as a copy too
    q, k, v = (x if rows_aligned(x) and (path != "wgmma" or _no_broadcast(x)) else x.contiguous()
               for x in (q, k, v))
    if out is None:
        out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    elif out.shape != q.shape or out.dtype != q.dtype or out.device != q.device or not rows_aligned(out):
        raise ValueError("out must match q in shape, type and device, with aligned rows")
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3]
    )
    fn = build()
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                 _DTYPES[q.dtype], b, h, kvh, sq, sk, d, strides, d**-0.5,
                 int(causal), torch.cuda.current_stream().cuda_stream)  # fmt: skip
    if err != 0:
        why = _ERRORS.get(err, f"CUDA error {err}")
        raise RuntimeError(f"flash_attention_fwd ({path} kernel): launch failed: {why}")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def _no_broadcast(x: torch.Tensor) -> bool:
    return all(st != 0 or n == 1 for n, st in zip(x.shape, x.stride()))
