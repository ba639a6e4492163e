"""Binding of the Hopper SSD-scan kernel (forward).

Counterpart of ``repro/kernels/ssd_scan/kernel.py``: the Pallas kernel there
becomes ``csrc/ssd_scan_fwd.cu`` here, compiled with ``nvcc`` for ``sm_90a``
at first use and called through ``ctypes``.  The note at the top of the CUDA
source says what the kernel computes, where it rounds, what bounds it and
why it is laid out as it is.

``ssd_scan_fwd`` takes CUDA tensors only and launches the kernel or raises.
It counts its launches in ``ssd_scan_fwd.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Tuple

import torch

from .._build import load_library, rows_aligned

__all__ = ["MAX_CHUNK", "SHAPES", "build", "ssd_scan_fwd"]

# (head dim p, state dim n) pairs that the CUDA source instantiates:
# mamba2-1.3b (64, 128), jamba (64, 16), the smoke configs (16, 16) and the
# shapes of tests/test_kernels.py
SHAPES = ((16, 16), (32, 16), (64, 16), (64, 32), (64, 128))
MAX_CHUNK = 256  # a chunk's rows of x, B and C sit in shared memory together
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan_fwd.cu"


@functools.lru_cache(maxsize=None)
def build(source: Path = _SOURCE):
    """Compile (if needed) and load the kernel's library; returns its entry point."""
    lib = load_library("ssd_scan_fwd", [source])
    fn = lib.ssd_scan_fwd
    ptr = ctypes.c_void_p
    fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,  # x dt A B C init y final
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # dtype b s h
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,  # p n chunk
                   ctypes.POINTER(ctypes.c_longlong), ptr]  # strides stream
    fn.restype = ctypes.c_int
    return fn


def ssd_scan_fwd(
    x: torch.Tensor,  # (b, s, h, p)
    dt: torch.Tensor,  # (b, s, h) positive
    A: torch.Tensor,  # (h,) negative
    B: torch.Tensor,  # (b, s, n) single group
    C: torch.Tensor,  # (b, s, n)
    *,
    chunk: int = 256,
    initial_state: Optional[torch.Tensor] = None,  # (b, h, p, n)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD scan on the card.  Returns ``(y, final_state)``.

    ``y`` is ``(b, s, h, p)`` in ``x.dtype``; ``final_state`` is ``(b, h, p,
    n)`` float32, the state after the last token.  ``x``, ``B`` and ``C``
    share float32 or bfloat16 and may be strided views with a contiguous last
    dim; ``dt`` and ``A`` are read as float32 (a bfloat16 ``dt`` is widened
    first, exactly).  ``chunk`` divides ``s`` and is at most ``MAX_CHUNK``.
    """
    tensors = (x, dt, A, B, C) + (() if initial_state is None else (initial_state,))
    if not all(t.is_cuda for t in tensors):
        raise ValueError("ssd_scan_fwd launches a CUDA kernel: the tensors must be on the card")
    if x.dim() != 4 or B.dim() != 3:
        raise ValueError(f"bad shapes x={tuple(x.shape)} B={tuple(B.shape)}: x is (b, s, h, p), B (b, s, n)")
    b, s, h, p = x.shape
    n = B.shape[2]
    if dt.shape != (b, s, h) or A.shape != (h,) or B.shape[:2] != (b, s) or C.shape != B.shape:
        raise ValueError(f"bad shapes x={tuple(x.shape)} dt={tuple(dt.shape)} A={tuple(A.shape)} "
                         f"B={tuple(B.shape)} C={tuple(C.shape)}")
    if min(b, s, h) == 0:
        raise ValueError("empty scan")
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(f"x, B, C must share float32 or bfloat16, got {x.dtype} {B.dtype} {C.dtype}")
    if not (dt.is_floating_point() and A.is_floating_point()):
        raise ValueError(f"dt and A must be floating point, got {dt.dtype} {A.dtype}")
    if (p, n) not in SHAPES:
        raise ValueError(f"(head dim, state dim) = {(p, n)} is not built; the kernel takes {SHAPES}")
    if not (1 <= chunk <= MAX_CHUNK and s % chunk == 0):
        raise ValueError(f"chunk {chunk} must divide the sequence ({s}) and be at most {MAX_CHUNK}")
    if initial_state is not None and initial_state.shape != (b, h, p, n):
        raise ValueError(f"initial_state must be {(b, h, p, n)}, got {tuple(initial_state.shape)}")

    x, B, C = (t if rows_aligned(t) else t.contiguous() for t in (x, B, C))
    dt = dt.float()
    A = A.float().contiguous()
    init = None if initial_state is None else initial_state.float().contiguous()
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    final_state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    strides = (ctypes.c_longlong * 13)(
        *x.stride()[:3], *dt.stride(), *B.stride()[:2], *C.stride()[:2], *y.stride()[:3]
    )
    fn = build()
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
                 None if init is None else init.data_ptr(), y.data_ptr(), final_state.data_ptr(),
                 _DTYPES[x.dtype], b, s, h, p, n, chunk, strides,
                 torch.cuda.current_stream().cuda_stream)  # fmt: skip
    if err != 0:
        raise RuntimeError(f"ssd_scan_fwd: launch failed with CUDA error {err}")
    ssd_scan_fwd.launches += 1
    return y, final_state


ssd_scan_fwd.launches = 0
