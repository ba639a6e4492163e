"""Binding of the Hopper SSD-scan kernel (forward).

Counterpart of ``repro/kernels/ssd_scan/kernel.py``: the Pallas kernel there
becomes ``csrc/ssd_scan_fwd.cu`` here, compiled with ``nvcc`` for ``sm_90a``
at first use and called through ``ctypes``.  The note at the top of the CUDA
source says what the kernel computes, where it rounds, what bounds it and
why it is laid out as it is.

``ssd_scan_fwd`` takes CUDA tensors only and launches the kernel or raises.
It counts its launches in ``ssd_scan_fwd.launches``.  The bf16 kernel walks
the sequence in tiles of ``TILE`` tokens, each (batch, head) a thread-block
cluster of k CTAs that hand only the state on; k is ``scan_form``'s, a pure
function of the shapes and of the card's cluster limit (``cluster_limit``):
one CTA for mamba2's 4-sequence prefill, two for a single sequence.
Float32 takes the full-precision kernel, one block per (batch, head).  No
form falls back to another.  The launch is a PyTorch custom op
(``torch.ops.repro_torch.ssd_scan_fwd``, CUDA only) with a fake version for
the dry run (the same checks and allocations; no build, no form, no launch)
and a flop formula (``kernels/costs.py`` ``ssd_flops``).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.compat import on_card

from .._build import load_library, rows_aligned
from ..costs import ssd_flops

__all__ = ["MAX_CHUNK", "SHAPES", "TILE", "ScanForm", "build", "cluster_limit", "scan_form", "ssd_scan_fwd"]

# (head dim p, state dim n) pairs that the CUDA source instantiates:
# mamba2-1.3b (64, 128), jamba (64, 16), the smoke configs (16, 16) and the
# shapes of tests/test_kernels.py
SHAPES = ((16, 16), (32, 16), (64, 16), (64, 32), (64, 128))
MAX_CHUNK = 256  # the float32 kernel keeps a chunk's rows in shared memory
TILE = 64  # the bf16 kernel's own chunk: y does not depend on the chunk length
MAX_CLUSTER = 8  # the portable cluster size
# scan_form's rule: the fewest CTAs a (batch, head) that give the card at
# least TARGET_CTAS CTAs in all, about one on each of an H100's 132 SMs (two
# fit on one), and at most MAX_CLUSTER.  Measured on the H100 (PERF.md §6,
# `scripts/bench_ssd_scan.py --forms`): at b h = 256 one CTA a (batch, head)
# beats two by 1.35x, at b h = 64 two beat one by 1.45x.
TARGET_CTAS = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan_fwd.cu"


class ScanForm(NamedTuple):
    """How the bf16 kernel takes a scan: ``cluster`` CTAs a (batch, head),
    the longest of which walks ``tiles`` tiles of ``TILE`` tokens."""

    cluster: int
    tiles: int

    @property
    def name(self) -> str:
        return "sequential" if self.cluster == 1 else f"cluster{self.cluster}"


def scan_form(b: int, h: int, s: int, chunk: int, p: int, n: int, cluster_limit: int) -> ScanForm:
    """The bf16 kernel's form for a scan of ``b`` sequences of ``s`` tokens and
    ``h`` heads of ``(p, n)``, on a card whose clusters hold at most
    ``cluster_limit`` of its CTAs.  A pure function of these numbers.

    k, the CTAs a (batch, head), is the smallest power of two that gives the
    card ``TARGET_CTAS`` CTAs in all (``b h k``), at most ``MAX_CLUSTER``,
    ``cluster_limit`` and the ``ceil(s / TILE)`` tiles.  k = 1 is the
    sequential form (one CTA walks all the tiles); k > 1 runs phase 1 over
    chunks in parallel and hands only the state on.  ``chunk`` is checked as
    the reference checks it but does not change the form: the kernel's chunk
    is ``TILE``."""
    if (p, n) not in SHAPES:
        raise ValueError(f"(head dim, state dim) = {(p, n)} is not built; the kernel takes {SHAPES}")
    if min(b, h, s) < 1:
        raise ValueError(f"empty scan: b={b} h={h} s={s}")
    if not (1 <= chunk <= MAX_CHUNK and s % chunk == 0):
        raise ValueError(f"chunk {chunk} must divide the sequence ({s}) and be at most {MAX_CHUNK}")
    if cluster_limit < 1:
        raise ValueError(f"cluster_limit must be at least 1, got {cluster_limit}")
    tiles = -(-s // TILE)
    k = 1
    while 2 * k <= min(cluster_limit, tiles, MAX_CLUSTER) and b * h * k < TARGET_CTAS:
        k *= 2
    return ScanForm(k, -(-tiles // k))


@functools.lru_cache(maxsize=None)
def build(source: Path = _SOURCE):
    """Compile (if needed) and load the kernel's library; returns its entry point."""
    lib = load_library("ssd_scan_fwd", [source])
    fn = lib.ssd_scan_fwd
    ptr = ctypes.c_void_p
    fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,  # x dt A B C init y final
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # dtype b s h
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # p n chunk cluster
                   ctypes.POINTER(ctypes.c_longlong), ptr]  # strides stream
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def cluster_limit(p: int, n: int, device_index: int) -> int:
    """The largest cluster of the bf16 kernel's CTAs at ``(p, n)`` that the
    card can hold: the portable 8, or 1 where it has no cluster launch."""
    lib = load_library("ssd_scan_fwd", [_SOURCE])
    fn = lib.ssd_scan_cluster_limit
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = fn(p, n, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"ssd_scan_cluster_limit({p}, {n}) failed with CUDA error {err}")
    return out.value


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
    The bf16 kernel takes the form ``scan_form`` gives these shapes.  The
    launch is the custom op ``torch.ops.repro_torch.ssd_scan_fwd``, whose fake
    version runs the same checks and allocations, asks the library nothing
    and launches nothing.
    """
    if not all(on_card(t) for t in (x, dt, A, B, C) + (() if initial_state is None else (initial_state,))):
        raise ValueError("ssd_scan_fwd launches a CUDA kernel: the tensors must be on the card")
    return torch.ops.repro_torch.ssd_scan_fwd(x, dt, A, B, C, chunk, initial_state)


@torch.library.custom_op("repro_torch::ssd_scan_fwd", mutates_args=(), device_types="cuda")
def _scan_op(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor, C: torch.Tensor, chunk: int,
             initial_state: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    return _scan(x, dt, A, B, C, chunk, initial_state, None)


@_scan_op.register_fake
def _(x, dt, A, B, C, chunk, initial_state):
    return _scan(x, dt, A, B, C, chunk, initial_state, None, launch=False)


@register_flop_formula(torch.ops.repro_torch.ssd_scan_fwd)
def _(x_shape, dt_shape, A_shape, B_shape, C_shape, chunk, *args, **kwargs) -> int:
    b, s, h, p = x_shape
    return ssd_flops(b, s, h, p, B_shape[2], chunk)


def _scan(x, dt, A, B, C, chunk, initial_state, cluster, launch=True):
    """``ssd_scan_fwd`` in the bf16 kernel's form of ``cluster`` CTAs a
    (batch, head) (1 to ``min(MAX_CLUSTER, ceil(s / TILE))``), or in
    ``scan_form``'s where it is None.  A test or a benchmark holds one form
    through it; nothing on the serving path names a form.  Without
    ``launch`` (the fake op) it checks and allocates what the launch would,
    and picks no form: ``cluster_limit`` asks the library."""
    tensors = (x, dt, A, B, C) + (() if initial_state is None else (initial_state,))
    if not all(on_card(t) for t in tensors):
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
    if x.dtype == torch.float32:
        if cluster not in (None, 1):
            raise ValueError(f"the float32 kernel takes one block per (batch, head), not a cluster of {cluster}")
        cluster = 1
    elif cluster is None:
        if launch:
            cluster = scan_form(b, h, s, chunk, p, n, cluster_limit(p, n, x.device.index)).cluster
    elif not 1 <= cluster <= min(MAX_CLUSTER, -(-s // TILE)):
        raise ValueError(f"cluster {cluster} must be between 1 and min({MAX_CLUSTER}, ceil(s / {TILE}))")

    x, B, C = (t if rows_aligned(t) else t.contiguous() for t in (x, B, C))
    dt = dt.float()
    A = A.float().contiguous()
    init = None if initial_state is None else initial_state.float().contiguous()
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    final_state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    if not launch:
        return y, final_state
    strides = (ctypes.c_longlong * 13)(
        *x.stride()[:3], *dt.stride(), *B.stride()[:2], *C.stride()[:2], *y.stride()[:3]
    )
    fn = build()
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
                 None if init is None else init.data_ptr(), y.data_ptr(), final_state.data_ptr(),
                 _DTYPES[x.dtype], b, s, h, p, n, chunk, cluster, strides,
                 torch.cuda.current_stream().cuda_stream)  # fmt: skip
    if err != 0:
        raise RuntimeError(f"ssd_scan_fwd: launch failed with CUDA error {err}")
    ssd_scan_fwd.launches += 1
    return y, final_state


ssd_scan_fwd.launches = 0
