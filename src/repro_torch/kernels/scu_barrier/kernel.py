"""Binding of the Hopper SCU barrier, notifier and self-signal kernels.

Counterpart of ``repro/kernels/scu_barrier/kernel.py``: its three Pallas
kernels become ``csrc/scu_barrier.cu`` here, one source compiled with
``nvcc`` for ``sm_90a`` at first use and called through ``ctypes``.  The note
at the top of the CUDA source says what each kernel computes, what bounds it
and how it is laid out.

A party is a CTA on one card, and the parties are stacked on the leading
axis of a tensor: ``arrive`` and ``payload`` are ``(n, *s)``.  Each function
takes CUDA float32 tensors only and launches its kernel or raises.  They
count their launches in ``scu_barrier.launches``, ``scu_notifier.launches``
and ``scu_self_signal.launches``.

K3 and K4 keep their flag words and published rows in a workspace per
(kernel, device, stream), allocated here with ``torch.zeros`` and reused:
the flags carry an epoch that goes up by one every launch, so a flag of an
earlier launch never reads as set.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Dict, Tuple

import torch

from .._build import load_library, rows_aligned

__all__ = [
    "SPIN_LIMIT_CYCLES",
    "build",
    "handoff_ms",
    "launch_ms",
    "max_parties",
    "scu_barrier",
    "scu_notifier",
    "scu_self_signal",
]

_SOURCE = Path(__file__).resolve().parent / "csrc" / "scu_barrier.cu"
# a wait longer than this many SM cycles (about 2 s at the H100's 1.98 GHz)
# means a party never arrived: the kernel traps
SPIN_LIMIT_CYCLES = 4_000_000_000


@functools.lru_cache(maxsize=None)
def build(source: Path = _SOURCE) -> ctypes.CDLL:
    """Compile (if needed) and load the kernels' library; returns it."""
    lib = load_library("scu_barrier", [source])
    ptr, i32, u32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_longlong
    signatures = {
        "scu_barrier": [ptr, ptr, ptr, ptr, i32, i32, u32, i64, ptr],  # arrive out words flags n m epoch limit stream
        "scu_notifier": [ptr, ptr, ptr, ptr, i32, i32, i32, u32, i64, ptr],  # ... target epoch limit stream
        "scu_self_signal": [ptr, ptr, i64, ptr],  # x out total stream
        "scu_barrier_max_parties": [ctypes.POINTER(i32)],
        "scu_pingpong": [ptr, i32, i64, ptr],  # flags iters limit stream
        "scu_empty": [i32, ptr],  # n stream
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.scu_error_name.argtypes = [ctypes.c_int]
    lib.scu_error_name.restype = ctypes.c_char_p
    return lib


def _check(lib: ctypes.CDLL, what: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: launch failed with CUDA error {err} "
                           f"({lib.scu_error_name(err).decode()})")


@functools.lru_cache(maxsize=None)
def max_parties(device_index: int) -> int:
    """Largest party count K3 takes on this card: one-warp CTAs resident at once."""
    lib = build()
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        _check(lib, "scu_barrier_max_parties", lib.scu_barrier_max_parties(ctypes.byref(out)))
    return out.value


class _Workspace:
    """Flag words and published rows of one kernel on one (device, stream)."""

    def __init__(self) -> None:
        self.flags = torch.empty(0, dtype=torch.int32)
        self.words = torch.empty(0, dtype=torch.float32)
        self.epoch = 0

    def take(self, device: torch.device, n_flags: int, n_words: int) -> Tuple[torch.Tensor, torch.Tensor, int]:
        if self.flags.numel() < n_flags or self.flags.device != device:
            self.flags = torch.zeros(max(n_flags, 64), dtype=torch.int32, device=device)
            self.epoch = 0  # zeroed flags: any epoch from 1 on is fresh
        if self.words.numel() < n_words or self.words.device != device:
            self.words = torch.zeros(max(n_words, 64), dtype=torch.float32, device=device)
        self.epoch += 1
        if self.epoch >= 2**32:  # the u32 epoch wraps: start again from zeroed flags
            self.flags.zero_()
            self.epoch = 1
        return self.flags, self.words, self.epoch


_WORKSPACES: Dict[Tuple[str, int, int], _Workspace] = {}


def _workspace(kind: str, device: torch.device) -> _Workspace:
    key = (kind, device.index, torch.cuda.current_stream(device).cuda_stream)
    if key not in _WORKSPACES:
        _WORKSPACES[key] = _Workspace()
    return _WORKSPACES[key]


def _as_rows(t: torch.Tensor, what: str) -> torch.Tensor:
    """``(n, *s)`` float32 on the card as a contiguous ``(n, m)`` view or copy."""
    if not t.is_cuda:
        raise ValueError(f"{what} launches a CUDA kernel: the tensor must be on the card")
    if t.dtype != torch.float32:
        raise ValueError(f"{what} takes float32, got {t.dtype}")
    if t.dim() < 1 or t.numel() == 0:
        raise ValueError(f"{what} takes (parties, *s) with at least one word a party, got {tuple(t.shape)}")
    return t.reshape(t.shape[0], -1).contiguous()


def scu_barrier(arrive: torch.Tensor) -> torch.Tensor:
    """K3: every party waits for all; returns ``(n, *s)``, each row the sum of
    the n arrival rows in party order (the count, when every word is 1)."""
    rows = _as_rows(arrive, "scu_barrier")
    n, m = rows.shape
    device = rows.device
    limit = max_parties(device.index)
    if n > limit:
        raise ValueError(f"scu_barrier: {n} parties do not fit on the card at once (at most {limit})")
    rounds = (n - 1).bit_length()  # ceil(log2 n)
    flags, words, epoch = _workspace("barrier", device).take(device, max(1, rounds * n), n * m)
    out = torch.empty_like(rows)
    lib = build()
    with torch.cuda.device(device):
        err = lib.scu_barrier(rows.data_ptr(), out.data_ptr(), words.data_ptr(), flags.data_ptr(),
                              n, m, epoch, SPIN_LIMIT_CYCLES, torch.cuda.current_stream().cuda_stream)  # fmt: skip
    _check(lib, "scu_barrier", err)
    scu_barrier.launches += 1
    return out.reshape(arrive.shape)


def scu_notifier(payload: torch.Tensor, target: int) -> torch.Tensor:
    """K4: every party but ``target`` sends its row to ``target``, which gets
    their sum in party order; every other party gets zeros."""
    rows = _as_rows(payload, "scu_notifier")
    n, m = rows.shape
    if not 0 <= target < n:
        raise ValueError(f"scu_notifier: target {target} is not one of the {n} parties")
    device = rows.device
    flags, slots, epoch = _workspace("notifier", device).take(device, n, n * m)
    out = torch.empty_like(rows)
    lib = build()
    with torch.cuda.device(device):
        err = lib.scu_notifier(rows.data_ptr(), out.data_ptr(), slots.data_ptr(), flags.data_ptr(),
                               n, m, target, epoch, SPIN_LIMIT_CYCLES,
                               torch.cuda.current_stream().cuda_stream)  # fmt: skip
    _check(lib, "scu_notifier", err)
    scu_notifier.launches += 1
    return out.reshape(payload.shape)


def scu_self_signal(x: torch.Tensor) -> torch.Tensor:
    """K5: bulk async copy into shared memory, restful wait on its mbarrier,
    ``buf + 1``; any shape.  An unaligned or strided ``x`` is copied first."""
    if not x.is_cuda:
        raise ValueError("scu_self_signal launches a CUDA kernel: the tensor must be on the card")
    if x.dtype != torch.float32 or x.numel() == 0:
        raise ValueError(f"scu_self_signal takes a non-empty float32 tensor, got {x.dtype} {tuple(x.shape)}")
    flat = x.reshape(-1)
    if not rows_aligned(flat):  # the bulk copy needs a 16-byte-aligned start
        flat = flat.clone()
    out = torch.empty_like(flat)
    lib = build()
    with torch.cuda.device(x.device):
        err = lib.scu_self_signal(flat.data_ptr(), out.data_ptr(), flat.numel(),
                                  torch.cuda.current_stream().cuda_stream)  # fmt: skip
    _check(lib, "scu_self_signal", err)
    scu_self_signal.launches += 1
    return out.reshape(x.shape)


scu_barrier.launches = 0
scu_notifier.launches = 0
scu_self_signal.launches = 0


def _events_ms(launch, iters: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    launch()  # warm-up
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        launch()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def handoff_ms(iters: int = 20_000, device: int = 0) -> float:
    """One one-way flag hand-off between two SMs, as K3's waits make it:
    a two-CTA ping-pong of ``iters`` round trips, less an empty launch, over
    ``2 * iters``.  Measurement only: no kernel of the path runs."""
    lib = build()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream

        def pingpong():
            flags = torch.zeros(64, dtype=torch.int32, device="cuda")
            _check(lib, "scu_pingpong", lib.scu_pingpong(flags.data_ptr(), iters, SPIN_LIMIT_CYCLES, stream))

        total = _events_ms(pingpong, 3)
        empty = launch_ms(2, device=device)
    return max(total - empty, 0.0) / (2 * iters)


def launch_ms(n: int, iters: int = 1000, device: int = 0) -> float:
    """One cooperative launch of ``n`` empty one-warp CTAs, back to back.
    Measurement only."""
    lib = build()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        return _events_ms(lambda: _check(lib, "scu_empty", lib.scu_empty(n, stream)), iters)
