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

K3 takes one of two forms, chosen from the shapes alone by
:func:`barrier_form`: one thread-block cluster where it holds the parties
and their rows (no workspace), else the cooperative dissemination barrier.

The launch path costs about one eager PyTorch op: the caller's stream is
read once a call as a raw handle, the C entry makes the tensor's device
current only where it is not already (no device context here), and the
workspace of the dissemination form and of K4 is looked up once, by
(kind, device index, raw stream).  That workspace holds the flag words and
published rows, allocated with ``torch.zeros`` and reused: the flags carry
an epoch that goes up by one every launch, so a flag of an earlier launch
never reads as set.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Dict, Tuple

import torch

from .._build import load_library

__all__ = [
    "SPIN_LIMIT_CYCLES",
    "barrier_form",
    "build",
    "cluster_floor_ms",
    "cluster_limit",
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
    out = ctypes.POINTER(i32)
    signatures = {
        "scu_barrier_cluster": [ptr, ptr, i32, i32, i32, ptr],  # arrive out n m device stream
        "scu_barrier": [ptr, ptr, ptr, ptr, i32, i32, u32, i64, i32, ptr],  # arrive out words flags n m epoch limit device stream
        "scu_notifier": [ptr, ptr, ptr, ptr, i32, i32, i32, u32, i64, i32, ptr],  # ... target epoch limit device stream
        "scu_self_signal": [ptr, ptr, i64, i32, ptr],  # x out total device stream
        "scu_barrier_max_parties": [i32, out],  # device, parties
        "scu_barrier_cluster_limit": [i32, out, out],  # device, parties, row cap
        "scu_pingpong": [ptr, i32, i64, i32, ptr],  # flags iters limit device stream
        "scu_empty": [i32, i32, ptr],  # n device stream
        "scu_cluster_floor": [i32, i32, i32, ptr],  # n syncs device stream
    }  # fmt: skip
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


# The caller's current stream on a device, as a raw handle.  The private
# ``torch._C._cuda_getCurrentRawStream(index)`` returns the handle that
# ``torch.cuda.current_stream(index).cuda_stream`` does, without building a
# ``Stream`` object a call.  A CPU-only build of torch lacks it; no kernel
# launches there.
_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


@functools.lru_cache(maxsize=None)
def max_parties(device_index: int) -> int:
    """Largest party count K3's dissemination form takes on this card:
    one-warp CTAs resident at once."""
    lib = build()
    out = ctypes.c_int(0)
    _check(lib, "scu_barrier_max_parties", lib.scu_barrier_max_parties(device_index, ctypes.byref(out)))
    return out.value


@functools.lru_cache(maxsize=None)
def cluster_limit(device_index: int) -> Tuple[int, int]:
    """``(parties, row cap)`` of K3's cluster form on this card: at most 16
    parties where the card allows a non-portable cluster of them, else the
    portable 8; at most 12,288 words a party (48 KB of shared memory)."""
    lib = build()
    parties, row_cap = ctypes.c_int(0), ctypes.c_int(0)
    err = lib.scu_barrier_cluster_limit(device_index, ctypes.byref(parties), ctypes.byref(row_cap))
    _check(lib, "scu_barrier_cluster_limit", err)
    return parties.value, row_cap.value


def barrier_form(n: int, m: int, cluster_parties: int, row_cap: int) -> str:
    """K3's form for ``n`` parties of ``m`` words each: ``"cluster"`` where one
    thread-block cluster holds them (``n <= cluster_parties`` and
    ``m <= row_cap``), else ``"dissemination"``."""
    if n < 1 or m < 1:
        raise ValueError(f"barrier_form: needs at least one party and one word, got n={n}, m={m}")
    return "cluster" if n <= cluster_parties and m <= row_cap else "dissemination"


class _Workspace:
    """Flag words and published rows of one kernel on one (device, stream)."""

    def __init__(self, device_index: int) -> None:
        self.device_index = device_index
        self.flags = torch.empty(0, dtype=torch.int32)
        self.words = torch.empty(0, dtype=torch.float32)
        self.epoch = 0

    def take(self, n_flags: int, n_words: int) -> Tuple[torch.Tensor, torch.Tensor, int]:
        if self.flags.numel() < n_flags:
            self.flags = torch.zeros(max(n_flags, 64), dtype=torch.int32, device=self.device_index)
            self.epoch = 0  # zeroed flags: any epoch from 1 on is fresh
        if self.words.numel() < n_words:
            self.words = torch.zeros(max(n_words, 64), dtype=torch.float32, device=self.device_index)
        self.epoch += 1
        if self.epoch >= 2**32:  # the u32 epoch wraps: start again from zeroed flags
            self.flags.zero_()
            self.epoch = 1
        return self.flags, self.words, self.epoch


_WORKSPACES: Dict[Tuple[str, int, int], _Workspace] = {}


def _workspace(kind: str, device_index: int, stream: int) -> _Workspace:
    key = (kind, device_index, stream)
    ws = _WORKSPACES.get(key)
    if ws is None:
        ws = _WORKSPACES[key] = _Workspace(device_index)
    return ws


def _party_rows(t: torch.Tensor, what: str) -> torch.Tensor:
    """``(n, *s)`` float32 on the card, contiguous (a copy only where it is not)."""
    if not t.is_cuda:
        raise ValueError(f"{what} launches a CUDA kernel: the tensor must be on the card")
    if t.dtype != torch.float32:
        raise ValueError(f"{what} takes float32, got {t.dtype}")
    if t.dim() < 1 or t.numel() == 0:
        raise ValueError(f"{what} takes (parties, *s) with at least one word a party, got {tuple(t.shape)}")
    return t if t.is_contiguous() else t.contiguous()


def scu_barrier(arrive: torch.Tensor) -> torch.Tensor:
    """K3: every party waits for all; returns ``(n, *s)``, each row the sum of
    the n arrival rows (the count, when every word is 1), the same bits in
    every row."""
    arrive = _party_rows(arrive, "scu_barrier")
    n = arrive.shape[0]
    m = arrive.numel() // n
    index = arrive.get_device()
    stream = _stream(index)
    lib = build()
    if barrier_form(n, m, *cluster_limit(index)) == "cluster":
        out = torch.empty_like(arrive)
        err = lib.scu_barrier_cluster(arrive.data_ptr(), out.data_ptr(), n, m, index, stream)
    else:
        limit = max_parties(index)
        if n > limit:
            raise ValueError(f"scu_barrier: {n} parties do not fit on the card at once (at most {limit})")
        rounds = (n - 1).bit_length()  # ceil(log2 n)
        flags, words, epoch = _workspace("barrier", index, stream).take(max(1, rounds * n), n * m)
        out = torch.empty_like(arrive)
        err = lib.scu_barrier(arrive.data_ptr(), out.data_ptr(), words.data_ptr(), flags.data_ptr(),
                              n, m, epoch, SPIN_LIMIT_CYCLES, index, stream)  # fmt: skip
    _check(lib, "scu_barrier", err)
    scu_barrier.launches += 1
    return out


def scu_notifier(payload: torch.Tensor, target: int) -> torch.Tensor:
    """K4: every party but ``target`` sends its row to ``target``, which gets
    their sum in party order; every other party gets zeros."""
    payload = _party_rows(payload, "scu_notifier")
    n = payload.shape[0]
    m = payload.numel() // n
    if not 0 <= target < n:
        raise ValueError(f"scu_notifier: target {target} is not one of the {n} parties")
    index = payload.get_device()
    stream = _stream(index)
    flags, slots, epoch = _workspace("notifier", index, stream).take(n, n * m)
    out = torch.empty_like(payload)
    lib = build()
    err = lib.scu_notifier(payload.data_ptr(), out.data_ptr(), slots.data_ptr(), flags.data_ptr(),
                           n, m, target, epoch, SPIN_LIMIT_CYCLES, index, stream)  # fmt: skip
    _check(lib, "scu_notifier", err)
    scu_notifier.launches += 1
    return out


def scu_self_signal(x: torch.Tensor) -> torch.Tensor:
    """K5: bulk async copy into shared memory, restful wait on its mbarrier,
    ``buf + 1``; any shape.  A strided ``x``, or one whose start is off the
    16-byte boundary the bulk copy needs, is copied first."""
    if not x.is_cuda:
        raise ValueError("scu_self_signal launches a CUDA kernel: the tensor must be on the card")
    if x.dtype != torch.float32 or x.numel() == 0:
        raise ValueError(f"scu_self_signal takes a non-empty float32 tensor, got {x.dtype} {tuple(x.shape)}")
    if not (x.is_contiguous() and x.data_ptr() % 16 == 0):
        x = x.clone(memory_format=torch.contiguous_format)
    index = x.get_device()
    out = torch.empty_like(x)
    lib = build()
    err = lib.scu_self_signal(x.data_ptr(), out.data_ptr(), x.numel(), index, _stream(index))
    _check(lib, "scu_self_signal", err)
    scu_self_signal.launches += 1
    return out


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
    """One one-way flag hand-off between two SMs, as the dissemination form's
    waits make it: a two-CTA ping-pong of ``iters`` round trips, less an
    empty launch, over ``2 * iters``.  Measurement only: no kernel of the
    path runs."""
    lib = build()
    stream = _stream(device)

    def pingpong():
        flags = torch.zeros(64, dtype=torch.int32, device=device)
        _check(lib, "scu_pingpong", lib.scu_pingpong(flags.data_ptr(), iters, SPIN_LIMIT_CYCLES, device, stream))

    total = _events_ms(pingpong, 3)
    empty = launch_ms(2, device=device)
    return max(total - empty, 0.0) / (2 * iters)


def launch_ms(n: int, iters: int = 1000, device: int = 0) -> float:
    """One cooperative launch of ``n`` empty one-warp CTAs, back to back.
    Measurement only."""
    lib = build()
    stream = _stream(device)
    return _events_ms(lambda: _check(lib, "scu_empty", lib.scu_empty(n, device, stream)), iters)


def cluster_floor_ms(n: int, syncs: int, iters: int = 1000, device: int = 0) -> float:
    """One launch of a cluster of ``n`` one-warp CTAs that meets ``syncs``
    times at the hardware barrier and does nothing else, back to back: the
    cluster form's floor.  Measurement only."""
    cluster_limit(device)  # allows the non-portable size where the card has it
    lib = build()
    stream = _stream(device)
    return _events_ms(lambda: _check(lib, "scu_cluster_floor", lib.scu_cluster_floor(n, syncs, device, stream)), iters)
