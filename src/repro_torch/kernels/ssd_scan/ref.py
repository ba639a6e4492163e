"""Plain PyTorch version of the SSD scan kernel (single B/C group).

Counterpart of ``repro/kernels/ssd_scan/ref.py``: a call into the port's own
``ssd_chunked``.  Unlike the JAX oracle it also returns the final state and
takes an initial one, as the kernel does.  The CPU tests use it, the card
check holds the CUDA kernel against it, and ``ops`` takes it for tensors
that lie on the CPU.  Nothing on the card's main path calls it.

``ssd_scan_passing_ref`` is the same function in the order the bf16 kernel
computes it (its three phases: each chunk's own part, the state handed on
between segments of chunks, then the outputs), so that the CPU tests can hold
that decomposition against the JAX package, which the kernel itself cannot
be on a machine without a card.  Nothing on the main path calls it either.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models.layers.ssm import ssd_chunked

__all__ = ["ssd_scan_passing_ref", "ssd_scan_ref"]


def ssd_scan_ref(
    x: torch.Tensor,  # (b, s, h, p)
    dt: torch.Tensor,  # (b, s, h)
    A: torch.Tensor,  # (h,)
    B: torch.Tensor,  # (b, s, n) single group
    C: torch.Tensor,  # (b, s, n)
    chunk: int = 256,
    initial_state: Optional[torch.Tensor] = None,  # (b, h, p, n)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(y (b, s, h, p) in x.dtype, final_state (b, h, p, n) float32)``."""
    return ssd_chunked(x, dt, A, B[:, :, None, :], C[:, :, None, :], chunk, initial_state)


def ssd_scan_passing_ref(
    x: torch.Tensor,  # (b, s, h, p)
    dt: torch.Tensor,  # (b, s, h)
    A: torch.Tensor,  # (h,)
    B: torch.Tensor,  # (b, s, n) single group
    C: torch.Tensor,  # (b, s, n)
    chunk: int,
    split: int,
    initial_state: Optional[torch.Tensor] = None,  # (b, h, p, n)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scan in three phases, in float32: returns ``(y (b, s, h, p) in
    x.dtype, final_state (b, h, p, n) float32)``.

    1. Per chunk, what does not depend on the carried state: y_diag, the
       chunk's own end state from zero, and its decay (the sum of dt A).
    2. The hand-on, over segments of ``split`` chunks (a CTA's tiles in the
       kernel): each segment's own end state from zero, then the state
       entering segment r as the kernel's phase 2 forms it, from the own
       states of every segment before it and the initial state.
    3. Within each segment, the state entering each chunk from the state
       entering the segment, and y = y_diag + exp(cum_i) C_i state^T,
       rounded to ``x.dtype`` once.
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    assert s % chunk == 0, f"seq {s} % chunk {chunk} != 0"
    nc = s // chunk
    f32 = torch.float32
    xf = x.to(f32).reshape(b, nc, chunk, h, p)
    dtf = dt.to(f32).reshape(b, nc, chunk, h)
    Bf = B.to(f32).reshape(b, nc, chunk, n)
    Cf = C.to(f32).reshape(b, nc, chunk, n)

    # ---- phase 1 ------------------------------------------------------------
    cum = torch.cumsum(dtf * A.to(f32), dim=2)  # (b, nc, Q, h)
    decay = cum[:, :, -1]  # (b, nc, h)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (b, nc, Q_i, Q_j, h)
    lower = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))[..., None]
    L = torch.exp(seg.masked_fill(~lower, -torch.inf))
    scores = torch.einsum("bcin,bcjn->bcij", Cf, Bf)
    y_diag = torch.einsum("bcij,bcijh,bcjh,bcjhp->bcihp", scores, L, dtf, xf)
    w = dtf * torch.exp(decay[:, :, None] - cum)  # (b, nc, Q, h)
    own = torch.einsum("bcjhp,bcjh,bcjn->bchpn", xf, w, Bf)  # each chunk's end state from zero

    # ---- phase 2 ------------------------------------------------------------
    starts = list(range(0, nc, split))
    seg_own, seg_decay = [], []
    for c0 in starts:
        st = torch.zeros((b, h, p, n), dtype=f32, device=x.device)
        lam = torch.zeros((b, h), dtype=f32, device=x.device)
        for c in range(c0, min(c0 + split, nc)):
            st = st * torch.exp(decay[:, c])[..., None, None] + own[:, c]
            lam = lam + decay[:, c]
        seg_own.append(st)
        seg_decay.append(lam)
    init = torch.zeros((b, h, p, n), dtype=f32, device=x.device) if initial_state is None else initial_state.to(f32)
    entering = []
    for r in range(len(starts)):
        st = torch.zeros((b, h, p, n), dtype=f32, device=x.device)
        coef = torch.ones((b, h), dtype=f32, device=x.device)
        for q in range(r - 1, -1, -1):
            st = st + coef[..., None, None] * seg_own[q]
            coef = coef * torch.exp(seg_decay[q])
        entering.append(st + coef[..., None, None] * init)

    # ---- phase 3 ------------------------------------------------------------
    prev = []
    for r, c0 in enumerate(starts):
        st = entering[r]
        for c in range(c0, min(c0 + split, nc)):
            prev.append(st)  # the state entering chunk c
            st = st * torch.exp(decay[:, c])[..., None, None] + own[:, c]
    final_state = st
    prev_states = torch.stack(prev, dim=1)  # (b, nc, h, p, n)
    y_off = torch.einsum("bcin,bchpn->bcihp", Cf, prev_states) * torch.exp(cum)[..., None]
    y = (y_diag + y_off).reshape(b, s, h, p)
    return y.to(x.dtype), final_state
