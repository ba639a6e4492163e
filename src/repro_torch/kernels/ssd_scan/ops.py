"""The SSD scan in the layers' layout: B and C as ``(b, s, g, n)``.

Counterpart of ``repro/kernels/ssd_scan/ops.py``.  A CUDA tensor goes to the
Hopper kernel (``kernel.ssd_scan_fwd``) or the call raises; there is no
fallback on the card.  A tensor that lies on the CPU takes the kernel's
plain version, ``ref.ssd_scan_ref``, whose autograd is PyTorch's own.  Both
return the final state as well.

On the card the kernel sits in an autograd Function.  Its forward saves the
inputs and ``initial_state``; its backward recomputes the scan through the
port's ``ssd_chunked`` under ``torch.enable_grad()`` and takes
``torch.autograd.grad`` of it, for ``x``, ``dt``, ``A``, ``B``, ``C`` and
``initial_state``, from the gradients of ``y`` and of the final state.  That
mirrors the reference, which has no Pallas backward and trains through JAX's
autodiff of ``ssd_chunked`` (``repro/models/layers/ssm.py``).

Only one B/C group is taken (``g == 1``), on either device: the Pallas
kernel is single-group too, and both SSD archs of the registry
(``mamba2-1.3b``, ``jamba-v0.1-52b``) have ``n_groups=1``.

The kernel's launches are counted in ``ssd_scan_fwd.launches``; a forward
recomputed under activation checkpointing launches it again.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.compat import on_card
from repro_torch.models.layers.ssm import ssd_chunked
from .kernel import ssd_scan_fwd
from .ref import ssd_scan_ref

__all__ = ["ssd_scan", "ssd_scan_bwd"]


def ssd_scan(
    x: torch.Tensor,  # (b, s, h, p)
    dt: torch.Tensor,  # (b, s, h)
    A: torch.Tensor,  # (h,)
    B: torch.Tensor,  # (b, s, g, n)
    C: torch.Tensor,  # (b, s, g, n)
    *,
    chunk: int,
    initial_state: Optional[torch.Tensor] = None,  # (b, h, p, n)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(y (b, s, h, p) in x.dtype, final_state (b, h, p, n) float32)``."""
    if B.dim() != 4 or B.shape[2] != 1 or C.shape != B.shape:
        raise ValueError(
            f"ssd_scan takes one B/C group, (b, s, 1, n), got B {tuple(B.shape)} C {tuple(C.shape)}: "
            "the kernel (like the Pallas one) is single-group, and so are both SSD archs"
        )
    B, C = B[:, :, 0], C[:, :, 0]
    if on_card(x):
        return _SSDScan.apply(x, dt, A, B, C, initial_state, chunk)
    return ssd_scan_ref(x, dt, A, B, C, chunk=chunk, initial_state=initial_state)


class _SSDScan(torch.autograd.Function):
    """K2's forward; the backward differentiates ``ssd_chunked`` at the same inputs."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, initial_state, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, B, C, initial_state)
        ctx.chunk = chunk
        return ssd_scan_fwd(x, dt, A, B, C, chunk=chunk, initial_state=initial_state)

    @staticmethod
    def backward(ctx, dy, dfinal):
        return (*ssd_scan_bwd(*ctx.saved_tensors, ctx.chunk, dy, dfinal, ctx.needs_input_grad[:6]), None)


def ssd_scan_bwd(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,  # (b, s, n)
    C: torch.Tensor,  # (b, s, n)
    initial_state: Optional[torch.Tensor],
    chunk: int,
    dy: Optional[torch.Tensor],
    dfinal: Optional[torch.Tensor],
    needs: Tuple[bool, ...] = (True,) * 6,
) -> Tuple[Optional[torch.Tensor], ...]:
    """Gradients of ``(x, dt, A, B, C, initial_state)`` (None where not
    ``needs``ed or absent) from those of ``y`` and the final state, either of
    which may be None: ``torch.autograd.grad`` of ``ssd_chunked`` recomputed."""
    saved = (x, dt, A, B, C, initial_state)
    wanted = [i for i, t in enumerate(saved) if t is not None and needs[i]]
    pairs = [(i, grad) for i, grad in enumerate((dy, dfinal)) if grad is not None]
    grads = [None] * 6
    if not wanted or not pairs:
        return tuple(grads)
    inputs = [None if t is None else t.detach().requires_grad_(i in wanted) for i, t in enumerate(saved)]
    x, dt, A, B, C, initial_state = inputs
    with torch.enable_grad():
        outs = ssd_chunked(x, dt, A, B[:, :, None], C[:, :, None], chunk, initial_state)
        got = torch.autograd.grad([outs[i] for i, _ in pairs], [inputs[i] for i in wanted],
                                  [grad for _, grad in pairs], allow_unused=True)  # fmt: skip
    for i, grad in zip(wanted, got):
        grads[i] = grad
    return tuple(grads)
