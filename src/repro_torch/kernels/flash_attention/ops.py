"""Flash attention in the models' ``(b, s, h, d)`` layout.

Counterpart of ``repro/kernels/flash_attention/ops.py``.  A CUDA tensor goes
to the Hopper kernel (``kernel.flash_attention_fwd``) or the call raises;
there is no fallback on the card.  A tensor that lies on the CPU takes the
kernel's plain version, ``ref.attention_ref``.  The kernel reads strided
views, so neither direction of the layout change copies anything.

The kernel's launches are counted in ``flash_attention_fwd.launches``.
"""

from __future__ import annotations

import torch

from .kernel import flash_attention_fwd
from .ref import attention_ref

__all__ = ["flash_attention"]


def flash_attention(
    q: torch.Tensor,  # (b, s, h, dqk)
    k: torch.Tensor,  # (b, s, kvh, dqk)
    v: torch.Tensor,  # (b, s, kvh, dv)
    *,
    causal: bool = True,
) -> torch.Tensor:
    """Returns ``(b, s, h, dv)`` in ``q.dtype``; the scores are scaled by ``dqk ** -0.5``."""
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if q.is_cuda:
        out = torch.empty(q.shape[:3] + v.shape[3:], dtype=q.dtype, device=q.device)
        flash_attention_fwd(qt, kt, vt, causal=causal, out=out.transpose(1, 2))
        return out
    return attention_ref(qt, kt, vt, causal=causal).transpose(1, 2)
