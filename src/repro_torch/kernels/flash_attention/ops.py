"""Flash attention in the models' ``(b, s, h, d)`` layout, with its backward.

Counterpart of ``repro/kernels/flash_attention/ops.py``.  A CUDA tensor goes
to the Hopper kernel (``kernel.flash_attention_fwd``) or the call raises;
there is no fallback on the card.  A tensor that lies on the CPU takes the
kernel's plain version, ``ref.attention_ref``, whose autograd is PyTorch's
own.  The kernel reads strided views, so neither direction of the layout
change copies anything.

On the card the kernel sits in an autograd Function.  Its forward saves
``q``, ``k``, ``v``, ``out`` and the kernel's ``lse``; its backward is the
hand-written CUDA backward, ``kernel.flash_attention_bwd``, on the same
strided views.  The JAX package has no Pallas backward to port (its
``flash_core._bwd`` is plain JAX, and the Pallas ``ops.py`` promises a
``custom_vjp`` it does not contain): the kernel computes that ``_bwd``.
``attention_bwd`` below is its plain version (``flash_attention_bwd`` of
``models/layers/flash_core.py`` after a reshape), which the CPU tests and
the card's checks hold the kernel to; nothing on the card's main path calls
it.

The launches are counted in ``flash_attention_fwd.launches`` and
``flash_attention_bwd.launches``; a forward recomputed under activation
checkpointing launches the forward again.
"""

from __future__ import annotations

import torch

from repro_torch.compat import on_card
from repro_torch.models.layers.flash_core import flash_attention_bwd
from .kernel import flash_attention_bwd as kernel_bwd
from .kernel import flash_attention_fwd
from .ref import attention_ref

__all__ = ["attention_bwd", "flash_attention"]


def flash_attention(
    q: torch.Tensor,  # (b, s, h, dqk)
    k: torch.Tensor,  # (b, s, kvh, dqk)
    v: torch.Tensor,  # (b, s, kvh, dv)
    *,
    causal: bool = True,
) -> torch.Tensor:
    """Returns ``(b, s, h, dv)`` in ``q.dtype``; the scores are scaled by ``dqk ** -0.5``."""
    if on_card(q):
        return _FlashAttention.apply(q, k, v, causal)
    return attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=causal).transpose(1, 2)


class _FlashAttention(torch.autograd.Function):
    """K1's forward and backward kernels, in the ``(b, s, h, d)`` layout."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out = torch.empty(q.shape[:3] + v.shape[3:], dtype=q.dtype, device=q.device)
        _, lse = flash_attention_fwd(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                     causal=causal, out=out.transpose(1, 2))  # fmt: skip
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        grads = [torch.empty(x.shape, dtype=x.dtype, device=x.device) for x in (q, k, v)]
        kernel_bwd(*(x.transpose(1, 2) for x in (q, k, v, out)), lse, dout.transpose(1, 2), causal=ctx.causal,
                   **{name: g.transpose(1, 2) for name, g in zip(("dq", "dk", "dv"), grads)})  # fmt: skip
        return (*grads, None)


def attention_bwd(q, k, v, out, lse, dout, *, causal=True):
    """``(dq, dk, dv)`` in the layouts and types of ``q``, ``k``, ``v``, from
    the kernel's ``out`` ``(b, s, h, dv)`` and ``lse`` ``(b, h, s)``:
    ``flash_attention_bwd`` after a reshape.  q head i reads kv head i // g,
    in the kernel as in the core's ``(kvh, g)`` split."""
    b, s, h, dqk = q.shape
    kvh = k.shape[2]
    g = h // kvh
    dq, dk, dv = flash_attention_bwd(
        q.reshape(b, s, kvh, g, dqk), k, v, out.reshape(b, s, kvh, g, -1),
        lse.reshape(b, kvh, g, s), dout.reshape(b, s, kvh, g, -1), causal,
    )  # fmt: skip
    return dq.reshape(b, s, h, dqk), dk, dv
