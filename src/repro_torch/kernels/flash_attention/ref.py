"""Plain PyTorch version of the flash-attention kernel (head-major layout).

Counterpart of ``repro/kernels/flash_attention/ref.py``.  The CPU tests use
it, the card check holds the CUDA kernel against it, and ``ops`` takes it for
tensors that lie on the CPU.  Nothing on the card's main path calls it.
"""

from __future__ import annotations

import torch

__all__ = ["attention_ref", "attention_ref_lse"]


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.reshape(b, kvh, g, sq, d)
    # f32 accumulation of exact products, as `preferred_element_type=float32`
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), k.float()) * (d**-0.5)
    if causal:
        mask = torch.tril(torch.ones(sq, sk, dtype=torch.bool, device=q.device), diagonal=sk - sq)
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    return s


def attention_ref(
    q: torch.Tensor,  # (b, h, sq, dqk)
    k: torch.Tensor,  # (b, kvh, sk, dqk)
    v: torch.Tensor,  # (b, kvh, sk, dv)
    causal: bool = True,
) -> torch.Tensor:
    """``(b, h, sq, dv)``; the scores are scaled by ``dqk ** -0.5``."""
    b, h, sq, _ = q.shape
    p = torch.softmax(_scores(q, k, causal), dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype), v)
    return out.reshape(b, h, sq, v.shape[-1])


def attention_ref_lse(q: torch.Tensor, k: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """Log-sum-exp of the scaled, masked scores: (b, h, sq) float32."""
    b, h, sq, _ = q.shape
    return torch.logsumexp(_scores(q, k, causal), dim=-1).reshape(b, h, sq)
