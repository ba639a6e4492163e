"""Flash attention core in plain PyTorch (forward only), O(S) memory.

Counterpart of ``repro/models/layers/flash_core.py``.  Generic over GQA
grouping and distinct qk/v head dims:

    q: (b, sq, kvh, g, dqk)    k: (b, sk, kvh, dqk)    v: (b, sk, kvh, dv)
    out: (b, sq, kvh, g, dv)

The forward is an online softmax over KV blocks, written as a Python loop
over q and KV blocks where the JAX package scans.  It is the memory-safe
attention of the CPU path for long sequences; on the card the Hopper kernel
of ``repro_torch/kernels/flash_attention`` takes its place.  The
FlashAttention-2 backward of the JAX module comes with the training slice.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["flash_attention_core"]

_NEG = -1e30


def flash_attention_core(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
    q_offset: int = 0,
) -> torch.Tensor:
    out, _ = _fwd_impl(q, k, v, causal, q_chunk, kv_chunk, q_offset)
    return out


def _fwd_impl(
    q, k, v, causal, q_chunk, kv_chunk, q_offset
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(out, lse)``; ``lse`` is blocked as ``(nq, b, kvh, g, q_chunk)``."""
    b, sq, kvh, g, dqk = q.shape
    sk = k.shape[1]
    dv = v.shape[-1]
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, sk)
    if sq % q_chunk != 0 or sk % kv_chunk != 0:
        raise ValueError(f"chunks ({q_chunk}, {kv_chunk}) must divide the lengths ({sq}, {sk})")
    nq, nk = sq // q_chunk, sk // kv_chunk
    scale = dqk**-0.5
    f32 = torch.float32
    dev = q.device

    outs, lses = [], []
    for qi in range(nq):
        qblk = q[:, qi * q_chunk : (qi + 1) * q_chunk].float()
        qp = torch.arange(qi * q_chunk, (qi + 1) * q_chunk, device=dev) + q_offset
        m = torch.full((b, kvh, g, q_chunk), -torch.inf, dtype=f32, device=dev)
        l = torch.zeros((b, kvh, g, q_chunk), dtype=f32, device=dev)
        acc = torch.zeros((b, kvh, g, q_chunk, dv), dtype=f32, device=dev)
        for ki in range(nk):
            kblk = k[:, ki * kv_chunk : (ki + 1) * kv_chunk]
            vblk = v[:, ki * kv_chunk : (ki + 1) * kv_chunk]
            kp = torch.arange(ki * kv_chunk, (ki + 1) * kv_chunk, device=dev)
            # f32 accumulation of exact products, as `preferred_element_type=float32`
            s = torch.einsum("bqhgd,bkhd->bhgqk", qblk, kblk.float()) * scale
            if causal:
                s = torch.where(kp[None, :] <= qp[:, None], s, torch.full_like(s, _NEG))
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p.to(vblk.dtype), vblk
            ).float()
            m = m_new
        den = torch.clamp(l, min=1e-30)
        outs.append((acc / den[..., None]).to(q.dtype))  # (b, kvh, g, qc, dv)
        lses.append(m + torch.log(den))
    out = torch.stack(outs)  # (nq, b, kvh, g, qc, dv) -> (b, sq, kvh, g, dv)
    out = out.permute(1, 0, 4, 2, 3, 5).reshape(b, sq, kvh, g, dv)
    return out, torch.stack(lses)
