"""Flash attention core in plain PyTorch, with its FlashAttention-2 backward, O(S) memory.

Counterpart of ``repro/models/layers/flash_core.py``.  Generic over GQA
grouping and distinct qk/v head dims:

    q: (b, sq, kvh, g, dqk)    k: (b, sk, kvh, dqk)    v: (b, sk, kvh, dv)
    out: (b, sq, kvh, g, dv)

The forward is an online softmax over KV blocks, written as a Python loop
over q and KV blocks where the JAX package scans.  It is the memory-safe
attention of the CPU path for long sequences; on the card the Hopper kernel
of ``repro_torch/kernels/flash_attention`` takes its place.

``flash_attention_bwd`` is the JAX module's ``_bwd``: only ``out`` and the
log-sum-exp are kept, P is recomputed per (q-block, kv-block) pair, and dq
is taken in one pass over q blocks, dk and dv in another over kv blocks.  It
is the backward of ``flash_attention_core`` here (an autograd Function, as
the JAX function is a ``custom_vjp``), and the plain version of the card's
backward kernel (``kernels/flash_attention/csrc/flash_attention_bwd.cu``),
which ``kernels/flash_attention/ops.py:attention_bwd`` calls on the
kernel's layout and the tests hold the kernel to; each caller hands it its
lse as ``(b, kvh, g, sq)``.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["flash_attention_bwd", "flash_attention_core"]

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
    return _FlashCore.apply(q, k, v, causal, q_chunk, kv_chunk, q_offset)


class _FlashCore(torch.autograd.Function):
    """The core with ``flash_attention_bwd`` as its backward (the JAX ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_chunk, kv_chunk, q_offset):
        out, lse = _fwd_impl(q, k, v, causal, q_chunk, kv_chunk, q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, q_chunk, kv_chunk, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        nq, b, kvh, g, qc = lse.shape
        lse = lse.permute(1, 2, 3, 0, 4).reshape(b, kvh, g, nq * qc)
        return (*flash_attention_bwd(q, k, v, out, lse, dout, *ctx.args), None, None, None, None)


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


def flash_attention_bwd(
    q: torch.Tensor,  # (b, sq, kvh, g, dqk)
    k: torch.Tensor,  # (b, sk, kvh, dqk)
    v: torch.Tensor,  # (b, sk, kvh, dv)
    out: torch.Tensor,  # (b, sq, kvh, g, dv)
    lse: torch.Tensor,  # (b, kvh, g, sq) float32
    dout: torch.Tensor,  # (b, sq, kvh, g, dv)
    causal: bool = True,
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
    q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` in the types of ``q``, ``k``, ``v``: the JAX ``_bwd``.

    P is recomputed from ``lse`` and ``delta = rowsum(dout * out)`` is taken
    in float32.  Products are float32 of exact products, as the reference's
    ``preferred_element_type=float32``, but for dq's, whose ``ds`` is cast to
    ``k``'s type first, as there.  A chunk need not divide its length: the
    last block is ragged.  A causal block wholly above the diagonal is
    skipped: its P is exactly 0, since every score there is ``-1e30``.
    """
    b, sq, kvh, g, dqk = q.shape
    sk, dv = k.shape[1], v.shape[-1]
    q_chunk, kv_chunk = min(q_chunk, sq), min(kv_chunk, sk)
    scale = dqk**-0.5
    f32 = torch.float32
    dev = q.device
    q32, k32, v32, do32 = q.float(), k.float(), v.float(), dout.float()
    delta = torch.einsum("bqhgd,bqhgd->bhgq", do32, out.float())  # (b, kvh, g, sq)
    q_blocks = [(q0, min(q0 + q_chunk, sq)) for q0 in range(0, sq, q_chunk)]
    kv_blocks = [(k0, min(k0 + kv_chunk, sk)) for k0 in range(0, sk, kv_chunk)]

    def live(q1, k0):
        return not causal or k0 <= q1 - 1 + q_offset

    def probs_and_ds(q0, q1, k0, k1):
        """P and dS = P (dP - delta) scale of one block pair, (b, kvh, g, qc, kc) float32."""
        s = torch.einsum("bqhgd,bkhd->bhgqk", q32[:, q0:q1], k32[:, k0:k1]) * scale
        if causal and k1 - 1 > q0 + q_offset:  # the block crosses the diagonal
            qp = torch.arange(q0, q1, device=dev) + q_offset
            kp = torch.arange(k0, k1, device=dev)
            s = s.masked_fill(kp[None, :] > qp[:, None], _NEG)
        p = torch.exp(s - lse[..., q0:q1, None])
        dp = torch.einsum("bqhgd,bkhd->bhgqk", do32[:, q0:q1], v32[:, k0:k1])
        return p, p * (dp - delta[..., q0:q1, None]) * scale

    # ---- dq: loop over q blocks, inner loop over kv blocks ------------------
    dq = torch.zeros((b, sq, kvh, g, dqk), dtype=f32, device=dev)
    for q0, q1 in q_blocks:
        for k0, k1 in kv_blocks:
            if live(q1, k0):
                _, ds = probs_and_ds(q0, q1, k0, k1)
                kblk = k[:, k0:k1]
                dq[:, q0:q1] += torch.einsum("bhgqk,bkhd->bqhgd", ds.to(kblk.dtype), kblk).float()

    # ---- dk, dv: loop over kv blocks, inner loop over q blocks --------------
    dk = torch.zeros((b, sk, kvh, dqk), dtype=f32, device=dev)
    dvv = torch.zeros((b, sk, kvh, dv), dtype=f32, device=dev)
    for k0, k1 in kv_blocks:
        for q0, q1 in q_blocks:
            if live(q1, k0):
                p, ds = probs_and_ds(q0, q1, k0, k1)
                dvv[:, k0:k1] += torch.einsum("bhgqk,bqhgd->bkhd", p, do32[:, q0:q1])
                dk[:, k0:k1] += torch.einsum("bhgqk,bqhgd->bkhd", ds, q32[:, q0:q1])
    return dq.to(q.dtype), dk.to(k.dtype), dvv.to(v.dtype)
