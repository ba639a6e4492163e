"""Mixture-of-Experts layer: top-k routing with sort-based capacity dispatch.

Counterpart of ``repro/models/layers/moe.py``, with its static-shape design:

  1. router logits (float32) -> top-k experts per token, renormalised;
  2. the (tokens x k) assignments are sorted by expert id (stable) and
     scattered into a dense ``(E, C, D)`` buffer, capacity ``C`` per expert;
     slots past the capacity are dropped (they land in the scratch row
     ``E*C``, which is sliced away);
  3. the experts' SwiGLU runs as three batched products over the ``E`` axis;
  4. the results are gathered back and combined with the routing weights;
     shared experts (DeepSeek-style) run densely over all tokens.

There is no kernel here: the JAX module computes the grouped products outside
any Pallas kernel, and they go to ``torch.bmm`` (cuBLAS on the card).

Decode uses the same dense-capacity dispatch, so every step reads every
expert's weights: that is the reference's semantics, kept as it is.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from .basics import _normal, init_mlp, mlp_apply

Params = Dict[str, torch.Tensor]

__all__ = ["init_moe", "moe_apply", "moe_capacity", "router_topk", "dispatch_indices"]


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32, device=None) -> Params:
    """Router ``(d, E)`` in float32 whatever ``dtype``; expert stacks ``(E, d_in, d_out)``."""
    m: MoEConfig = cfg.moe
    d = cfg.d_model

    def expert_stack(d_in, d_out):
        return _normal(gen, (m.n_experts, d_in, d_out), d_in**-0.5, dtype, device)

    p: Params = {
        "router": _normal(gen, (d, m.n_experts), d**-0.5, torch.float32, device),
        "gate": expert_stack(d, m.d_ff_expert),
        "up": expert_stack(d, m.d_ff_expert),
        "down": expert_stack(m.d_ff_expert, d),
    }
    if m.n_shared > 0:
        p["shared"] = init_mlp(gen, d, m.d_ff_expert * m.n_shared, "swiglu", dtype, device)
    return p


def router_topk(logits: torch.Tensor, m: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, E) logits -> (T, K) weights (float32) and (T, K) expert ids.

    ``jax.lax.top_k`` puts the lower index first on an exact tie;
    ``torch.topk`` promises no order there, so a token whose probabilities
    tie exactly may be routed differently on the card.  The tests use
    tie-free float32 logits.
    """
    probs = torch.softmax(logits.float(), dim=-1)
    weights, idx = torch.topk(probs, m.top_k, dim=-1)
    if m.router_norm_topk:
        weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    return weights, idx


def dispatch_indices(
    idx: torch.Tensor, n_experts: int, capacity: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort-based dispatch bookkeeping.

    idx: (T, K) expert assignment.  Returns
      ``dest``    (T*K,) flat destination slot in the (E*C [+1 drop]) buffer,
      ``token``   (T*K,) source token of each sorted slot,
      ``order``   (T*K,) position of this slot in the flattened (T, K) matrix.
    """
    T, K = idx.shape
    flat_expert = idx.reshape(-1)
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    token = order // K
    # rank of each slot within its expert group
    experts = torch.arange(n_experts, dtype=sorted_expert.dtype, device=idx.device)
    starts = torch.searchsorted(sorted_expert, experts)  # (E,)
    rank = torch.arange(T * K, device=idx.device) - starts[sorted_expert]
    keep = rank < capacity
    dest = torch.where(keep, sorted_expert * capacity + rank, n_experts * capacity)
    return dest, token, order


def moe_capacity(tokens: int, m: MoEConfig) -> int:
    """Slots per expert, with the reference's float operations in its order,
    so that both packages drop the same tokens."""
    capacity = int(tokens * m.top_k / m.n_experts * m.capacity_factor)
    return max(8, min(capacity, tokens))


def moe_apply(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D).

    The JAX function's ``moe_shard_hints`` pin the dispatch buffer to the
    expert-parallel axis of a mesh; on one device they constrain nothing and
    are not applied here.
    """
    m: MoEConfig = cfg.moe
    b, s, d = x.shape
    T = b * s
    E = m.n_experts
    xf = x.reshape(T, d)

    # float32, as JAX promotes it: the router is float32 at init and in the
    # optimizer's param dtype (bf16) after a training step
    logits = xf.float() @ p["router"].float()  # (T, E)
    weights, idx = router_topk(logits, m)  # (T, K)
    capacity = moe_capacity(T, m)
    dest, token, order = dispatch_indices(idx, E, capacity)

    # scatter tokens into the expert buffers; every dropped slot writes the
    # scratch row E*C (those writes collide, harmlessly: the row is sliced
    # away), every kept destination is unique
    buf = torch.zeros((E * capacity + 1, d), dtype=x.dtype, device=x.device)
    buf[dest] = xf[token]
    h = buf[: E * capacity].view(E, capacity, d)

    # grouped expert FFN (SwiGLU) over the E axis
    dt = x.dtype
    g = F.silu(torch.bmm(h, p["gate"].to(dt)))
    u = torch.bmm(h, p["up"].to(dt))
    y = torch.bmm(g * u, p["down"].to(dt))  # (E, C, D)

    # gather back + weighted combine; dropped slots read the zero row
    y_flat = torch.cat([y.reshape(-1, d), torch.zeros((1, d), dtype=y.dtype, device=y.device)])
    slot_out = y_flat[dest] * weights.reshape(-1)[order].to(y.dtype)[:, None]  # (T*K, D)
    # The reference's `.at[token].add` sums a token's K slots in y's type in
    # sorted order, that is by ascending expert id.  The same sums, in that
    # order, with no atomics: each token's sorted positions (the inverse
    # permutation, sorted within the token), added one at a time.
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(order.numel(), device=order.device)
    positions = inverse.view(T, m.top_k).sort(dim=1).values  # (T, K)
    out = torch.zeros((T, d), dtype=y.dtype, device=y.device)
    for k in range(m.top_k):
        out = out + slot_out[positions[:, k]]

    if m.n_shared > 0:
        out = out + mlp_apply(p["shared"], xf, "swiglu")
    return out.reshape(b, s, d)
