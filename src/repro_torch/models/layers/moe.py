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

Across processes (a ``Shards`` beside the parameters):

  * **the data axes**: the reference runs one program over the global batch,
    so its capacity counts the global tokens and its ranking puts the first
    data process's tokens first in an overflowing expert.  Each process here
    gathers the routed expert ids of every data process's tokens (an
    ``all_gather`` of ``(T, K)`` integers over the data axes; no gradient
    flows through them), dispatches the global tokens exactly as one process
    would, and fills and combines only its own: the others' slots stay zero
    and are never read.  The dispatch buffer and the expert products are as
    large as the global batch's on every data process, the same work done
    data-times over (held as speed work, ROADMAP);
  * **the model axis** (expert parallelism): each process holds ``E/M``
    experts (``P("model", None, None)``) and the whole router.  Every model
    process computes the same dispatch, runs its experts' slots, and adds
    them, in the reference's order (ascending expert id within a token), into
    a partial combine that is zero where another process's expert serves a
    slot.  The shared experts are a tensor-parallel MLP whose partial sum
    joins it, and one ``all_reduce`` over ``model`` adds the partials.  So a
    token's ``K`` slots are summed per process and then across processes:
    with ``K = 2``, two model processes and no shared experts the same sums
    in float32 as one process (``(a + 0) + b``), in general a reordering of
    them within float32 rounding (the tests' tolerance, 1e-5).  With
    gradients (``parallel/sharding.py``'s module note) the routing weights
    and the tokens, whole on every process, enter its experts through (f)
    -- each process combines only its own experts' slots, so the router's
    gradient is otherwise a partial sum -- the shared experts' input enters
    through the MLP's own (f), and the ``all_reduce`` is (g).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.parallel import dist as pdist
from repro_torch.parallel.sharding import Shards, held, sub
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


def moe_apply(p: Params, cfg: ModelConfig, x: torch.Tensor, shards: Optional[Shards] = None) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D).

    The JAX function's ``moe_shard_hints`` pin the dispatch buffer to the
    expert-parallel axis of a mesh; on one device they constrain nothing and
    are not applied here.  ``shards`` places the layer across processes
    (see the module note).
    """
    m: MoEConfig = cfg.moe
    b, s, d = x.shape
    T = b * s
    E = m.n_experts
    K = m.top_k
    xf = x.reshape(T, d)

    # float32, as JAX promotes it: the router is float32 at init and in the
    # optimizer's param dtype (bf16) after a training step
    logits = xf.float() @ p["router"].float()  # (T, E)
    weights, idx = router_topk(logits, m)  # (T, K)
    experts, _ = held(sub(shards, "gate"), (), p["gate"], 0)
    n_local = experts.stop - experts.start
    if n_local != E:  # whole weights and tokens, read by this process's experts alone: (f)
        weights, xf_own = shards.enter(weights), shards.enter(xf)
    else:
        xf_own = xf
    # the global tokens of the data axes: every data process's expert ids, in
    # the order of the global batch, this process's rows from `row0`
    row0, T_all = 0, T
    if shards is not None and shards.dp_size > 1:
        idx = pdist.all_gather(idx, 0, shards.mesh, shards.dp)
        row0, T_all = _data_index(shards) * T, T * shards.dp_size
    capacity = moe_capacity(T_all, m)
    dest, token, order = dispatch_indices(idx, E, capacity)
    own = T_all != T

    # scatter tokens into the expert buffers; every dropped slot (and every
    # other data process's) writes the scratch row E*C (those writes collide,
    # harmlessly: the row is sliced away), every kept destination is unique
    buf = torch.zeros((E * capacity + 1, d), dtype=x.dtype, device=x.device)
    if own:
        mine = (token >= row0) & (token < row0 + T)
        buf[torch.where(mine, dest, E * capacity)] = xf_own[(token - row0).clamp(0, T - 1)]
    else:
        buf[dest] = xf_own[token]
    h = buf[experts.start * capacity : experts.stop * capacity].view(n_local, capacity, d)

    # grouped expert FFN (SwiGLU) over this process's experts
    dt = x.dtype
    g = F.silu(torch.bmm(h, p["gate"].to(dt)))
    u = torch.bmm(h, p["up"].to(dt))
    y = torch.bmm(g * u, p["down"].to(dt))  # (E_local, C, D)

    # gather back + weighted combine; dropped slots (and other processes'
    # experts) read the zero row
    y_flat = torch.cat([y.reshape(-1, d), torch.zeros((1, d), dtype=y.dtype, device=y.device)])
    if n_local == E:
        at = dest
    else:
        local = dest - experts.start * capacity
        at = torch.where((local >= 0) & (local < n_local * capacity), local, n_local * capacity)
    w_flat = weights.reshape(-1)
    if own:  # every other data process's weights are zero here: their slots are never read
        w_flat = torch.zeros(T_all * K, dtype=weights.dtype, device=weights.device).index_copy(
            0, torch.arange(row0 * K, (row0 + T) * K, device=weights.device), w_flat)
    slot_out = y_flat[at] * w_flat[order].to(y.dtype)[:, None]  # (T_all*K, D)
    # The reference's `.at[token].add` sums a token's K slots in y's type in
    # sorted order, that is by ascending expert id.  The same sums, in that
    # order, with no atomics: each token's sorted positions (the inverse
    # permutation, sorted within the token), added one at a time.
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(order.numel(), device=order.device)
    positions = inverse.view(T_all, K)[row0 : row0 + T].sort(dim=1).values  # (T, K)
    out = torch.zeros((T, d), dtype=y.dtype, device=y.device)
    for k in range(K):
        out = out + slot_out[positions[:, k]]

    # what is a partial sum over model (this process's experts, its block of
    # the shared experts' hidden units) is added up by one all_reduce (g)
    partial, whole = (out, None) if n_local != E else (None, out)
    if m.n_shared > 0:
        shared = mlp_apply(p["shared"], xf, "swiglu", sub(shards, "shared"), reduce=False)
        part, ff = held(sub(sub(shards, "shared"), "up"), "w", p["shared"]["up"]["w"], 1)
        if part != slice(0, ff):
            partial = shared if partial is None else partial + shared
        else:
            whole = shared if whole is None else whole + shared
    if partial is not None:
        partial = shards.reduce(partial)
        whole = partial if whole is None else whole + partial
    return whole.reshape(b, s, d)


def _data_index(shards: Shards) -> int:
    """This process's index over the data axes, major to minor."""
    coords = dict(zip(shards.mesh.mesh_dim_names, shards.mesh.get_coordinate()))
    sizes = dict(zip(shards.mesh.mesh_dim_names, shards.mesh.shape))
    index = 0
    for a in shards.dp:
        index = index * sizes[a] + coords[a]
    return index
