"""Attention layers: GQA/MHA, with the Hopper kernel as the core on the card.

Counterpart of ``repro/models/layers/attention.py``.  For a CUDA tensor
``attention_apply`` goes through ``kernels/flash_attention/ops.py`` to the
hand-written kernel, always.  For a CPU tensor it takes the plain path and
keeps the JAX package's rule: ``naive_attention`` up to 2048 tokens, the
chunked online-softmax core above that.

``mla_apply`` (DeepSeek-V2's multi-head latent attention, qk head dim 192
and v head dim 128) takes the same route: the kernel on a CUDA tensor, the
JAX package's two plain cores on a CPU tensor.

Over ``model`` (a ``Shards`` beside the parameters, :mod:`.basics`): a
process projects the q heads of its ``wq`` block and the kv heads of its
``wk``/``wv`` blocks -- a block, or all of them where the spec keeps a leaf
whole (``_spec_for``'s head guards: phi4's, llava's and command-r's smoke
configs split 4 q heads and keep their one kv head whole) -- attends with
the kv heads its own q heads read (:func:`kv_heads_for`; the kernel runs on
the local heads), and hands its heads' rows to the row-split ``wo``, whose
partial products are summed over ``model``.  MLA's latents (``w_dkv``,
``w_kr``, ``kv_norm``) are whole on every process; ``w_uk``/``w_uv`` give
the local heads.  A prefill's cache sink receives every kv head (gathered
over ``model``): the cache is placed after prefill (``launch/serve.py``).

With gradients, what is whole enters a process's heads through (f)
(``parallel/sharding.py``'s module note): the input of the split
projections; where ``wk``/``wv`` stay whole under split q heads, ``k`` and
``v`` themselves (each process's ``dk``/``dv`` covers its own q heads
only, so ``wk``, ``wv`` and ``k_norm`` are summed there); ``q_norm`` under
split q heads; MLA's latents ``c_kv`` and ``k_r``, read by each process's
heads alone.  ``wo``'s sum is (g).

Decode (single-token) paths are in :mod:`repro_torch.serve.decode`.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.compat import on_card
from repro_torch.configs.base import MLAConfig, ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.parallel.sharding import Shards, enter, held, sub
from .basics import apply_rope, dense, dense_rows, init_dense, init_norm, rmsnorm, rope_frequencies, take_cols
from .flash_core import flash_attention_core

Params = Dict[str, torch.Tensor]

__all__ = [
    "init_attention",
    "attention_qkv",
    "head_block",
    "kv_heads_for",
    "attention_apply",
    "init_mla",
    "mla_latents",
    "mla_apply",
    "chunked_attention",
    "naive_attention",
]


# ---------------------------------------------------------------------------
# Attention core
# ---------------------------------------------------------------------------


def naive_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    q_offset: int = 0,
) -> torch.Tensor:
    """Reference O(S^2)-memory attention.  q: (b, sq, h, d); k/v: (b, sk, kvh, d)."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, d)
    # scores in the input type, then float32: the JAX function does the same
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float() * (d**-0.5)
    if causal:
        qpos = torch.arange(sq, device=q.device) + q_offset
        kpos = torch.arange(k.shape[1], device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v)
    return out.reshape(b, sq, h, d)


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
    q_offset: int = 0,
) -> torch.Tensor:
    """Flash attention with O(S) memory, in plain PyTorch.

    q: (b, sq, h, d); k, v: (b, sk, kvh, d) with h % kvh == 0 (GQA).
    Returns (b, sq, h, d) in q.dtype.  Delegates to the core in
    :mod:`repro_torch.models.layers.flash_core`.
    """
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, d)
    out = flash_attention_core(
        qg, k, v, causal, min(q_chunk, sq), min(kv_chunk, k.shape[1]), q_offset
    )
    return out.reshape(b, sq, h, d)


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------


def init_attention(
    gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32, device=None
) -> Params:
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    kw = dict(dtype=dtype, device=device)
    p = {
        "wq": init_dense(gen, d, h * hd, bias=cfg.qkv_bias, **kw),
        "wk": init_dense(gen, d, kvh * hd, bias=cfg.qkv_bias, **kw),
        "wv": init_dense(gen, d, kvh * hd, bias=cfg.qkv_bias, **kw),
        "wo": init_dense(gen, h * hd, d, scale=(h * hd) ** -0.5, **kw),
    }
    if cfg.qk_norm:
        dev = p["wq"]["w"].device
        p["q_norm"] = init_norm("rmsnorm", hd, device=dev)
        p["k_norm"] = init_norm("rmsnorm", hd, device=dev)
    return p


def head_block(p: Params, shards: Optional[Shards], key: str, per_head: int) -> Tuple[slice, int]:
    """(the heads this process projects, the head count) of the projection
    ``p[key]`` (``per_head`` output features a head), from its spec."""
    cols, whole = held(sub(shards, key), "w", p[key]["w"], 1)
    if cols.start % per_head or cols.stop % per_head:
        raise ValueError(f"{key}: the block {cols} of {whole} features cuts a head of {per_head}")
    return slice(cols.start // per_head, cols.stop // per_head), whole // per_head


def kv_heads_for(q_heads: slice, kv_heads: slice, group: int, k: torch.Tensor, v: torch.Tensor):
    """The keys and values ``(b, s, kv, d)`` that the q heads ``q_heads`` read,
    from the kv heads ``kv_heads`` (global numbers) that ``k`` and ``v`` hold:
    q head ``i`` reads kv head ``i // group``.  Where the local q heads read
    their kv heads in equal runs (always, unless a block cuts a group
    unevenly), the run of kv heads, a view; else one kv head a q head."""
    need = [(q_heads.start + j) // group - kv_heads.start for j in range(q_heads.stop - q_heads.start)]
    if need[0] < 0 or need[-1] >= kv_heads.stop - kv_heads.start:
        raise ValueError(f"q heads {q_heads} read kv heads outside the block {kv_heads} this process holds")
    n_kv = need[-1] - need[0] + 1
    run = len(need) // n_kv
    if len(need) % n_kv == 0 and need == [need[0] + j // run for j in range(len(need))]:
        return k[:, :, need[0] : need[0] + n_kv], v[:, :, need[0] : need[0] + n_kv]
    idx = torch.tensor(need, device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def attention_qkv(
    p: Params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor, x_kv: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Projections + RoPE; shared by prefill and decode paths.  The heads
    are those of the projections' blocks (all of them on one process).
    ``x_kv`` (default ``x``) feeds ``wk`` and ``wv``."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    x_kv = x if x_kv is None else x_kv
    q = dense(p["wq"], x).reshape(b, s, -1, hd)
    k = dense(p["wk"], x_kv).reshape(b, s, -1, hd)
    v = dense(p["wv"], x_kv).reshape(b, s, -1, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"]["scale"])
        k = rmsnorm(k, p["k_norm"]["scale"])
    if cfg.use_rope:
        rot_dim, inv_freq = rope_frequencies(hd, cfg.rope_fraction, cfg.rope_theta, x.device)
        q = apply_rope(q, positions, rot_dim, inv_freq)
        k = apply_rope(k, positions, rot_dim, inv_freq)
    return q, k, v


def attention_apply(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,
    positions: Optional[torch.Tensor] = None,
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
    kv_sink: Optional[Dict[str, torch.Tensor]] = None,
    shards: Optional[Shards] = None,
) -> torch.Tensor:
    """Full-sequence causal attention (prefill).

    ``kv_sink``, when given, receives this layer's ``"k"`` and ``"v"``
    (after RoPE), so that prefill fills its cache from the one projection
    that also feeds the attention: every kv head, over ``model`` too.
    """
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q_heads, h = head_block(p, shards, "wq", hd)
    kv_heads, kvh = head_block(p, shards, "wk", hd)
    split_q, split_kv = q_heads != slice(0, h), kv_heads != slice(0, kvh)
    x_own = enter(shards, x) if split_q else x
    if cfg.qk_norm and (split_q or split_kv):
        p = dict(p, q_norm={"scale": enter(shards if split_q else None, p["q_norm"]["scale"])},
                 k_norm={"scale": enter(shards if split_kv else None, p["k_norm"]["scale"])})  # fmt: skip
    q, k, v = attention_qkv(p, cfg, x_own, positions, x_own if split_kv else x)
    if split_q and not split_kv:  # whole k and v read by this process's q heads alone
        k, v = shards.enter(k), shards.enter(v)
    if kv_sink is not None:  # every kv head, gathered over model where this process holds a block
        kv_sink["k"], kv_sink["v"] = (k, v) if shards is None else shards.gather_all([(k, 2, kv_heads, kvh),
                                                                                       (v, 2, kv_heads, kvh)])
    k, v = kv_heads_for(q_heads, kv_heads, h // kvh, k, v)
    # The JAX function expands K/V to full heads here when the kv-head count
    # does not divide a 16-way model axis: a tensor-parallel layout choice,
    # numerically neutral.  The port never expands: the kernel indexes the kv
    # head, and the plain versions group the q heads.
    if on_card(x):
        o = flash_attention(q, k, v, causal=True)
    elif s <= 2048:
        o = naive_attention(q, k, v, causal=True)
    else:
        o = chunked_attention(q, k, v, causal=True, q_chunk=q_chunk, kv_chunk=kv_chunk)
    rows = slice(q_heads.start * hd, q_heads.stop * hd)
    return dense_rows(p["wo"], o.reshape(b, s, -1), rows, h * hd, sub(shards, "wo"))



# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, DeepSeek-V2)
# ---------------------------------------------------------------------------


def init_mla(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32, device=None) -> Params:
    m: MLAConfig = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    kw = dict(dtype=dtype, device=device)
    qk_dim = m.qk_nope_dim + m.qk_rope_dim
    p = {
        # queries (v2-lite: no q compression)
        "wq": init_dense(gen, d, h * qk_dim, **kw),
        # compressed KV path
        "w_dkv": init_dense(gen, d, m.kv_lora_rank, **kw),
    }
    p["kv_norm"] = init_norm("rmsnorm", m.kv_lora_rank, device=p["wq"]["w"].device)
    p["w_kr"] = init_dense(gen, d, m.qk_rope_dim, **kw)  # shared rope key
    p["w_uk"] = init_dense(gen, m.kv_lora_rank, h * m.qk_nope_dim, **kw)
    p["w_uv"] = init_dense(gen, m.kv_lora_rank, h * m.v_head_dim, **kw)
    p["wo"] = init_dense(gen, h * m.v_head_dim, d, scale=(h * m.v_head_dim) ** -0.5, **kw)
    return p


def mla_latents(
    p: Params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compressed KV latents ``(c_kv, k_rope)``: what the KV cache stores (the
    MLA memory saving: kv_lora + rope_dim per token)."""
    m: MLAConfig = cfg.mla
    c_kv = rmsnorm(dense(p["w_dkv"], x), p["kv_norm"]["scale"])  # (b, s, r)
    k_r = dense(p["w_kr"], x)[:, :, None, :]  # (b, s, 1, rope_dim)
    rot, inv = rope_frequencies(m.qk_rope_dim, 1.0, cfg.rope_theta, x.device)
    k_r = apply_rope(k_r, positions, rot, inv)
    return c_kv, k_r[:, :, 0, :]


def mla_apply(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,
    positions: Optional[torch.Tensor] = None,
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
    cache_sink: Optional[Dict[str, torch.Tensor]] = None,
    shards: Optional[Shards] = None,
) -> torch.Tensor:
    """Full-sequence MLA (prefill): decompress K/V and run the attention core.

    ``cache_sink``, when given, receives this layer's latents ``"c_kv"`` and
    ``"k_r"``, so that prefill fills its cache from the one projection that
    also feeds the attention.  On the card the core is the flash-attention
    kernel at head dims (qk 192, v 128); on the CPU ``_mla_core`` up to 2048
    tokens and the chunked core above that, as in the JAX package.
    """
    m: MLAConfig = cfg.mla
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)
    heads, h = head_block(p, shards, "wq", m.qk_nope_dim + m.qk_rope_dim)
    hl = heads.stop - heads.start
    split = heads != slice(0, h)
    q = dense(p["wq"], enter(shards, x) if split else x).reshape(b, s, hl, m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = q[..., : m.qk_nope_dim], q[..., m.qk_nope_dim :]
    rot, inv = rope_frequencies(m.qk_rope_dim, 1.0, cfg.rope_theta, x.device)
    q_rope = apply_rope(q_rope, positions, rot, inv)

    c_kv, k_r = mla_latents(p, cfg, x, positions)  # (b, s, r), (b, s, rope)
    if cache_sink is not None:
        cache_sink["c_kv"], cache_sink["k_r"] = c_kv, k_r
    if split:  # the whole latents, read by this process's heads alone
        c_kv, k_r = shards.enter(c_kv), shards.enter(k_r)
    w_uk = take_cols(p["w_uk"], sub(shards, "w_uk"), slice(heads.start * m.qk_nope_dim, heads.stop * m.qk_nope_dim))
    w_uv = take_cols(p["w_uv"], sub(shards, "w_uv"), slice(heads.start * m.v_head_dim, heads.stop * m.v_head_dim))
    k_nope = dense(w_uk, c_kv).reshape(b, s, hl, m.qk_nope_dim)
    v = dense(w_uv, c_kv).reshape(b, s, hl, m.v_head_dim)

    qq = torch.cat([q_nope, q_rope], dim=-1)
    kk = torch.cat([k_nope, k_r[:, :, None, :].expand(b, s, hl, m.qk_rope_dim)], dim=-1)
    if on_card(x):
        o = flash_attention(qq, kk, v, causal=True)
    elif s <= 2048:
        o = _mla_core(qq, kk, v)
    else:
        o = _mla_core_chunked(qq, kk, v, q_chunk, kv_chunk)
    rows = slice(heads.start * m.v_head_dim, heads.stop * m.v_head_dim)
    return dense_rows(p["wo"], o.reshape(b, s, -1), rows, h * m.v_head_dim, sub(shards, "wo"))


def _mla_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal MHA core with distinct qk/v dims.  q, k: (b,s,h,dqk), v: (b,s,h,dv)."""
    d = q.shape[-1]
    s = q.shape[1]
    # scores in the input type, then float32: the JAX function does the same
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * (d**-0.5)
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    a = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", a, v)


def _mla_core_chunked(q, k, v, q_chunk: int, kv_chunk: int) -> torch.Tensor:
    """Flash core for distinct qk/v head dims (kvh == h, g == 1)."""
    b, sq, h, dqk = q.shape
    dv = v.shape[-1]
    out = flash_attention_core(
        q.reshape(b, sq, h, 1, dqk), k, v, True, min(q_chunk, sq), min(kv_chunk, sq), 0
    )
    return out.reshape(b, sq, h, dv)
