"""Serving: prefill + single-token decode with a KV cache on one device.

Counterpart of ``repro/serve/decode.py``.  The cache layout mirrors the
stacked parameter layout: one entry per group position, stacked over groups
(leading ``G`` axis), plus unstacked prelude entries.  Cache kinds:

  * GQA attention:  ``{"k","v"}: (G, b, S, kv_heads, head_dim)``
  * MLA:            ``{"c_kv": (G, b, S, kv_lora), "k_r": (G, b, S, rope)}``
                    -- the compressed-latent cache; decode uses the
                    *absorbed* form (scores against ``c_kv`` directly, W_uk
                    folded into the query, W_uv applied after the context).
  * SSD (mamba2):   ``{"ssm": (G, b, H, P, N) float32, "conv": (G, b, w, conv_dim)}``
                    -- O(1)-size state, no sequence axis at all.

The reference launches its step as one compiled program
(``serve_fn = jax.jit(serve_fn)``, ``repro/launch/serve.py``).  The port's
counterpart is :func:`capture_serve_step`: the step captured once as a CUDA
graph on static token and position buffers, then replayed once a token.
:class:`EagerServeStep` is the same interface over the eager step, for the
CPU.

``cache_specs`` is the reference's placement of the cache (batch over the
data axes, sequence or heads over ``model``), and ``init_cache(...,
mesh=...)`` applies it over a ``DeviceMesh``: each process allocates its own
block.  The factories keep their names and take a ``device`` where the JAX
ones take a mesh; with ``shardings`` (``param_shardings``' tree over a
``DeviceMesh``, the parameters each process's blocks) they run across
processes, as the reference's GSPMD program runs on that mesh:

  * prefill splits each layer over ``model`` (``models/``) and hands back the
    cache whole over ``model`` (every head, every position, this process's
    rows of the batch): ``launch/serve.py``'s ``stage_prefill_cache`` keeps
    each process's ``cache_specs`` block of it, with no collective;
  * the decode step is sequence-parallel where ``cache_specs`` splits the
    attention cache's S over ``model``, as the reference's is
    (``repro/serve/decode.py:16-19``): the new token's q heads (and kv heads)
    are gathered over ``model`` (one token: small), each process scores its
    positions for every head against the global positions, the softmax is
    combined across processes in float32 (an ``all_reduce`` of the maximum,
    then of the sums and the weighted values), and each process hands its own
    heads' rows to the row-split ``wo``.  The new key and value (or latents)
    are written by the one process whose block holds the position.  The SSD
    state is split by heads; the greedy token is the argmax across the
    vocabulary blocks (``basics.greedy``).

Decode attention (``_gqa_decode``, ``_mla_decode``) is einsum + softmax in
the JAX package, not a Pallas kernel, and is plain PyTorch here; so are the
SSD decode step (``ssm_decode_step``, the token-by-token recurrence) and the
MoE FFN, whose dense-capacity dispatch reads every expert's weights a step.

:class:`CausalLM` is the one ``nn.Module`` of the port: it owns a parameter
tree and exposes ``prefill`` / ``decode_step`` / ``.to(device)``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.compat import resolve_device, torch_dtype
from repro_torch.configs.base import ModelConfig
from repro_torch.models.blocks import block_apply, group_pattern, prelude_layers
from repro_torch.models.layers.attention import attention_qkv, head_block, mla_latents
from repro_torch.models.layers.basics import (
    apply_norm,
    apply_rope,
    dense,
    dense_rows,
    embed,
    greedy,
    mlp_apply,
    rope_frequencies,
    take_cols,
)
from repro_torch.models.layers.moe import moe_apply
from repro_torch.models.layers.ssm import ssm_decode_step, ssm_state_shapes
from repro_torch.models.lm import head_key, lm_logits, local_params, sinusoidal_positions, tree_index
from repro_torch.parallel import dist as pdist
from repro_torch.parallel.sharding import NamedSharding, Shards, Spec, axis_sizes, dp_axes, held, sub

__all__ = [
    "CausalLM",
    "cache_shards",
    "cache_specs",
    "EagerServeStep",
    "ServeGraph",
    "cache_shapes",
    "capture_serve_step",
    "init_cache",
    "make_serve_step",
    "make_prefill",
    "SEQ_AXIS",
]

# the sequence axis of each cache leaf that has one, counted from the end
# (stacked or not): (..., b, S, kvh, hd) and (..., b, S, r)
SEQ_AXIS = {"k": -3, "v": -3, "c_kv": -2, "k_r": -2}


# ---------------------------------------------------------------------------
# Cache structure
# ---------------------------------------------------------------------------


def _layer_cache_shape(
    cfg: ModelConfig, kind: str, batch: int, max_seq: int
) -> Dict[str, Tuple[Tuple[int, ...], Any]]:
    """{name: (shape, dtype)} for one (unstacked) layer."""
    dt = torch_dtype(cfg.dtype)
    if kind == "ssm":
        sh = ssm_state_shapes(cfg, batch)
        return {"ssm": (sh["ssm"], torch.float32), "conv": (sh["conv"], dt)}
    if cfg.mla is not None:
        m = cfg.mla
        return {
            "c_kv": ((batch, max_seq, m.kv_lora_rank), dt),
            "k_r": ((batch, max_seq, m.qk_rope_dim), dt),
        }
    hd = cfg.resolved_head_dim
    return {
        "k": ((batch, max_seq, cfg.n_kv_heads, hd), dt),
        "v": ((batch, max_seq, cfg.n_kv_heads, hd), dt),
    }


def cache_shapes(cfg: ModelConfig, batch: int, max_seq: int) -> Dict[str, Any]:
    """Tree of the whole cache as meta tensors (shape and dtype, no storage)."""
    pre = prelude_layers(cfg)
    pattern = group_pattern(cfg)
    n_groups = (cfg.n_layers - pre) // cfg.block_group

    def sds(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    out: Dict[str, Any] = {}
    for i in range(pre):
        kind = cfg.layer_kind(i)
        out[f"prelude_{i}"] = {
            k: sds(sh, dt) for k, (sh, dt) in _layer_cache_shape(cfg, kind, batch, max_seq).items()
        }
    blocks = {}
    for p_idx, (kind, _) in enumerate(pattern):
        blocks[f"pos_{p_idx}"] = {
            k: sds((n_groups,) + sh, dt)
            for k, (sh, dt) in _layer_cache_shape(cfg, kind, batch, max_seq).items()
        }
    out["blocks"] = blocks
    return out


def cache_specs(cfg: ModelConfig, mesh: Any, batch: int, max_seq: int) -> Any:
    """Spec tree of the cache: batch over the data axes; seq (or heads) over model.

    Any non-divisible axis falls back to replication (e.g. a single
    sequence: the batch cannot split over data).  ``mesh`` is an ``{axis:
    size}`` mapping or a ``DeviceMesh``."""
    sizes = axis_sizes(mesh)
    dp_all = dp_axes(sizes)
    dp_size = 1
    for a in dp_all:
        dp_size *= sizes[a]
    dp = dp_all if (batch % max(dp_size, 1) == 0) else None
    model = sizes.get("model", 1)

    def spec_for(path_key: str, shape: Tuple[int, ...], stacked: bool) -> Spec:
        lead = (None,) if stacked else ()
        body = shape[1:] if stacked else shape
        if path_key in ("k", "v"):  # (b, S, kvh, hd): seq over model
            s_ok = body[1] % model == 0
            return Spec(*lead, dp, "model" if s_ok else None, None, None)
        if path_key in ("c_kv", "k_r"):  # (b, S, r)
            s_ok = body[1] % model == 0
            return Spec(*lead, dp, "model" if s_ok else None, None)
        if path_key == "ssm":  # (b, H, P, N): heads over model
            h_ok = body[1] % model == 0
            return Spec(*lead, dp, "model" if h_ok else None, None, None)
        if path_key == "conv":  # (b, w, conv_dim)
            return Spec(*lead, dp, None, None)
        raise KeyError(path_key)

    def walk(tree, stacked):
        return {k: walk(v, stacked) if isinstance(v, dict) else spec_for(k, tuple(v.shape), stacked)
                for k, v in tree.items()}  # fmt: skip

    return {k: walk(v, stacked=(k == "blocks")) for k, v in cache_shapes(cfg, batch, max_seq).items()}


def _alloc(tree, device, fill, specs=None, mesh=None):
    if isinstance(tree, dict):
        return {k: _alloc(v, device, fill, None if specs is None else specs[k], mesh) for k, v in tree.items()}
    shape = tree.shape if specs is None else NamedSharding(mesh, specs).shard_shape(tree.shape)
    return fill(shape, dtype=tree.dtype, device=device)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cuda", mesh: Any = None) -> Any:
    """Concrete zero-filled cache on ``device``.  With a ``DeviceMesh``
    ``mesh``, each leaf is this process's block of the cache of ``batch``
    sequences placed by ``cache_specs``."""
    shapes = cache_shapes(cfg, batch, max_seq)
    specs = cache_specs(cfg, mesh, batch, max_seq) if mesh is not None else None
    return _alloc(shapes, resolve_device(device), torch.zeros, specs, mesh)


# ---------------------------------------------------------------------------
# Decode-attention core
# ---------------------------------------------------------------------------


def _write_token(leaf: torch.Tensor, new: torch.Tensor, position: torch.Tensor, seq: slice, split: bool) -> None:
    """Write ``new`` (b, ...) at each row's ``position`` of ``leaf`` (b, S, ...),
    in place.  ``split``: ``leaf`` holds the positions ``seq`` of the whole
    cache, and a position outside them is another process's to write (the
    row is rewritten with itself: no host sync)."""
    bidx = torch.arange(leaf.shape[0], device=leaf.device)
    new = new.to(leaf.dtype)
    if not split:
        leaf[bidx, position] = new
        return
    local = position - seq.start
    owned = (local >= 0) & (local < seq.stop - seq.start)
    local = local.clamp(0, seq.stop - seq.start - 1)
    leaf[bidx, local] = torch.where(owned.view((-1,) + (1,) * (new.dim() - 1)), new, leaf[bidx, local])


def _attend(scores: torch.Tensor, values: torch.Tensor, equation: str, split: Optional[Shards]) -> torch.Tensor:
    """``softmax(scores) @ values`` over the last axis of ``scores`` (the
    cache's positions), in the values' type.  ``split``: the positions are
    this process's block of the sequence over ``model``, and the softmax is
    combined across the blocks in float32 -- an ``all_reduce`` of the
    maximum, then one of the sums and the weighted values together."""
    if split is None:
        a = torch.softmax(scores, dim=-1)
        return torch.einsum(equation, a.to(values.dtype), values)
    top = split.psum(scores.amax(dim=-1, keepdim=True), pdist.dist.ReduceOp.MAX)
    e = torch.exp(scores - top)
    total, weighted = split.psum_all([e.sum(dim=-1, keepdim=True), torch.einsum(equation, e, values.float())])
    return (weighted / total).to(values.dtype)


def _positions(leaf: torch.Tensor, cshards: Optional[Shards], key: str):
    """(this process's block of the cache's positions, whether it is a block
    of them: the sequence split over ``model``)."""
    seq, whole = held(cshards, key, leaf, 1)
    return seq, seq != slice(0, whole)


def _gqa_decode(p, cfg: ModelConfig, x, cache, position, shards=None, cshards=None):
    """x: (b,1,d); cache k/v: (b,S,kvh,hd); position: (b,) integer.

    Writes the new key and value into ``cache`` in place and returns it.
    Across processes (module note) ``cache`` holds this process's block of
    the positions, for every kv head.
    """
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    q_heads, h = head_block(p, shards, "wq", hd)
    kv_heads, kvh = head_block(p, shards, "wk", hd)
    q, k_new, v_new = attention_qkv(p, cfg, x, positions=position[:, None])
    if shards is not None:  # every head of the one new token
        q, k_new, v_new = shards.gather_all([(q, 2, q_heads, h), (k_new, 2, kv_heads, kvh), (v_new, 2, kv_heads, kvh)])
    k, v = cache["k"], cache["v"]
    seq, split = _positions(k, cshards, "k")
    _write_token(k, k_new[:, 0], position, seq, split)
    _write_token(v, v_new[:, 0], position, seq, split)

    g = h // kvh
    qg = q.reshape(b, kvh, g, hd)  # (b, kvh, g, hd) -- squeeze the seq dim
    # f32 accumulation of exact products, as `preferred_element_type=float32`
    scores = torch.einsum("bhgd,bshd->bhgs", qg.float(), k.float()) * (hd**-0.5)
    kpos = torch.arange(seq.start, seq.stop, device=x.device)
    mask = kpos[None, :] <= position[:, None]  # (b, S)
    scores = torch.where(mask[:, None, None, :], scores, torch.full_like(scores, -1e30))
    out = _attend(scores, v, "bhgs,bshd->bhgd", cshards if split else None)
    out = out.reshape(b, h, hd)[:, q_heads].reshape(b, 1, -1)
    return dense_rows(p["wo"], out, slice(q_heads.start * hd, q_heads.stop * hd), h * hd, sub(shards, "wo")), cache


def _mla_decode(p, cfg: ModelConfig, x, cache, position, shards=None, cshards=None):
    """Absorbed MLA decode: scores directly against the compressed latents.

    x: (b,1,d); cache c_kv: (b,S,r), k_r: (b,S,rope); position: (b,) integer.
    Writes the new latents into ``cache`` in place and returns it.  Across
    processes the latents are whole on each (``w_dkv``, ``w_kr``), the
    absorbed queries of this process's heads are gathered, and the context of
    its heads goes through its ``w_uv`` and ``wo`` blocks.
    """
    m = cfg.mla
    b = x.shape[0]
    heads, h = head_block(p, shards, "wq", m.qk_nope_dim + m.qk_rope_dim)
    hl = heads.stop - heads.start
    c_new, kr_new = mla_latents(p, cfg, x, position[:, None])  # (b,1,r), (b,1,rope)
    c_kv, k_r = cache["c_kv"], cache["k_r"]
    seq, split = _positions(c_kv, cshards, "c_kv")
    _write_token(c_kv, c_new[:, 0], position, seq, split)
    _write_token(k_r, kr_new[:, 0], position, seq, split)

    q = dense(p["wq"], x).reshape(b, hl, m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = q[..., : m.qk_nope_dim], q[..., m.qk_nope_dim :]
    rot, inv = rope_frequencies(m.qk_rope_dim, 1.0, cfg.rope_theta, x.device)
    q_rope = apply_rope(q_rope[:, None], position[:, None], rot, inv)[:, 0]

    nope = slice(heads.start * m.qk_nope_dim, heads.stop * m.qk_nope_dim)
    w_uk = take_cols(p["w_uk"], sub(shards, "w_uk"), nope)["w"].reshape(m.kv_lora_rank, hl, m.qk_nope_dim)
    q_lat = torch.einsum("bhn,rhn->bhr", q_nope, w_uk.to(q.dtype))
    if shards is not None:  # the absorbed queries of every head
        q_lat, q_rope = shards.gather_all([(q_lat, 1, heads, h), (q_rope, 1, heads, h)])
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    # f32 accumulation of exact products, as `preferred_element_type=float32`
    scores = (
        torch.einsum("bhr,bsr->bhs", q_lat.float(), c_kv.float())
        + torch.einsum("bhp,bsp->bhs", q_rope.float(), k_r.float())
    ) * scale
    kpos = torch.arange(seq.start, seq.stop, device=x.device)
    mask = kpos[None, :] <= position[:, None]  # (b, S)
    scores = torch.where(mask[:, None, :], scores, torch.full_like(scores, -1e30))
    ctx = _attend(scores, c_kv, "bhs,bsr->bhr", cshards if split else None)[:, heads]
    vcols = slice(heads.start * m.v_head_dim, heads.stop * m.v_head_dim)
    w_uv = take_cols(p["w_uv"], sub(shards, "w_uv"), vcols)["w"].reshape(m.kv_lora_rank, hl, m.v_head_dim)
    val = torch.einsum("bhr,rhv->bhv", ctx, w_uv.to(ctx.dtype))
    out = val.reshape(b, 1, hl * m.v_head_dim)
    return dense_rows(p["wo"], out, vcols, h * m.v_head_dim, sub(shards, "wo")), cache


def _ffn_decode(p, cfg: ModelConfig, is_moe: bool, x, shards=None):
    if is_moe:
        return moe_apply(p, cfg, x, shards)
    return mlp_apply(p, x, cfg.act, shards)


def _ssm_decode(p, cfg: ModelConfig, x, cache, shards=None):
    """One SSD step; writes the new state into ``cache`` in place and returns it."""
    out, new = ssm_decode_step(p, cfg, x, cache, shards)
    cache["ssm"].copy_(new["ssm"])
    cache["conv"].copy_(new["conv"])
    return out, cache


def _mixer_decode(p, cfg: ModelConfig, kind: str, h, cache, position, shards=None, cshards=None):
    if kind == "ssm":
        return _ssm_decode(p, cfg, h, cache, shards)
    if cfg.mla is not None:
        return _mla_decode(p, cfg, h, cache, position, shards, cshards)
    return _gqa_decode(p, cfg, h, cache, position, shards, cshards)


def _block_decode(p, cfg: ModelConfig, kind: str, is_moe: bool, x, cache, position, shards=None, cshards=None):
    has_ffn = "ffn" in p
    h = apply_norm(p["norm1"], x, cfg.norm)
    mix, cache = _mixer_decode(p["mixer"], cfg, kind, h, cache, position, sub(shards, "mixer"), cshards)
    if cfg.parallel_block:
        out = x + mix
        if has_ffn:
            out = out + _ffn_decode(p["ffn"], cfg, is_moe, h, sub(shards, "ffn"))
        return out, cache
    x = x + mix
    if has_ffn:
        h = apply_norm(p["norm2"], x, cfg.norm)
        x = x + _ffn_decode(p["ffn"], cfg, is_moe, h, sub(shards, "ffn"))
    return x, cache


# ---------------------------------------------------------------------------
# serve_step / prefill factories
# ---------------------------------------------------------------------------


def cache_shards(cfg: ModelConfig, shards: Optional[Shards], batch: int, max_seq: int) -> Optional[Shards]:
    """The cache's placement beside ``shards`` (the parameters'; None on one
    process): ``cache_specs`` of the global batch, ``batch`` rows on each
    data process, and ``max_seq`` positions."""
    if shards is None:
        return None
    return Shards(shards.mesh, cache_specs(cfg, shards.mesh, batch * shards.dp_size, max_seq))


def _layers(cfg: ModelConfig, params, shards: Optional[Shards], cache, cshards: Optional[Shards] = None):
    """``(kind, is_moe, params, shards, cache, cache shards)`` of every layer
    in order, the preludes first: its parameters joined over the data axes
    (``Shards.local``), its cache leaves views into ``cache`` (written
    through)."""
    pattern = group_pattern(cfg)
    pre = prelude_layers(cfg)
    for i in range(pre):
        key = f"prelude_{i}"
        yield (cfg.layer_kind(i), cfg.layer_is_moe(i), local_params(shards, key, params), sub(shards, key),
               cache[key], sub(cshards, key))  # fmt: skip
    gshards = None if shards is None else shards["blocks"].group()
    gcshards = None if cshards is None else cshards["blocks"].group()
    for g in range((cfg.n_layers - pre) // cfg.block_group):
        gparams = tree_index(params["blocks"], g)
        if gshards is not None:
            gparams = gshards.local(gparams)
        gcache = tree_index(cache["blocks"], g)
        for p_idx, (kind, is_moe) in enumerate(pattern):
            key = f"pos_{p_idx}"
            yield kind, is_moe, gparams[key], sub(gshards, key), gcache[key], sub(gcshards, key)


def make_serve_step(cfg: ModelConfig, device, batch: int, max_seq: Optional[int], shardings: Any = None):
    """Returns ``serve_fn`` (the JAX factory's tuple of shardings is gone).

    ``serve_fn(params, cache, tokens, position) -> (next_tokens, logits_f32,
    cache)``: one decode step for the whole batch.  ``serve_fn`` **mutates**
    the cache it is given (the new key and value, or latents, of every
    attention layer are written at ``position``, every SSD layer's state is
    replaced) and
    returns that same cache.  ``max_seq`` (the cache's sequence length; None
    for a model without attention) names the cache the step is made for.
    With ``shardings`` (module note) ``batch`` is this process's rows, the
    cache its ``cache_specs`` block of a ``max_seq`` cache, and the logits
    this process's block of the vocabulary where the head's spec splits it
    (``basics.whole_logits`` joins them); the tokens are the global argmax.
    """
    shards = Shards.of(shardings)
    return _serve_step(cfg, device, batch, shards, cache_shards(cfg, shards, batch, max_seq or 0))


def _serve_step(cfg: ModelConfig, device, batch: int, shards: Optional[Shards], cshards: Optional[Shards]):
    """``make_serve_step``'s ``serve_fn`` for the parameters placed by
    ``shards`` and the cache placed by ``cshards`` (both None on one process)."""
    device = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)

    @torch.inference_mode()
    def serve_fn(params, cache, tokens, position):
        if tokens.shape != (batch, 1) or position.shape != (batch,):
            raise ValueError(f"expected tokens ({batch}, 1) and position ({batch},)")
        if tokens.device != device:
            raise ValueError(f"tokens lie on {tokens.device}, this step was made for {device}")
        x = embed(local_params(shards, "embed", params), tokens, dtype, sub(shards, "embed"))  # (b, 1, d)
        if not cfg.use_rope:
            x = x + sinusoidal_positions(position, cfg.d_model, dtype)[:, None, :]

        for kind, is_moe, p, sh, layer_cache, csh in _layers(cfg, params, shards, cache, cshards):
            x, _ = _block_decode(p, cfg, kind, is_moe, x, layer_cache, position, sh, csh)

        x = apply_norm(params["final_norm"], x, cfg.norm)
        logits = lm_logits(params, cfg, x[:, 0, :], shards).float()  # (b, vocab or its block)
        next_tokens = greedy(logits, sub(shards, head_key(cfg)))
        return next_tokens, logits, cache

    return serve_fn


def make_prefill(cfg: ModelConfig, device, batch: int, seq: int, shardings: Any = None):
    """Prefill: full forward that also produces the filled cache.

    Returns ``prefill_fn`` (the JAX factory's tuple of shardings is gone).
    ``prefill_fn(params, batch_inputs) -> (last_logits, cache)``.

    Each layer runs once and fills the cache from the same computation: a
    GQA layer's k and v, an MLA layer's latents, an SSD layer's scan (its
    final state) and conv inputs.  The JAX function computes them twice per
    layer (for an SSD layer, two chunked scans; for an MLA layer, the
    latents again) and leaves the merging to XLA; PyTorch runs eagerly.
    With ``shardings`` (module note) ``batch`` is this process's rows, the
    cache comes back whole over ``model`` and the logits are this process's
    block of the vocabulary where the head's spec splits it.
    """
    device = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    shards = Shards.of(shardings)

    def layer_with_cache(p, kind, is_moe, x, positions, cache, sh):
        """block_apply, with what the layer leaves for decoding copied into ``cache``."""
        sink: Dict[str, torch.Tensor] = {}
        x = block_apply(p, cfg, x, kind, is_moe, positions, cache_sink=sink, shards=sh)
        for name, leaf in cache.items():
            leaf.copy_(sink[name])
        return x

    @torch.inference_mode()
    def prefill_fn(params, inputs):
        if cfg.frontend is not None:
            x = inputs["embeddings"].to(dtype)
        else:
            x = embed(local_params(shards, "embed", params), inputs["tokens"], dtype, sub(shards, "embed"))
        if x.shape[:2] != (batch, seq):
            raise ValueError(f"expected inputs of ({batch}, {seq}), got {tuple(x.shape[:2])}")
        if x.device != device:
            raise ValueError(f"inputs lie on {x.device}, this prefill was made for {device}")
        positions = torch.arange(seq, device=device)
        if not cfg.use_rope:
            x = x + sinusoidal_positions(positions, cfg.d_model, dtype)[None]

        cache = _alloc(cache_shapes(cfg, batch, seq), device, torch.empty)
        for kind, is_moe, p, sh, layer_cache, _ in _layers(cfg, params, shards, cache):
            x = layer_with_cache(p, kind, is_moe, x, positions, layer_cache, sh)

        x = apply_norm(params["final_norm"], x, cfg.norm)
        last_logits = lm_logits(params, cfg, x[:, -1, :], shards).float()
        return last_logits, cache

    return prefill_fn


# ---------------------------------------------------------------------------
# The decode step on static buffers: eager, or one captured CUDA graph
# ---------------------------------------------------------------------------


class EagerServeStep:
    """``make_serve_step``'s step on static buffers: ``tokens (batch, 1)`` and
    ``position (batch,)`` on the cache's device, which every step advances
    itself (its greedy tokens copied into ``tokens``, 1 added to
    ``position``), and the cache it is given, which every step writes.

    ``feed`` sets the next step's inputs; ``replay`` runs one step and
    returns ``(next_tokens, logits)``.  This is the step ``serve`` and
    ``serve_stream`` decode with on the CPU; on the card they take
    :class:`ServeGraph`, the same interface.  A step across processes
    takes the parameters' ``shardings`` (``make_serve_step``'s) and the
    cache's placement ``cshards`` (``cache_shards`` of the whole cache: a
    block of it does not tell its whole length), and raises without it.
    """

    def __init__(self, cfg: ModelConfig, params: Dict[str, Any], cache: Any, batch: int, shardings: Any = None,
                 cshards: Optional[Shards] = None):
        shards = Shards.of(shardings)
        if shards is not None and cshards is None:
            raise ValueError("a step across processes needs its cache's placement: pass cshards = "
                             "cache_shards(cfg, shards, batch, max_seq) of the whole cache")
        self.device = next(leaf for _, leaf in _flatten(cache)).device
        self.max_seq = _cache_len(cache, cshards)
        self._fn = _serve_step(cfg, self.device, batch, shards, cshards)
        # held for as long as the step: a graph reads them at the addresses it captured
        self._params, self._cache = params, cache
        self.tokens = torch.zeros((batch, 1), dtype=torch.int32, device=self.device)
        self.position = torch.zeros((batch,), dtype=torch.int32, device=self.device)
        self.replays = 0

    def feed(self, tokens, position) -> None:
        """Copy the next step's tokens ``(batch, 1)`` and positions ``(batch,)``
        (tensors or host arrays) into the static buffers."""
        self.tokens.copy_(torch.as_tensor(tokens).reshape(self.tokens.shape))
        self.position.copy_(torch.as_tensor(position).reshape(self.position.shape))

    def _step(self):
        next_tokens, logits, _ = self._fn(self._params, self._cache, self.tokens, self.position)
        self.tokens.copy_(next_tokens[:, None])
        self.position.add_(1)
        return next_tokens, logits

    def replay(self) -> Tuple[torch.Tensor, torch.Tensor]:
        self.replays += 1
        return self._step()


class ServeGraph(EagerServeStep):
    """The decode step captured as one CUDA graph: the port's
    ``jax.jit(serve_fn)``.  ``replay`` launches the whole step -- every
    layer, the greedy token, and the buffers' advance -- by one
    ``CUDAGraph.replay()``, and returns the graph's static ``next_tokens``
    and ``logits``: the next replay overwrites them, so a caller clones what
    it keeps.

    Capture follows PyTorch's recipe: warm-up calls on a side stream (they
    set up cuBLAS and the allocator), then the capture, in which nothing
    runs.  A warm-up call is a real step on the live cache:

    * it replaces every SSD layer's state and conv window, so those leaves
      are copied before the warm-up and restored after it;
    * it writes the new key and value (or latents) of every attention layer
      at the row its ``position`` names, and the warm-up runs at the cache's
      last row (``max_seq - 1``).  That row is never read before it is
      written again: a step at position ``p`` writes row ``p`` in each
      attention layer before that layer reads the cache, and reads no row
      past ``p`` (masked to exactly zero weight, on finite values).  So the
      step that first reads the row rewrites it, as a step would after any
      earlier request that left rows there.

    Nothing on the decode path syncs with the host, and a capture that meets
    one raises: there is no eager fallback.  The decode step launches no
    kernel of this package (K1 and K2 run in prefill); one that it came to
    launch takes the current, capturing, stream, and would count one launch
    in its wrapper's ``launches`` at capture and none at a replay.

    Across processes the step's collectives are captured with it, which
    NCCL allows; a group on another backend (``gloo``) cannot be captured,
    and the capture raises before it starts (run :class:`EagerServeStep`
    there).
    """

    WARMUP = 2

    def __init__(self, cfg: ModelConfig, params: Dict[str, Any], cache: Any, batch: int, shardings: Any = None,
                 cshards: Optional[Shards] = None):
        shards = Shards.of(shardings)
        if shards is not None and shards.dp_size * shards.model > 1:
            backend = pdist.dist.get_backend()
            if backend != "nccl":
                raise ValueError(f"capture_serve_step captures the step's collectives in a CUDA graph, which the "
                                 f"{backend!r} backend cannot: decode with EagerServeStep in a {backend} group")
        super().__init__(cfg, params, cache, batch, shardings, cshards)
        if self.device.type != "cuda":
            raise ValueError(f"capture_serve_step captures a CUDA graph: the cache lies on {self.device}")
        max_seq = self.max_seq
        self.position.fill_(0 if max_seq is None else max_seq - 1)
        kept = [(leaf, leaf.clone()) for name, leaf in _flatten(cache) if name.split(_SEP)[-1] not in SEQ_AXIS]
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(self.WARMUP):
                self._fn(params, cache, self.tokens, self.position)
        torch.cuda.current_stream(self.device).wait_stream(side)
        for leaf, copy in kept:
            leaf.copy_(copy)
        del kept
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.next_tokens, self.logits = self._step()

    def replay(self) -> Tuple[torch.Tensor, torch.Tensor]:
        self.graph.replay()
        self.replays += 1
        return self.next_tokens, self.logits


def capture_serve_step(cfg: ModelConfig, params: Dict[str, Any], cache: Any, batch: int, shardings: Any = None,
                       cshards: Optional[Shards] = None) -> ServeGraph:
    """``make_serve_step``'s step for ``batch`` sequences on ``cache`` (on the
    card), captured as one CUDA graph.  Raises for a cache on the CPU, for a
    group that is not NCCL's, and when the capture fails.  Feed the first
    step's inputs before the first replay."""
    return ServeGraph(cfg, params, cache, batch, shardings, cshards)


# ---------------------------------------------------------------------------
# The module that owns a parameter tree
# ---------------------------------------------------------------------------

_SEP = "__"  # joins the keys of the nested dict into one buffer name


def _flatten(tree: Dict[str, Any], prefix: str = ""):
    for key, value in tree.items():
        name = f"{prefix}{_SEP}{key}" if prefix else key
        if isinstance(value, dict):
            yield from _flatten(value, name)
        else:
            yield name, value


class CausalLM(nn.Module):
    """A model configuration and its parameter tree, for serving.

    The leaves are registered as buffers under their joined path, so
    ``.to(device)``, ``state_dict()`` and friends see them; ``params`` gives
    them back as the nested dict that the functions of this package take.
    With ``shardings`` (``param_shardings``' tree over a ``DeviceMesh``) the
    leaves are this process's blocks, and prefill and decode run across the
    mesh's processes.
    """

    def __init__(self, cfg: ModelConfig, params: Dict[str, Any], shardings: Any = None):
        super().__init__()
        self.cfg = cfg
        self.shardings = shardings
        self._serve_fns: Dict[Tuple[torch.device, int, Optional[int]], Any] = {}
        for name, leaf in _flatten(params):
            self.register_buffer(name, leaf)

    @property
    def params(self) -> Dict[str, Any]:
        tree: Dict[str, Any] = {}
        for name, leaf in self._buffers.items():
            node = tree
            *path, last = name.split(_SEP)
            for key in path:
                node = node.setdefault(key, {})
            node[last] = leaf
        return tree

    @property
    def device(self) -> torch.device:
        return next(iter(self._buffers.values())).device

    def prefill(self, inputs: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Any]:
        """``inputs``: ``{"tokens": (b, s)}`` or ``{"embeddings": (b, s, d)}``.
        Returns the last position's float32 logits and the filled cache."""
        b, s = next(iter(inputs.values())).shape[:2]
        return make_prefill(self.cfg, self.device, b, s, self.shardings)(self.params, inputs)

    def decode_step(self, cache: Any, tokens: torch.Tensor, position: torch.Tensor):
        """One greedy decode step, eager; writes into ``cache`` and returns
        ``(next_tokens, logits, cache)``.  ``serve_fn`` is made once per
        (device, batch, max_seq), ``max_seq`` the cache's length.  On the
        card the launchers decode through :func:`capture_serve_step`; this
        step is what its checks hold the graph against.  One process only:
        a placed model raises here, since a block of its cache does not tell
        the cache's placement; step it with :class:`EagerServeStep` and the
        cache's ``cshards``."""
        if self.shardings is not None:
            raise ValueError("decode_step runs on one process: step a placed model with EagerServeStep(..., "
                             "shardings, cshards)")
        key = (self.device, tokens.shape[0], _cache_len(cache))
        if key not in self._serve_fns:
            self._serve_fns[key] = make_serve_step(self.cfg, *key)
        return self._serve_fns[key](self.params, cache, tokens, position)

    def init_cache(self, batch: int, max_seq: int, mesh: Any = None) -> Any:
        return init_cache(self.cfg, batch, max_seq, self.device, mesh)


def _cache_len(cache: Any, cshards: Optional[Shards] = None) -> Optional[int]:
    """The sequence length of the cache's attention leaves, whole where
    ``cshards`` places a block of it; None if it has none."""
    if isinstance(cache, dict):
        for name, axis in SEQ_AXIS.items():
            if name in cache:
                leaf = cache[name]
                return held(cshards, name, leaf, leaf.dim() + axis)[1]
        for key, value in cache.items():
            found = _cache_len(value, sub(cshards, key))
            if found is not None:
                return found
    return None
