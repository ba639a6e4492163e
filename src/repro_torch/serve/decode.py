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
block, so that a data-parallel server prefills and decodes its rows of the
batch (``repro_torch/launch/serve.py``).  The factories keep their names and
take a ``device`` where the JAX ones take a mesh; their shardings are gone.

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
from repro_torch.models.layers.attention import attention_qkv, mla_latents
from repro_torch.models.layers.basics import (
    apply_norm,
    apply_rope,
    dense,
    embed,
    mlp_apply,
    rope_frequencies,
    unembed,
)
from repro_torch.models.layers.moe import moe_apply
from repro_torch.models.layers.ssm import ssm_decode_step, ssm_state_shapes
from repro_torch.models.lm import sinusoidal_positions, tree_index
from repro_torch.parallel.sharding import NamedSharding, Spec, axis_sizes, dp_axes

__all__ = [
    "CausalLM",
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


def _gqa_decode(p, cfg: ModelConfig, x, cache, position):
    """x: (b,1,d); cache k/v: (b,S,kvh,hd); position: (b,) integer.

    Writes the new key and value into ``cache`` in place and returns it.
    """
    b = x.shape[0]
    S = cache["k"].shape[1]
    q, k_new, v_new = attention_qkv(p, cfg, x, positions=position[:, None])
    bidx = torch.arange(b, device=x.device)
    k, v = cache["k"], cache["v"]
    k[bidx, position] = k_new[:, 0].to(k.dtype)
    v[bidx, position] = v_new[:, 0].to(v.dtype)

    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    g = h // kvh
    qg = q.reshape(b, kvh, g, hd)  # (b, kvh, g, hd) -- squeeze the seq dim
    # f32 accumulation of exact products, as `preferred_element_type=float32`
    scores = torch.einsum("bhgd,bshd->bhgs", qg.float(), k.float()) * (hd**-0.5)
    mask = torch.arange(S, device=x.device)[None, :] <= position[:, None]  # (b, S)
    scores = torch.where(mask[:, None, None, :], scores, torch.full_like(scores, -1e30))
    a = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", a.to(v.dtype), v)
    out = out.reshape(b, 1, h * hd)
    return dense(p["wo"], out), cache


def _mla_decode(p, cfg: ModelConfig, x, cache, position):
    """Absorbed MLA decode: scores directly against the compressed latents.

    x: (b,1,d); cache c_kv: (b,S,r), k_r: (b,S,rope); position: (b,) integer.
    Writes the new latents into ``cache`` in place and returns it.
    """
    m = cfg.mla
    b = x.shape[0]
    S = cache["c_kv"].shape[1]
    h = cfg.n_heads
    c_new, kr_new = mla_latents(p, cfg, x, position[:, None])  # (b,1,r), (b,1,rope)
    bidx = torch.arange(b, device=x.device)
    c_kv, k_r = cache["c_kv"], cache["k_r"]
    c_kv[bidx, position] = c_new[:, 0].to(c_kv.dtype)
    k_r[bidx, position] = kr_new[:, 0].to(k_r.dtype)

    q = dense(p["wq"], x).reshape(b, h, m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = q[..., : m.qk_nope_dim], q[..., m.qk_nope_dim :]
    rot, inv = rope_frequencies(m.qk_rope_dim, 1.0, cfg.rope_theta, x.device)
    q_rope = apply_rope(q_rope[:, None], position[:, None], rot, inv)[:, 0]

    w_uk = p["w_uk"]["w"].reshape(m.kv_lora_rank, h, m.qk_nope_dim)
    q_lat = torch.einsum("bhn,rhn->bhr", q_nope, w_uk.to(q.dtype))
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    # f32 accumulation of exact products, as `preferred_element_type=float32`
    scores = (
        torch.einsum("bhr,bsr->bhs", q_lat.float(), c_kv.float())
        + torch.einsum("bhp,bsp->bhs", q_rope.float(), k_r.float())
    ) * scale
    mask = torch.arange(S, device=x.device)[None, :] <= position[:, None]  # (b, S)
    scores = torch.where(mask[:, None, :], scores, torch.full_like(scores, -1e30))
    a = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhs,bsr->bhr", a.to(c_kv.dtype), c_kv)
    w_uv = p["w_uv"]["w"].reshape(m.kv_lora_rank, h, m.v_head_dim)
    val = torch.einsum("bhr,rhv->bhv", ctx, w_uv.to(ctx.dtype))
    out = val.reshape(b, 1, h * m.v_head_dim)
    return dense(p["wo"], out), cache


def _ffn_decode(p, cfg: ModelConfig, is_moe: bool, x):
    if is_moe:
        return moe_apply(p, cfg, x)
    return mlp_apply(p, x, cfg.act)


def _ssm_decode(p, cfg: ModelConfig, x, cache):
    """One SSD step; writes the new state into ``cache`` in place and returns it."""
    out, new = ssm_decode_step(p, cfg, x, cache)
    cache["ssm"].copy_(new["ssm"])
    cache["conv"].copy_(new["conv"])
    return out, cache


def _mixer_decode(p, cfg: ModelConfig, kind: str, h, cache, position):
    if kind == "ssm":
        return _ssm_decode(p, cfg, h, cache)
    if cfg.mla is not None:
        return _mla_decode(p, cfg, h, cache, position)
    return _gqa_decode(p, cfg, h, cache, position)


def _block_decode(p, cfg: ModelConfig, kind: str, is_moe: bool, x, cache, position):
    has_ffn = "ffn" in p
    h = apply_norm(p["norm1"], x, cfg.norm)
    mix, cache = _mixer_decode(p["mixer"], cfg, kind, h, cache, position)
    if cfg.parallel_block:
        out = x + mix
        if has_ffn:
            out = out + _ffn_decode(p["ffn"], cfg, is_moe, h)
        return out, cache
    x = x + mix
    if has_ffn:
        h = apply_norm(p["norm2"], x, cfg.norm)
        x = x + _ffn_decode(p["ffn"], cfg, is_moe, h)
    return x, cache


# ---------------------------------------------------------------------------
# serve_step / prefill factories
# ---------------------------------------------------------------------------


def make_serve_step(cfg: ModelConfig, device, batch: int, max_seq: Optional[int]):
    """Returns ``serve_fn`` (the JAX factory's tuple of shardings is gone).

    ``serve_fn(params, cache, tokens, position) -> (next_tokens, logits_f32,
    cache)``: one decode step for the whole batch.  ``serve_fn`` **mutates**
    the cache it is given (the new key and value, or latents, of every
    attention layer are written at ``position``, every SSD layer's state is
    replaced) and
    returns that same cache.  ``max_seq`` (the cache's sequence length; None
    for a model without attention) only names the cache the step is made for.
    """
    device = resolve_device(device)
    pattern = group_pattern(cfg)
    pre = prelude_layers(cfg)
    n_groups = (cfg.n_layers - pre) // cfg.block_group
    dtype = torch_dtype(cfg.dtype)

    @torch.inference_mode()
    def serve_fn(params, cache, tokens, position):
        if tokens.shape != (batch, 1) or position.shape != (batch,):
            raise ValueError(f"expected tokens ({batch}, 1) and position ({batch},)")
        if tokens.device != device:
            raise ValueError(f"tokens lie on {tokens.device}, this step was made for {device}")
        x = embed(params["embed"], tokens, dtype)  # (b, 1, d)
        if not cfg.use_rope:
            x = x + sinusoidal_positions(position, cfg.d_model, dtype)[:, None, :]

        for i in range(pre):
            x, _ = _block_decode(
                params[f"prelude_{i}"],
                cfg,
                cfg.layer_kind(i),
                cfg.layer_is_moe(i),
                x,
                cache[f"prelude_{i}"],
                position,
            )
        for g in range(n_groups):
            gparams = tree_index(params["blocks"], g)
            gcache = tree_index(cache["blocks"], g)  # views: written through
            for p_idx, (kind, is_moe) in enumerate(pattern):
                x, _ = _block_decode(
                    gparams[f"pos_{p_idx}"], cfg, kind, is_moe, x, gcache[f"pos_{p_idx}"], position
                )

        x = apply_norm(params["final_norm"], x, cfg.norm)
        head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
        logits = unembed(head, x[:, 0, :]).float()  # (b, vocab)
        next_tokens = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tokens, logits, cache

    return serve_fn


def make_prefill(cfg: ModelConfig, device, batch: int, seq: int):
    """Prefill: full forward that also produces the filled cache.

    Returns ``prefill_fn`` (the JAX factory's tuple of shardings is gone).
    ``prefill_fn(params, batch_inputs) -> (last_logits, cache)``.

    Each layer runs once and fills the cache from the same computation: a
    GQA layer's k and v, an MLA layer's latents, an SSD layer's scan (its
    final state) and conv inputs.  The JAX function computes them twice per
    layer (for an SSD layer, two chunked scans; for an MLA layer, the
    latents again) and leaves the merging to XLA; PyTorch runs eagerly.
    """
    device = resolve_device(device)
    pattern = group_pattern(cfg)
    pre = prelude_layers(cfg)
    n_groups = (cfg.n_layers - pre) // cfg.block_group
    dtype = torch_dtype(cfg.dtype)

    def layer_with_cache(p, kind, is_moe, x, positions, cache):
        """block_apply, with what the layer leaves for decoding copied into ``cache``."""
        sink: Dict[str, torch.Tensor] = {}
        x = block_apply(p, cfg, x, kind, is_moe, positions, cache_sink=sink)
        for name, leaf in cache.items():
            leaf.copy_(sink[name])
        return x

    @torch.inference_mode()
    def prefill_fn(params, inputs):
        if cfg.frontend is not None:
            x = inputs["embeddings"].to(dtype)
        else:
            x = embed(params["embed"], inputs["tokens"], dtype)
        if x.shape[:2] != (batch, seq):
            raise ValueError(f"expected inputs of ({batch}, {seq}), got {tuple(x.shape[:2])}")
        if x.device != device:
            raise ValueError(f"inputs lie on {x.device}, this prefill was made for {device}")
        positions = torch.arange(seq, device=device)
        if not cfg.use_rope:
            x = x + sinusoidal_positions(positions, cfg.d_model, dtype)[None]

        cache = _alloc(cache_shapes(cfg, batch, seq), device, torch.empty)
        for i in range(pre):
            x = layer_with_cache(
                params[f"prelude_{i}"], cfg.layer_kind(i), cfg.layer_is_moe(i), x, positions,
                cache[f"prelude_{i}"],
            )  # fmt: skip
        for g in range(n_groups):
            gparams = tree_index(params["blocks"], g)
            gcache = tree_index(cache["blocks"], g)  # views: written through
            for p_idx, (kind, is_moe) in enumerate(pattern):
                x = layer_with_cache(
                    gparams[f"pos_{p_idx}"], kind, is_moe, x, positions, gcache[f"pos_{p_idx}"]
                )

        x = apply_norm(params["final_norm"], x, cfg.norm)
        head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
        last_logits = unembed(head, x[:, -1, :]).float()
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
    :class:`ServeGraph`, the same interface.
    """

    def __init__(self, cfg: ModelConfig, params: Dict[str, Any], cache: Any, batch: int):
        self.device = next(leaf for _, leaf in _flatten(cache)).device
        self._fn = make_serve_step(cfg, self.device, batch, _cache_len(cache))
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
    """

    WARMUP = 2

    def __init__(self, cfg: ModelConfig, params: Dict[str, Any], cache: Any, batch: int):
        super().__init__(cfg, params, cache, batch)
        if self.device.type != "cuda":
            raise ValueError(f"capture_serve_step captures a CUDA graph: the cache lies on {self.device}")
        max_seq = _cache_len(cache)
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


def capture_serve_step(cfg: ModelConfig, params: Dict[str, Any], cache: Any, batch: int) -> ServeGraph:
    """``make_serve_step``'s step for ``batch`` sequences on ``cache`` (on the
    card), captured as one CUDA graph.  Raises for a cache on the CPU and
    when the capture fails.  Feed the first step's inputs before the first
    replay."""
    return ServeGraph(cfg, params, cache, batch)


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
    """

    def __init__(self, cfg: ModelConfig, params: Dict[str, Any]):
        super().__init__()
        self.cfg = cfg
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
        return make_prefill(self.cfg, self.device, b, s)(self.params, inputs)

    def decode_step(self, cache: Any, tokens: torch.Tensor, position: torch.Tensor):
        """One greedy decode step, eager; writes into ``cache`` and returns
        ``(next_tokens, logits, cache)``.  ``serve_fn`` is made once per
        (device, batch, max_seq).  On the card the launchers decode through
        :func:`capture_serve_step`; this step is what its checks hold the
        graph against."""
        key = (self.device, tokens.shape[0], _cache_len(cache))
        if key not in self._serve_fns:
            self._serve_fns[key] = make_serve_step(self.cfg, *key)
        return self._serve_fns[key](self.params, cache, tokens, position)

    def init_cache(self, batch: int, max_seq: int, mesh: Any = None) -> Any:
        return init_cache(self.cfg, batch, max_seq, self.device, mesh)


def _cache_len(cache: Any) -> Optional[int]:
    """The sequence length of the cache's attention leaves; None if it has none."""
    if isinstance(cache, dict):
        for name, axis in SEQ_AXIS.items():
            if name in cache:
                return cache[name].shape[axis]
        for value in cache.values():
            found = _cache_len(value)
            if found is not None:
                return found
    return None
