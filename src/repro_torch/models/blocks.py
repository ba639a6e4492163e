"""Decoder blocks: sequential / parallel-residual, attention or SSD mixer, dense or MoE FFN.

Counterpart of ``repro/models/blocks.py``.  A *block* is one layer: mixer
(GQA attention, MLA or Mamba-2 SSD) + FFN (dense MLP, absent when
``d_ff == 0``, or a Mixture-of-Experts layer), pre-norm residual.
``command-r``-style architectures use a parallel residual (one input norm,
attention and MLP both read it).

Blocks are grouped as in the JAX package: :func:`group_pattern` returns the
periodic (kind, is_moe) pattern of one group, and the parameters of all
groups are stacked on a leading axis.

Over ``model`` (``shards``, a ``repro_torch.parallel.sharding.Shards``
beside the block's parameters) the mixer and the FFN split as their specs
say and each ends in an ``all_reduce``: the residual stream and the norms
stay whole on every model process.  The JAX package also constrains the
residual to be sequence-split over ``model`` between blocks (``lm.py``'s
``residual_spec``, ``decode.py``'s ``constrain``): a placement that changes
no value, which the port does not make (a deliberate difference).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.parallel.sharding import Shards, sub
from .layers.attention import attention_apply, init_attention, init_mla, mla_apply
from .layers.basics import apply_norm, init_mlp, init_norm, mlp_apply
from .layers.moe import init_moe, moe_apply
from .layers.ssm import init_ssm, ssm_apply

Params = Dict[str, torch.Tensor]

__all__ = ["group_pattern", "init_block", "block_apply", "prelude_layers"]


def prelude_layers(cfg: ModelConfig) -> int:
    """Leading layers that do not fit the periodic group pattern."""
    return cfg.moe.first_k_dense if cfg.moe is not None else 0


def group_pattern(cfg: ModelConfig) -> List[Tuple[str, bool]]:
    """(mixer kind, is_moe) for each position of one group."""
    pre = prelude_layers(cfg)
    return [
        (cfg.layer_kind(pre + p), cfg.layer_is_moe(pre + p))
        for p in range(cfg.block_group)
    ]


def init_block(
    gen: torch.Generator, cfg: ModelConfig, layer_idx: int, dtype=torch.float32, device=None
) -> Params:
    """Parameters of one layer (mixer + FFN + norms)."""
    kind = cfg.layer_kind(layer_idx)
    is_moe = cfg.layer_is_moe(layer_idx)
    device = gen.device if device is None else device
    p: Params = {"norm1": init_norm(cfg.norm, cfg.d_model, device=device)}
    if kind == "attn":
        p["mixer"] = (
            init_mla(gen, cfg, dtype, device)
            if cfg.mla is not None
            else init_attention(gen, cfg, dtype, device)
        )
    else:
        p["mixer"] = init_ssm(gen, cfg, dtype, device)
    if is_moe:
        p["ffn"] = init_moe(gen, cfg, dtype, device)
    elif cfg.d_ff > 0:
        p["ffn"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype, device)
    if not cfg.parallel_block and "ffn" in p:
        p["norm2"] = init_norm(cfg.norm, cfg.d_model, device=device)
    return p


def _mixer(
    p: Params,
    cfg: ModelConfig,
    kind: str,
    x: torch.Tensor,
    positions: Optional[torch.Tensor],
    cache_sink: Optional[Dict[str, torch.Tensor]],
    shards: Optional[Shards] = None,
) -> torch.Tensor:
    if kind == "attn":
        if cfg.mla is not None:
            return mla_apply(p, cfg, x, positions, cache_sink=cache_sink, shards=shards)
        return attention_apply(p, cfg, x, positions, kv_sink=cache_sink, shards=shards)
    return ssm_apply(p, cfg, x, state_sink=cache_sink, shards=shards)


def _ffn(p: Params, cfg: ModelConfig, is_moe: bool, x: torch.Tensor, shards: Optional[Shards] = None) -> torch.Tensor:
    if is_moe:
        return moe_apply(p, cfg, x, shards)
    return mlp_apply(p, x, cfg.act, shards)


def block_apply(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,
    kind: str,
    is_moe: bool,
    positions: Optional[torch.Tensor] = None,
    cache_sink: Optional[Dict[str, torch.Tensor]] = None,
    shards: Optional[Shards] = None,
) -> torch.Tensor:
    """One layer, full-sequence path (prefill).

    ``cache_sink``, when given, receives what the layer leaves in the decode
    cache: a GQA layer's ``"k"`` and ``"v"``, an MLA layer's latents
    ``"c_kv"`` and ``"k_r"``, an SSD layer's ``"ssm"`` and ``"conv"`` state
    (whole over ``model``).  ``shards`` places the layer across processes,
    its parameters each this process's block split over ``model`` alone.
    """
    has_ffn = "ffn" in p
    mixer, ffn = sub(shards, "mixer"), sub(shards, "ffn") if has_ffn else None
    if cfg.parallel_block:
        h = apply_norm(p["norm1"], x, cfg.norm)
        out = x + _mixer(p["mixer"], cfg, kind, h, positions, cache_sink, mixer)
        if has_ffn:
            out = out + _ffn(p["ffn"], cfg, is_moe, h, ffn)
        return out
    h = apply_norm(p["norm1"], x, cfg.norm)
    x = x + _mixer(p["mixer"], cfg, kind, h, positions, cache_sink, mixer)
    if has_ffn:
        h = apply_norm(p["norm2"], x, cfg.norm)
        x = x + _ffn(p["ffn"], cfg, is_moe, h, ffn)
    return x
