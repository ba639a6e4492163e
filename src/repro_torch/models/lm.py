"""Causal LM assembly: embeddings -> (prelude + stacked groups) -> norm -> head.

Counterpart of ``repro/models/lm.py``.  Layer parameters are stacked on a
leading group axis exactly as the JAX package's ``_tree_stack`` leaves them,
so converted parameter trees compare leaf by leaf; where the JAX package
scans over that axis, this package loops over it in Python and indexes views.

``lm_loss`` waits for the training slice.  The ``nn.Module`` that owns a
parameter tree for serving is :class:`repro_torch.serve.decode.CausalLM`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.compat import torch_dtype
from repro_torch.configs.base import ModelConfig
from .blocks import block_apply, group_pattern, init_block, prelude_layers
from .layers.basics import apply_norm, embed, init_embedding, init_norm, unembed

Params = Dict[str, Any]

__all__ = ["init_lm", "lm_forward", "lm_logits", "sinusoidal_positions", "tree_index"]


def _stacked_like(tree, n: int):
    """Uninitialised leaves of ``(n,) + leaf.shape``, the type and device of ``tree``'s."""
    if isinstance(tree, dict):
        return {k: _stacked_like(v, n) for k, v in tree.items()}
    return torch.empty((n,) + tuple(tree.shape), dtype=tree.dtype, device=tree.device)


def _tree_copy_into(dst, src) -> None:
    if isinstance(dst, dict):
        for k in dst:
            _tree_copy_into(dst[k], src[k])
    else:
        dst.copy_(src)


def tree_index(tree, i: int):
    """Entry ``i`` of the stacked leading axis of every leaf (views, no copy)."""
    if isinstance(tree, dict):
        return {k: tree_index(v, i) for k, v in tree.items()}
    return tree[i]


def init_lm(
    gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32, device=None
) -> Params:
    """Random parameters, each leaf drawn on ``device`` (the generator's own by default).

    Same tree, shapes and scales as the JAX package's ``init_lm``; the numbers
    differ, because the two generators do.
    """
    pre = prelude_layers(cfg)
    body = cfg.n_layers - pre
    if body % cfg.block_group != 0:
        raise ValueError((cfg.n_layers, pre, cfg.block_group))
    n_groups = body // cfg.block_group
    device = gen.device if device is None else torch.device(device)

    params: Params = {
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype, device),
        "final_norm": init_norm(cfg.norm, cfg.d_model, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype, device)

    for i in range(pre):
        params[f"prelude_{i}"] = init_block(gen, cfg, i, dtype, device)

    # drawn group by group and copied into the stacked leaves at once, so that
    # the model is never held twice (qwen3-moe in bf16 fills most of a card)
    for g in range(n_groups):
        group = {}
        for p_idx in range(cfg.block_group):
            li = pre + g * cfg.block_group + p_idx
            group[f"pos_{p_idx}"] = init_block(gen, cfg, li, dtype, device)
        if g == 0:
            params["blocks"] = _stacked_like(group, n_groups)
        _tree_copy_into(tree_index(params["blocks"], g), group)
        del group
    return params


def sinusoidal_positions(positions: torch.Tensor, d_model: int, dtype) -> torch.Tensor:
    """``(..., d_model)`` sinusoidal embedding of ``positions`` (archs without RoPE)."""
    inv = 1.0 / (
        10_000 ** (torch.arange(0, d_model, 2, dtype=torch.float32, device=positions.device) / d_model)
    )
    ang = positions[..., None].float() * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def lm_forward(
    params: Params,
    cfg: ModelConfig,
    tokens: Optional[torch.Tensor] = None,
    embeddings: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
    remat_policy: str = "dots",
    residual_spec=None,
    embed_grad_spec=None,
) -> torch.Tensor:
    """Returns final hidden states (b, s, d_model) in compute dtype.

    ``remat_policy``, ``residual_spec`` and ``embed_grad_spec`` are the JAX
    function's rematerialisation and sharding hints: accepted and ignored.
    """
    dtype = torch_dtype(cfg.dtype)
    if embeddings is None:
        x = embed(params["embed"], tokens, dtype)
    else:
        x = embeddings.to(dtype)
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)
    if not cfg.use_rope:
        # archs without rope (musicgen backbone, mamba2): sinusoidal adds
        x = x + sinusoidal_positions(positions, cfg.d_model, dtype)[None]

    pattern = group_pattern(cfg)
    pre = prelude_layers(cfg)
    for i in range(pre):
        x = block_apply(
            params[f"prelude_{i}"], cfg, x, cfg.layer_kind(i), cfg.layer_is_moe(i), positions
        )
    n_groups = (cfg.n_layers - pre) // cfg.block_group
    for g in range(n_groups):
        group_params = tree_index(params["blocks"], g)
        for p_idx, (kind, is_moe) in enumerate(pattern):
            x = block_apply(group_params[f"pos_{p_idx}"], cfg, x, kind, is_moe, positions)
    return apply_norm(params["final_norm"], x, cfg.norm)


def lm_logits(params: Params, cfg: ModelConfig, hidden: torch.Tensor) -> torch.Tensor:
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return unembed(head, hidden)
