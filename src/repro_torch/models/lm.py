"""Causal LM assembly: embeddings -> (prelude + stacked groups) -> norm -> head.

Counterpart of ``repro/models/lm.py``.  Layer parameters are stacked on a
leading group axis exactly as the JAX package's ``_tree_stack`` leaves them,
so converted parameter trees compare leaf by leaf; where the JAX package
scans over that axis, this package loops over it in Python and indexes views.

Remat: where the JAX package wraps its scan body in ``jax.checkpoint``, each
block group here runs under ``torch.utils.checkpoint`` (non-reentrant) with
the policy of ``REMAT_POLICIES``: "none" saves everything, "full" nothing but
the group's inputs, "dots" the outputs of ``mm``, ``addmm`` and ``bmm`` and
"dots_no_batch" those of ``mm`` and ``addmm`` (selective checkpointing).  A
recomputed group launches its kernels again.  Checkpointing applies only
where autograd records (``torch.is_grad_enabled()``): a forward without
gradients has nothing to recompute.

Across processes, ``shards`` (a ``repro_torch.parallel.sharding.Shards``
beside the parameter tree) is threaded to every block: each group's
parameters are joined over the data axes first where their specs split them
there (``Shards.local``), and the layers split over ``model`` as their
specs say.  A train step passes its parameters' placement
(``Shards.of(param_shardings)``), whole over the data axes, so that its
layers split over ``model`` and a MoE layer dispatches the global batch.

``lm_loss`` is the mean next-token cross-entropy, in chunks of 2048 tokens,
each checkpointed so that the full ``(b, s, vocab)`` float32 logits never
exist at once.  With the head's vocabulary split over ``model`` it is the
vocab-parallel cross-entropy: each process holds its block of every chunk's
logits, and the log-sum-exp and the gold logit are summed across the blocks
(``parallel/sharding.py``'s (f) and (g)).  The residual stream stays whole
over ``model`` between the blocks: the JAX function's ``residual_spec``,
``embed_grad_spec`` and ``logits_spec`` are placements that change no value,
taken as hints and not applied (a deliberate difference).  Under remat
"full" a recomputed group issues its forward's collectives again during the
backward; every process runs the same layers in the same order, so they
meet.  The ``nn.Module`` that owns a parameter tree for serving is
:class:`repro_torch.serve.decode.CausalLM`.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from repro_torch.compat import torch_dtype
from repro_torch.configs.base import ModelConfig
from repro_torch.parallel import dist as pdist
from repro_torch.parallel.sharding import NamedSharding, Shards, Spec, shard_local, sub
from .blocks import block_apply, group_pattern, init_block, prelude_layers
from .layers.basics import apply_norm, embed, init_embedding, init_norm, unembed

Params = Dict[str, Any]

__all__ = ["REMAT_POLICIES", "head_key", "init_lm", "local_params", "lm_forward", "lm_logits", "lm_loss", "sinusoidal_positions", "tree_index"]

_aten = torch.ops.aten
# name -> the ops whose outputs a checkpointed group keeps (None: no checkpoint),
# after jax.checkpoint_policies: checkpoint_dots, checkpoint_dots_with_no_batch_dims,
# nothing_saveable
REMAT_POLICIES = {
    "none": None,
    "dots": (_aten.mm.default, _aten.addmm.default, _aten.bmm.default),
    "dots_no_batch": (_aten.mm.default, _aten.addmm.default),
    "full": (),
}


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


def _place(tree, shardings, stacked: bool = False):
    """Every leaf of ``tree`` replaced by this process's block by the
    ``NamedSharding`` at its path (a stacked leaf's, without its group axis)."""
    if isinstance(tree, dict):
        return {k: _place(v, shardings[k], stacked) for k, v in tree.items()}
    sharding = shardings
    if stacked:
        sharding = NamedSharding(sharding.mesh, Spec(*sharding.spec[1:]))
    return shard_local(tree, sharding)


def init_lm(
    gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32, device=None, shardings=None
) -> Params:
    """Random parameters, each leaf drawn on ``device`` (the generator's own by default).

    Same tree, shapes and scales as the JAX package's ``init_lm``; the numbers
    differ, because the two generators do.

    With ``shardings`` (``param_shardings``' tree over a ``DeviceMesh``),
    each leaf is drawn whole, in the same order from the same generator, and
    only this process's block of it is kept: a process never holds more of
    the model than one layer group beside its blocks.
    """
    pre = prelude_layers(cfg)
    body = cfg.n_layers - pre
    if body % cfg.block_group != 0:
        raise ValueError((cfg.n_layers, pre, cfg.block_group))
    n_groups = body // cfg.block_group
    device = gen.device if device is None else torch.device(device)

    def keep(key, tree, stacked=False):
        return tree if shardings is None else _place(tree, shardings[key], stacked)

    params: Params = {
        "embed": keep("embed", init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype, device)),
        "final_norm": keep("final_norm", init_norm(cfg.norm, cfg.d_model, device=device)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = keep("lm_head", init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype, device))

    for i in range(pre):
        params[f"prelude_{i}"] = keep(f"prelude_{i}", init_block(gen, cfg, i, dtype, device))

    # drawn group by group and copied into the stacked leaves at once, so that
    # the model is never held twice (qwen3-moe in bf16 fills most of a card)
    for g in range(n_groups):
        group = {}
        for p_idx in range(cfg.block_group):
            li = pre + g * cfg.block_group + p_idx
            group[f"pos_{p_idx}"] = init_block(gen, cfg, li, dtype, device)
        group = keep("blocks", group, stacked=True)
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
    shards: Optional[Shards] = None,
) -> torch.Tensor:
    """Returns final hidden states (b, s, d_model) in compute dtype.

    ``remat_policy`` names a ``REMAT_POLICIES`` entry, applied to each block
    group as the JAX function applies it to its scan body.
    ``residual_spec`` and ``embed_grad_spec`` are the JAX function's sharding
    hints: accepted and ignored (the residual stays whole; see
    ``blocks.py``).  ``shards`` places the forward across processes (module
    note).
    """
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {remat_policy!r}; choose from {sorted(REMAT_POLICIES)}")
    dtype = torch_dtype(cfg.dtype)
    if embeddings is None:
        x = embed(local_params(shards, "embed", params), tokens, dtype, sub(shards, "embed"))
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
        key = f"prelude_{i}"
        x = block_apply(local_params(shards, key, params), cfg, x, cfg.layer_kind(i), cfg.layer_is_moe(i), positions,
                        shards=sub(shards, key))  # fmt: skip

    group_shards = None if shards is None else shards["blocks"].group()

    def group_body(x, group_params):
        if group_shards is not None:
            group_params = group_shards.local(group_params)
        for p_idx, (kind, is_moe) in enumerate(pattern):
            key = f"pos_{p_idx}"
            x = block_apply(group_params[key], cfg, x, kind, is_moe, positions, shards=sub(group_shards, key))
        return x

    saved = REMAT_POLICIES[remat_policy]
    if saved is not None and torch.is_grad_enabled():
        kw = {"context_fn": functools.partial(create_selective_checkpoint_contexts, list(saved))} if saved else {}
        group_body = functools.partial(checkpoint, group_body, use_reentrant=False, **kw)
    n_groups = (cfg.n_layers - pre) // cfg.block_group
    for g in range(n_groups):
        x = group_body(x, tree_index(params["blocks"], g))
    return apply_norm(params["final_norm"], x, cfg.norm)


def local_params(shards: Optional[Shards], key: str, params: Params):
    """``params[key]`` joined over the data axes where its specs split it there."""
    return params[key] if shards is None else shards[key].local(params[key])


def head_key(cfg: ModelConfig) -> str:
    """The table the logits are read from: the embedding when tied, else ``lm_head``."""
    return "embed" if cfg.tie_embeddings else "lm_head"


def lm_logits(params: Params, cfg: ModelConfig, hidden: torch.Tensor, shards: Optional[Shards] = None) -> torch.Tensor:
    """The logits of ``hidden``; with the head's vocabulary split over
    ``model``, this process's block of them (``basics.greedy`` takes the
    argmax across the blocks)."""
    return unembed(local_params(shards, head_key(cfg), params), hidden)


def lm_loss(
    params: Params,
    cfg: ModelConfig,
    batch: Dict[str, torch.Tensor],
    remat_policy: str = "dots",
    residual_spec=None,
    embed_grad_spec=None,
    logits_spec=None,
    shards: Optional[Shards] = None,
) -> torch.Tensor:
    """Mean next-token cross-entropy, float32.  ``batch``: tokens/embeddings + labels.

    As in the JAX function: the sequence is cut into ``s // 2048`` chunks
    (one where that does not divide it), each chunk's summed CE is
    checkpointed, the gold logit is a masked sum over the vocabulary (not a
    gather), and the total is divided by ``b * s``.  The sharding hints are
    accepted and ignored (module note).  ``shards`` is ``lm_forward``'s: a
    train step's placement of the parameters.  Where it splits the head's
    vocabulary over ``model``, each process computes its block of the logits
    from the hidden state entering through (f); the block's maximum is
    reduced by MAX over ``model`` (no gradient: the log-sum-exp does not
    depend on it), and the sum of exponentials and the gold logit's masked
    sum over the block are each summed over ``model`` (g).
    """
    hidden = lm_forward(
        params,
        cfg,
        tokens=batch.get("tokens"),
        embeddings=batch.get("embeddings"),
        remat_policy=remat_policy,
        shards=shards,
    )
    labels = batch["labels"]
    key = head_key(cfg)
    head = params[key]
    vocab = _vocab_split(shards, key, head["table"])
    if vocab is not None:
        hidden = shards.enter(hidden)

    def chunk_loss(h_chunk, l_chunk, table):
        """Summed CE of one sequence chunk: its float32 logits are the only full-vocab buffer."""
        logits = unembed({"table": table}, h_chunk).float()
        vocab_iota = torch.arange(logits.shape[-1], device=logits.device)
        if vocab is None:
            logz = torch.logsumexp(logits, dim=-1)
        else:
            top = shards.psum(logits.detach().amax(dim=-1, keepdim=True), pdist.dist.ReduceOp.MAX)
            logz = torch.log(shards.reduce(torch.exp(logits - top).sum(dim=-1))) + top[..., 0]
            vocab_iota = vocab_iota + vocab.start
        gold = torch.where(vocab_iota == l_chunk[..., None], logits, 0.0).sum(dim=-1)
        if vocab is not None:
            gold = shards.reduce(gold)
        return (logz - gold).sum()

    b, s, _ = hidden.shape
    n_chunks = max(1, s // 2048)
    if s % n_chunks == 0 and n_chunks > 1:
        c = s // n_chunks
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for i in range(n_chunks):
            args = (hidden[:, i * c : (i + 1) * c], labels[:, i * c : (i + 1) * c], head["table"])
            part = checkpoint(chunk_loss, *args, use_reentrant=False) if torch.is_grad_enabled() else chunk_loss(*args)
            total = total + part
    else:
        total = chunk_loss(hidden, labels, head["table"])
    return total / (b * s)


def _vocab_split(shards: Optional[Shards], key: str, table: torch.Tensor) -> Optional[slice]:
    """This process's rows of the head's vocabulary where ``shards`` splits
    them over ``model``, else None."""
    if shards is None or shards.model == 1:
        return None
    rows, whole = shards[key].held("table", table, 0)
    return None if rows == slice(0, whole) else rows
