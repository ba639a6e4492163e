"""AdamW (from scratch) with gradient compression.

Counterpart of ``repro/train/optimizer.py``, with the same configuration,
state and arithmetic.  The optimizer state holds float32 master weights and
first and second moments; the model's parameters are kept in the compute
type (bf16).  On one device there is nothing to shard.  Over a
``DeviceMesh`` each process holds the state at its placement (the ``scu``
policy's ZeRO blocks over the data axes, ``repro_torch.sync``) and is handed
the gradients there; ``adamw_update`` updates those blocks, with the global
norm's squares summed over the data processes for the blocks they split
(a whole leaf counted once), and ``compress_decompress`` takes its scale's
max over them.  The train step gathers the new parameters back to their
placement.

Gradient compression: ``int8`` applies per-tensor scale quantization with
error feedback (``compress_decompress``); ``none`` keeps the gradients as
they are.

Trees are nested dicts, walked in the JAX package's leaf order (keys sorted
at every level), so that the global norm sums the leaves in its order.
``adamw_update`` updates the state's tensors in place, leaf by leaf, where
the JAX function returns new ones (its jitted caller donates them): at
phi4-mini's 3.8 B parameters a whole-tree float32 temporary would be 15 GB.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.parallel import dist as pdist

__all__ = [
    "OptConfig",
    "adamw_update",
    "compress_decompress",
    "init_error_feedback",
    "init_opt_state",
    "tree_leaves",
    "tree_map",
]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    compression: str = "none"  # none | int8


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of a nested dict in ``jax.tree.leaves`` order (sorted keys)."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    return [tree]


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the same-shaped ``rest`` trees."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key], *(r[key] for r in rest)) for key in tree}
    return fn(tree, *rest)


def init_opt_state(params: Any, shardings: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """float32 master (a copy, never the parameter itself) and zero moments.

    With ``shardings`` (``{"master", "m", "v"}`` trees of ``NamedSharding``,
    the reference's ``out_shardings``) each leaf is this process's block of
    the whole one, made leaf by leaf from the whole parameters.
    """
    if shardings is None:
        return {
            "master": tree_map(lambda p: p.to(torch.float32, copy=True), params),
            "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params),
            "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params),
        }
    from repro_torch.parallel.sharding import shard_local

    def zeros(p, s):
        return torch.zeros(s.shard_shape(p.shape), dtype=torch.float32, device=p.device)

    return {
        "master": tree_map(lambda p, s: shard_local(p.to(torch.float32), s), params, shardings["master"]),
        "m": tree_map(zeros, params, shardings["m"]),
        "v": tree_map(zeros, params, shardings["v"]),
    }


def init_error_feedback(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def _split_over(sharding) -> Tuple[str, ...]:
    """The data axes a placement splits an optimizer-state leaf over (none
    without a placement, or on an ``{axis: size}`` mesh)."""
    if sharding is None or isinstance(sharding.mesh, Mapping):
        return ()
    return tuple(a for a in sharding.sharded_axes() if a in ("pod", "data"))


def compress_decompress(
    g: torch.Tensor, residual: Optional[torch.Tensor], sharding=None
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """int8 per-tensor scale quantization with error feedback.

    Returns (dequantized gradient to feed the collective path, new residual).
    ``g`` may be a process's block of the tensor placed by ``sharding``
    (a ``NamedSharding``): the scale is then the max over the whole tensor,
    taken over the data processes that split it.
    """
    gf = g.float()
    if residual is not None:
        gf = gf + residual
    peak = gf.abs().max()
    if _split_over(sharding):
        pdist.all_reduce(peak, sharding.mesh, _split_over(sharding), op=dist.ReduceOp.MAX)
    scale = torch.clamp(peak, min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    new_residual = gf - deq if residual is not None else None
    return deq.to(g.dtype), new_residual


def _lr_schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    return cfg.lr * warm


def adamw_update(
    cfg: OptConfig,
    grads: Any,
    opt_state: Dict[str, Any],
    step: torch.Tensor,
    param_dtype=torch.bfloat16,
    shardings: Optional[Any] = None,
) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step.  Returns (new params in ``param_dtype``, the opt state, metrics).

    ``step`` is a 0-d integer tensor.  ``opt_state``'s tensors are updated in
    place and returned in the same dict; the params are new tensors, at the
    state's placement.  ``shardings`` is the master's ``NamedSharding`` tree
    over a ``DeviceMesh`` when the state and the gradients are this process's
    blocks (see the module note).
    """
    flat_g = tree_leaves(grads)
    split = [_split_over(s) for s in tree_leaves(shardings)] if shardings is not None else [()] * len(flat_g)

    # global-norm clip: the squares summed leaf by leaf in the reference's leaf
    # order; the blocks of leaves the data processes split, summed over them
    sq, sq_split = 0, {}
    for g, axes in zip(flat_g, split):
        g32 = g.float()
        if axes:
            sq_split[axes] = sq_split.get(axes, 0) + torch.sum(g32 * g32)
        else:
            sq = sq + torch.sum(g32 * g32)
    if sq_split:
        mesh = tree_leaves(shardings)[0].mesh
        for axes in sorted(sq_split):
            sq = sq + pdist.all_reduce(sq_split[axes], mesh, axes)
    gnorm = torch.sqrt(sq + 1e-30)
    clip = torch.clamp(cfg.grad_clip / gnorm, max=1.0)

    lr = _lr_schedule(cfg, step)
    t = (step + 1).float()
    bc1 = 1.0 - cfg.b1**t
    bc2 = 1.0 - cfg.b2**t

    master = opt_state["master"]
    for p, m, v, g in zip(tree_leaves(master), tree_leaves(opt_state["m"]), tree_leaves(opt_state["v"]), flat_g):
        g32 = g.float() * clip
        m.mul_(cfg.b1).add_(g32, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g32, g32, value=1 - cfg.b2)
        del g32
        upd = m / bc1
        upd.div_((v / bc2).sqrt_().add_(cfg.eps))
        upd.add_(p, alpha=cfg.weight_decay)
        p.sub_(upd.mul_(lr))
        del upd
    params = tree_map(lambda p: p.to(param_dtype, copy=True), master)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
