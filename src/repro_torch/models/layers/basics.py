"""Norms, activations, rotary embeddings, embeddings, MLP.

Counterpart of ``repro/models/layers/basics.py``.  All layers are plain
functions over explicit parameter trees (dicts of tensors): ``init_*`` builds
parameters from a ``torch.Generator``, the ``apply`` semantics are the JAX
package's.  Norms and rope angles are float32 inside and cast back.

Over ``model`` (a ``repro_torch.parallel.sharding.Shards`` beside the
parameters; None on one process): a column-split projection gives this
process's block of output features, a row-split one (:func:`dense_rows`)
takes that block and sums the partial products over ``model``, then adds
its bias once; the MLP is the pair; the vocab-split embedding looks up the
ids of its rows and sums over ``model``; the vocab-split unembedding gives
this process's block of logits, and :func:`greedy` takes the argmax across
the blocks.  Which block a process holds is read from each leaf's spec
(``Shards.held``); a whole leaf (its dimension does not split the axis) is
sliced to the block the layer needs (:func:`take`).

With gradients (training over ``model``) the collectives are the ones
autograd sees (``repro_torch.parallel.sharding``'s module note): the MLP's
input enters its hidden block through (f), a row-split projection's and the
embedding's sums are (g), and a whole leaf sliced to a block passes (f)
before the slice, so that its gradient sums every process's block of it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.parallel import dist as pdist
from repro_torch.parallel.sharding import Shards, Spec, enter, entry_axes, held, sub

__all__ = [
    "rmsnorm",
    "layernorm",
    "init_norm",
    "apply_norm",
    "rope_frequencies",
    "apply_rope",
    "init_dense",
    "dense",
    "init_mlp",
    "mlp_apply",
    "take",
    "take_cols",
    "dense_rows",
    "greedy",
    "whole_logits",
    "init_embedding",
    "embed",
    "unembed",
]

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------


def init_norm(kind: str, dim: int, device=None) -> Params:
    p = {"scale": torch.ones((dim,), dtype=torch.float32, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((dim,), dtype=torch.float32, device=device)
    return p


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale).to(dt)


def layernorm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    return (((x - mu) * torch.rsqrt(var + eps)) * scale + bias).to(dt)


def apply_norm(p: Params, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "layernorm":
        return layernorm(x, p["scale"], p["bias"])
    return rmsnorm(x, p["scale"])


# ---------------------------------------------------------------------------
# Rotary position embeddings (with partial-rotary support)
# ---------------------------------------------------------------------------


def rope_frequencies(
    head_dim: int, fraction: float, theta: float, device=None
) -> Tuple[int, torch.Tensor]:
    """Returns (rot_dim, inv_freq[rot_dim//2]) for partial rotary."""
    rot_dim = int(head_dim * fraction) // 2 * 2
    if rot_dim == 0:
        return 0, torch.zeros((0,), dtype=torch.float32, device=device)
    exponent = torch.arange(0, rot_dim, 2, dtype=torch.float32, device=device) / rot_dim
    return rot_dim, 1.0 / (theta**exponent)


def apply_rope(
    x: torch.Tensor,
    positions: torch.Tensor,
    rot_dim: int,
    inv_freq: torch.Tensor,
) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: broadcastable to (..., seq).

    Split-half layout on the first ``rot_dim`` dims; the rest pass through.
    """
    if rot_dim == 0:
        return x
    dt = x.dtype
    xr, xp = x[..., :rot_dim], x[..., rot_dim:]
    angles = positions[..., :, None].float() * inv_freq  # (..., s, rd/2)
    cos = torch.cos(angles)[..., None, :]  # (..., s, 1, rd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(xr.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(dt), xp], dim=-1)


# ---------------------------------------------------------------------------
# Dense / MLP
# ---------------------------------------------------------------------------


def _normal(gen: torch.Generator, shape, scale: float, dtype, device) -> torch.Tensor:
    """``N(0, scale^2)`` drawn on ``device`` (the generator's own by default), in place."""
    device = gen.device if device is None else device
    return torch.randn(shape, generator=gen, dtype=dtype, device=device).mul_(scale)


def init_dense(
    gen: torch.Generator,
    d_in: int,
    d_out: int,
    *,
    bias: bool = False,
    scale: Optional[float] = None,
    dtype=torch.float32,
    device=None,
) -> Params:
    scale = scale if scale is not None else d_in**-0.5
    p = {"w": _normal(gen, (d_in, d_out), scale, dtype, device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=p["w"].device)
    return p


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with ``w`` kept as ``(d_in, d_out)``: not ``nn.Linear``'s layout."""
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def take(leaf: torch.Tensor, shards: Optional[Shards], key, dim: int, part: slice) -> torch.Tensor:
    """``leaf`` (at ``key`` under ``shards``) restricted to ``part`` of its
    dimension ``dim``: the leaf itself where its own block is ``part``, a
    view of ``part`` where it is whole.  Any other block is refused: the
    layer and the spec disagree.  A whole leaf's slice is this process's
    own work: its gradient is summed over ``model`` (f)."""
    got, whole = held(shards, key, leaf, dim)
    if got == part:
        return leaf
    if got == slice(0, whole):
        return enter(shards, leaf).narrow(dim, part.start, part.stop - part.start)
    raise ValueError(f"{key}: this process holds {got} of dimension {dim}, the layer needs {part}")


def take_cols(p: Params, shards: Optional[Shards], part: slice) -> Params:
    """A projection ``{"w", "b"?}`` restricted to its output features ``part``."""
    out = {"w": take(p["w"], shards, "w", 1, part)}
    if "b" in p:
        out["b"] = take(p["b"], shards, "b", 0, part)
    return out


def dense_rows(p: Params, x: torch.Tensor, part: slice, whole: int, shards: Optional[Shards],
               reduce: bool = True) -> torch.Tensor:
    """``dense(p, x)`` where ``x`` holds the input features ``part`` of
    ``whole``: a row-split projection (``wo``, ``down``, ``out_proj``).  The
    partial products of the model processes are summed (``all_reduce``, (g)),
    then the bias is added once.  With ``reduce=False`` the partial sum is
    returned for the caller to reduce with others, the bias in model process
    0's alone: every process adds it times 1 or 0 and passes it through (f),
    so that its gradient, which only process 0's product carries, is whole
    on each.  Where ``part`` is the whole, this is ``dense``."""
    if part == slice(0, whole):
        return dense(p, x)
    y = x @ take(p["w"], shards, "w", 0, part).to(x.dtype)
    if reduce:
        y = shards.reduce(y)
        if "b" in p:
            y = y + p["b"].to(x.dtype)
    elif "b" in p:
        y = y + shards.enter(p["b"]).to(x.dtype) * float(shards.model_index == 0)
    return y


def init_mlp(
    gen: torch.Generator, d_model: int, d_ff: int, act: str, dtype=torch.float32, device=None
) -> Params:
    p = {
        "up": init_dense(gen, d_model, d_ff, dtype=dtype, device=device),
        "down": init_dense(gen, d_ff, d_model, dtype=dtype, device=device),
    }
    if act == "swiglu":
        p["gate"] = init_dense(gen, d_model, d_ff, dtype=dtype, device=device)
    return p


def mlp_apply(p: Params, x: torch.Tensor, act: str, shards: Optional[Shards] = None,
              reduce: bool = True) -> torch.Tensor:
    """The MLP; over ``model`` ``up``/``gate`` give this process's hidden
    block, which ``x`` enters through (f), and ``down`` takes it
    (``dense_rows``; ``reduce`` as there)."""
    part, whole = held(sub(shards, "up"), "w", p["up"]["w"], 1)
    if part != slice(0, whole):
        x = shards.enter(x)
    if act == "swiglu":
        h = F.silu(dense(take_cols(p["gate"], sub(shards, "gate"), part), x)) * dense(p["up"], x)
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(dense(p["up"], x), approximate="tanh")
    return dense_rows(p["down"], h, part, whole, sub(shards, "down"), reduce)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def init_embedding(
    gen: torch.Generator, vocab: int, d_model: int, dtype=torch.float32, device=None
) -> Params:
    return {"table": _normal(gen, (vocab, d_model), 0.02, dtype, device)}


def embed(p: Params, tokens: torch.Tensor, dtype=torch.bfloat16, shards: Optional[Shards] = None) -> torch.Tensor:
    """Rows of the table.  The JAX function's custom backward
    (``_embed_lookup_bwd``) scatter-adds the rows' gradients into a float32
    table and casts it to the table's type, only so that it can constrain the
    buffer's sharding.  On one device PyTorch's autograd of the lookup
    computes the same sums, a scatter-add of the rows' gradients
    (``index_put_`` with ``accumulate``).  In float32 the values are the
    same; in bf16 a token's repeats may be summed in another precision
    before the table's type is reached.

    With the table's vocabulary split over ``model``, each process looks up
    the ids in its rows, zeros for the rest, and the rows are summed over
    ``model`` (g): one non-zero term each, exact.
    """
    rows, whole = held(shards, "table", p["table"], 0)
    if rows == slice(0, whole):
        return p["table"][tokens].to(dtype)
    local = tokens - rows.start
    inside = (local >= 0) & (local < rows.stop - rows.start)
    found = p["table"][local.clamp(0, rows.stop - rows.start - 1)].to(dtype)
    return shards.reduce(torch.where(inside[..., None], found, torch.zeros_like(found)))


def unembed(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Project to vocabulary logits (used for tied or dedicated lm_head).
    With the table split over ``model``: this process's block of the
    vocabulary, the one its rows of the table give."""
    return x @ p["table"].to(x.dtype).T


def _vocab_block(logits: torch.Tensor, shards: Optional[Shards]) -> Optional[slice]:
    """The block of the vocabulary ``logits`` holds over ``model`` (None: all of it)."""
    spec = Spec() if shards is None else shards.spec("table")
    if not spec or "model" not in entry_axes(spec[0]) or shards.model == 1:
        return None
    return shards.block("table", 0, logits.shape[-1] * shards.model)


def whole_logits(logits: torch.Tensor, shards: Optional[Shards] = None) -> torch.Tensor:
    """``(b, vocab)`` logits over the whole vocabulary from every model
    process's block (``logits``, this one's; see :func:`greedy`)."""
    rows = _vocab_block(logits, shards)
    return logits if rows is None else shards.gather(logits, logits.dim() - 1, rows, logits.shape[-1] * shards.model)


def greedy(logits: torch.Tensor, shards: Optional[Shards] = None) -> torch.Tensor:
    """The greedy token of each row, ``int32``: ``jnp.argmax`` over the whole
    vocabulary, the lowest index among ties.  ``logits`` is this process's
    block of the vocabulary by the head table's spec at ``shards`` (the
    head's shards, beside ``{"table": ...}``): the block's maximum and its
    first index, the maximum over ``model``, and the lowest index among the
    blocks that reach it, by two ``all_reduce``s."""
    rows = _vocab_block(logits, shards)
    if rows is None:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    top, index = torch.max(logits, dim=-1)
    best = shards.psum(top.clone(), pdist.dist.ReduceOp.MAX)
    first = torch.where(top == best, index + rows.start, torch.full_like(index, torch.iinfo(index.dtype).max))
    return shards.psum(first, pdist.dist.ReduceOp.MIN).to(torch.int32)
