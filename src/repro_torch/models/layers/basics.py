"""Norms, activations, rotary embeddings, embeddings, MLP.

Counterpart of ``repro/models/layers/basics.py``.  All layers are plain
functions over explicit parameter trees (dicts of tensors): ``init_*`` builds
parameters from a ``torch.Generator``, the ``apply`` semantics are the JAX
package's.  Norms and rope angles are float32 inside and cast back.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

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


def mlp_apply(p: Params, x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "swiglu":
        h = F.silu(dense(p["gate"], x)) * dense(p["up"], x)
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(dense(p["up"], x), approximate="tanh")
    return dense(p["down"], h)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def init_embedding(
    gen: torch.Generator, vocab: int, d_model: int, dtype=torch.float32, device=None
) -> Params:
    return {"table": _normal(gen, (vocab, d_model), 0.02, dtype, device)}


def embed(p: Params, tokens: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Rows of the table.  The JAX function's custom backward
    (``_embed_lookup_bwd``) scatter-adds the rows' gradients into a float32
    table and casts it to the table's type, only so that it can constrain the
    buffer's sharding.  On one device PyTorch's autograd of the lookup
    computes the same sums, a scatter-add of the rows' gradients
    (``index_put_`` with ``accumulate``).  In float32 the values are the
    same; in bf16 a token's repeats may be summed in another precision
    before the table's type is reached.
    """
    return p["table"][tokens].to(dtype)


def unembed(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Project to vocabulary logits (used for tied or dedicated lm_head)."""
    return x @ p["table"].to(x.dtype).T
