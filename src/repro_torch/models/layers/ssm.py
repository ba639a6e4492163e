"""Mamba-2 (SSD -- state-space duality) mixer layer.

Counterpart of ``repro/models/layers/ssm.py``: the chunked "dual" form of the
SSD recurrence (Dao & Gu, 2024, arXiv:2405.21060 Listing 1), the
token-by-token recurrence, the causal depthwise conv, the mixer and its
single-token decode step, with the reference's dtype rules (decay, cumsum and
state in float32; ``dt`` softplus in float32; ``y`` cast back to ``x.dtype``
once, at the end).

``ssm_apply`` runs its scan through ``kernels/ssd_scan/ops.ssd_scan``: the
Hopper kernel for a CUDA tensor, ``ssd_chunked`` (through the kernel's plain
version) for a CPU tensor.  ``ssd_chunked`` here is that plain version's core
and the oracle of the tests.

Over ``model`` (a ``Shards`` beside the parameters): ``in_z``, ``in_x``,
``conv_x``, ``conv_bx`` and ``norm_scale`` are split by channel, a whole
number of heads a process; ``in_B``, ``in_C``, ``in_dt``, ``A_log``, ``D``
and ``dt_bias`` are whole, and each process takes its heads of them.  The
scan runs on the local heads.  The gated RMSNorm normalises over the whole
``d_inner``, so its mean of squares is summed over ``model`` before the
scale; ``out_proj`` is row-split, its partial products summed over
``model``.  The decode cache's SSD state is split by heads and its conv
window is whole (``cache_specs``): a step reads its channels of the window
and gathers its new channels into the whole one.

With gradients (``parallel/sharding.py``'s module note): the input enters
the split projections (``in_z``, ``in_x`` and this process's heads of
``in_dt``) through (f); ``B`` and ``C``, whole after their conv, enter the
local heads' scan through (f), so that ``in_B``, ``in_C`` and their conv
see every head; ``in_dt``, ``A_log``, ``D`` and ``dt_bias`` pass (f) as
whole leaves sliced to the local heads; the gated norm's mean of squares
is (s), since each process scales its own channels by the whole of it;
``out_proj``'s sum is (g).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.parallel.sharding import Shards, enter, held, sub
from .basics import _normal, dense, dense_rows, init_dense, take, take_cols

Params = Dict[str, torch.Tensor]

__all__ = [
    "init_ssm",
    "ssm_apply",
    "ssd_chunked",
    "ssd_recurrent",
    "ssm_decode_step",
    "ssm_state_shapes",
]


def _dims(cfg: ModelConfig) -> Tuple[int, int, int, int, int]:
    s: SSMConfig = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return d_inner, n_heads, conv_dim, s.n_groups, s.d_state


def init_ssm(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32, device=None) -> Params:
    """Same tree, shapes and scales as the JAX ``init_ssm``; the numbers differ."""
    s: SSMConfig = cfg.ssm
    d = cfg.d_model
    d_inner, n_heads, conv_dim, g, n = _dims(cfg)
    kw = dict(dtype=dtype, device=device)
    p: Params = {
        "in_z": init_dense(gen, d, d_inner, **kw),
        "in_x": init_dense(gen, d, d_inner, **kw),
        "in_B": init_dense(gen, d, g * n, **kw),
        "in_C": init_dense(gen, d, g * n, **kw),
        "in_dt": init_dense(gen, d, n_heads, **kw),
        "conv_x": _normal(gen, (s.d_conv, d_inner), 0.2, dtype, device),
        "conv_B": _normal(gen, (s.d_conv, g * n), 0.2, dtype, device),
        "conv_C": _normal(gen, (s.d_conv, g * n), 0.2, dtype, device),
    }
    dev = p["in_z"]["w"].device
    f32 = dict(dtype=torch.float32, device=dev)
    p.update({
        "conv_bx": torch.zeros((d_inner,), dtype=dtype, device=dev),
        "conv_bB": torch.zeros((g * n,), dtype=dtype, device=dev),
        "conv_bC": torch.zeros((g * n,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, n_heads, **f32)),
        "D": torch.ones((n_heads,), **f32),
        "dt_bias": torch.zeros((n_heads,), **f32),
        "norm_scale": torch.ones((d_inner,), **f32),
        "out_proj": init_dense(gen, d_inner, d, scale=d_inner**-0.5, **kw),
    })  # fmt: skip
    return p


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: out[..., i, j] = sum_{k=j+1..i} x[..., k] (j <= i), -inf above."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    return out.masked_fill(~mask, -torch.inf)


def ssd_chunked(
    x: torch.Tensor,  # (b, s, h, p)
    dt: torch.Tensor,  # (b, s, h)  (positive, post-softplus)
    A: torch.Tensor,  # (h,)       (negative)
    B: torch.Tensor,  # (b, s, g, n)
    C: torch.Tensor,  # (b, s, g, n)
    chunk: int,
    initial_state: Optional[torch.Tensor] = None,  # (b, h, p, n)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD ("matmul" dual form).  Returns (y (b,s,h,p), final_state f32)."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    assert s % chunk == 0, f"seq {s} % chunk {chunk} != 0"
    nc = s // chunk
    rep = h // g  # heads per B/C group

    f32 = torch.float32
    xb = (x * dt[..., None]).reshape(b, nc, chunk, h, p).float()  # dt-weighted input
    Bh = B.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3).float()  # (b, nc, Q, h, n)
    Ch = C.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3).float()

    dA = (dt.to(f32) * A.to(f32)).reshape(b, nc, chunk, h).movedim(-1, 2)  # (b, nc, h, Q)
    dA_cum = torch.cumsum(dA, dim=-1)  # within-chunk cumulative

    # ---- diagonal (within-chunk) part: attention-like with decay kernel ----
    L = torch.exp(_segsum(dA))  # (b, nc, h, Q, Q)
    scores = torch.einsum("bcqhn,bckhn->bchqk", Ch, Bh)
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", scores * L, xb)

    # ---- chunk states: decay-weighted B^T x over each chunk -----------------
    decay_states = torch.exp(dA_cum[..., -1:] - dA_cum)  # (b, nc, h, Q)
    states = torch.einsum("bckhn,bckhp->bchpn", Bh, xb * decay_states.movedim(2, 3)[..., None])

    # ---- inter-chunk recurrence over compressed states ---------------------
    chunk_decay = torch.exp(dA_cum[..., -1])  # (b, nc, h)
    carry = (
        torch.zeros((b, h, p, n), dtype=f32, device=x.device)
        if initial_state is None
        else initial_state.to(f32)
    )
    prev = []
    for c in range(nc):
        prev.append(carry)  # the state *entering* chunk c
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)  # (b, nc, h, p, n)

    # ---- off-diagonal contribution: C @ carried state with in-chunk decay --
    state_decay = torch.exp(dA_cum)  # (b, nc, h, Q)
    y_off = torch.einsum("bcqhn,bchpn->bcqhp", Ch, prev_states) * state_decay.movedim(2, 3)[..., None]

    y = (y_diag + y_off).reshape(b, s, h, p)
    return y.to(x.dtype), carry


def ssd_recurrent(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    initial_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-by-token reference recurrence (oracle for tests + decode)."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    f32 = torch.float32
    Bh = B.repeat_interleave(rep, dim=2).to(f32)
    Ch = C.repeat_interleave(rep, dim=2).to(f32)
    st = (
        torch.zeros((b, h, p, n), dtype=f32, device=x.device)
        if initial_state is None
        else initial_state.to(f32)
    )
    ys = []
    for t in range(s):
        dtt = dt[:, t].to(f32)  # (b, h)
        dec = torch.exp(dtt * A.to(f32))
        st = st * dec[..., None, None] + torch.einsum(
            "bhp,bhn->bhpn", x[:, t].to(f32) * dtt[..., None], Bh[:, t]
        )
        ys.append(torch.einsum("bhpn,bhn->bhp", st, Ch[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), st


# ---------------------------------------------------------------------------
# Full mixer layer
# ---------------------------------------------------------------------------


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  x: (b, s, c); w: (d_conv, c)."""
    s = x.shape[1]
    d_conv = w.shape[0]
    xp = F.pad(x, (0, 0, d_conv - 1, 0))
    out = sum(xp[:, i : i + s, :] * w[i][None, None, :] for i in range(d_conv))
    return F.silu(out + b.to(x.dtype))


def _project(p: Params, cfg: ModelConfig, x: torch.Tensor, local, x_bc: Optional[torch.Tensor] = None):
    """Shared projection path for full-seq and decode: this process's
    channels of ``z`` and ``x`` and its heads of ``dt`` (``local``, from
    :func:`_local`; all of them on one process).  ``x_bc`` (default ``x``)
    feeds the whole ``in_B`` and ``in_C``."""
    channels, heads, shards = local
    x_bc = x if x_bc is None else x_bc
    z = dense(take_cols(p["in_z"], sub(shards, "in_z"), channels), x)
    xs = dense(p["in_x"], x)
    B = dense(p["in_B"], x_bc)
    C = dense(p["in_C"], x_bc)
    dt = dense(take_cols(p["in_dt"], sub(shards, "in_dt"), heads), x)
    return z, xs, B, C, dt


def _local(p: Params, cfg: ModelConfig, shards: Optional[Shards]):
    """(this process's channels of ``d_inner``, its heads, ``shards``): the
    block of ``in_x``, a whole number of heads."""
    channels, d_inner = held(sub(shards, "in_x"), "w", p["in_x"]["w"], 1)
    hd = cfg.ssm.head_dim
    if channels.start % hd or channels.stop % hd:
        raise ValueError(f"in_x: the block {channels} of {d_inner} channels cuts a head of {hd}")
    return channels, slice(channels.start // hd, channels.stop // hd), shards


def _heads_of(p: Params, shards: Optional[Shards], heads: slice):
    """``A`` (negative), ``D`` and ``dt_bias`` of this process's heads."""
    A_log, D, dt_bias = (take(p[k], shards, k, 0, heads) for k in ("A_log", "D", "dt_bias"))
    return -torch.exp(A_log), D, dt_bias


def _gated_norm(p: Params, y: torch.Tensor, z: torch.Tensor, channels: slice, d_inner: int,
                shards: Optional[Shards], eps: float = 1e-6) -> torch.Tensor:
    """Mamba-2's gated RMSNorm over the whole ``d_inner``: ``rmsnorm(y *
    silu(z))``.  Where ``y`` holds a block of the channels, each block's mean
    of squares is weighted by its share of ``d_inner`` and summed over
    ``model`` (s); whole, the weight is 1 and the formula is ``rmsnorm``'s."""
    scale = take(p["norm_scale"], shards, "norm_scale", 0, channels)
    dt = y.dtype
    v = (y * F.silu(z)).float()
    ms = torch.mean(v * v, dim=-1, keepdim=True) * (v.shape[-1] / d_inner)
    if channels != slice(0, d_inner):
        ms = shards.reduce_both(ms)
    return (v * torch.rsqrt(ms + eps) * scale).to(dt)


def ssm_apply(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,
    state_sink: Optional[Dict[str, torch.Tensor]] = None,
    shards: Optional[Shards] = None,
) -> torch.Tensor:
    """Full-sequence Mamba-2 mixer.  x: (b, s, d_model).

    ``state_sink``, when given, receives the layer's decode state: ``"ssm"``,
    the scan's final state (b, h, p, n) float32, and ``"conv"``, the last
    ``d_conv - 1`` inputs of the conv (b, d_conv - 1, conv_dim), zeros before
    the first token.  Prefill fills its cache from them, so the scan runs once.
    Over ``model`` both are whole: every head, every channel.
    """
    # imported here: the kernel's plain version (ops -> ref) imports ssd_chunked from this module
    from repro_torch.kernels.ssd_scan.ops import ssd_scan

    s_cfg: SSMConfig = cfg.ssm
    b, s, _ = x.shape
    d_inner, n_heads, conv_dim, g, n = _dims(cfg)

    local = _local(p, cfg, shards)
    channels, heads, _ = local
    split = channels != slice(0, d_inner)
    z, xs, B, C, dt = _project(p, cfg, enter(shards, x) if split else x, local, x)
    if state_sink is not None:
        w = s_cfg.d_conv - 1
        tail = F.pad(torch.cat([xs, B, C], dim=-1), (0, 0, max(0, w - s), 0))[:, -w:]
        if shards is not None:
            n_x = channels.stop - channels.start
            tail = torch.cat([shards.gather(tail[..., :n_x], 2, channels, d_inner), tail[..., n_x:]], dim=-1)
        state_sink["conv"] = tail
    xs = _causal_conv(xs, take(p["conv_x"], shards, "conv_x", 1, channels).to(xs.dtype),
                      take(p["conv_bx"], shards, "conv_bx", 0, channels))  # fmt: skip
    B = _causal_conv(B, p["conv_B"].to(B.dtype), p["conv_bB"])
    C = _causal_conv(C, p["conv_C"].to(C.dtype), p["conv_bC"])
    if split:  # whole, read by this process's heads alone
        B, C = shards.enter(B), shards.enter(C)

    xs = xs.reshape(b, s, heads.stop - heads.start, s_cfg.head_dim)
    B = B.reshape(b, s, g, n)
    C = C.reshape(b, s, g, n)
    A, D, dt_bias = _heads_of(p, shards, heads)
    dtv = F.softplus(dt.float() + dt_bias)  # (b, s, h)

    y, final_state = ssd_scan(xs, dtv, A, B, C, chunk=min(s_cfg.chunk, s))
    if state_sink is not None:
        state_sink["ssm"] = final_state if shards is None else shards.gather(final_state, 1, heads, n_heads)
    y = y + xs * D.to(y.dtype)[None, None, :, None]
    y = y.reshape(b, s, -1)
    # gated RMSNorm (mamba2)
    y = _gated_norm(p, y, z, channels, d_inner, shards)
    return dense_rows(p["out_proj"], y, channels, d_inner, sub(shards, "out_proj"))


# ---------------------------------------------------------------------------
# Decode (single-token recurrent step)
# ---------------------------------------------------------------------------


def ssm_state_shapes(cfg: ModelConfig, batch: int) -> Dict[str, Tuple[int, ...]]:
    s: SSMConfig = cfg.ssm
    d_inner, n_heads, conv_dim, g, n = _dims(cfg)
    return {
        "ssm": (batch, n_heads, s.head_dim, n),
        "conv": (batch, s.d_conv - 1, conv_dim),
    }


def ssm_decode_step(
    p: Params, cfg: ModelConfig, x: torch.Tensor, state: Dict[str, torch.Tensor], shards: Optional[Shards] = None
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token step.  x: (b, 1, d); state: {'ssm': (b,h,p,n), 'conv': ...}.

    Returns the output and the new state (fresh tensors; ``state`` is not
    written).  Over ``model`` the ``ssm`` state holds this process's heads
    and ``conv`` is whole (``cache_specs``), as is the new one.
    """
    s_cfg: SSMConfig = cfg.ssm
    b = x.shape[0]
    d_inner, n_heads, conv_dim, g, n = _dims(cfg)
    local = _local(p, cfg, shards)
    channels, heads, _ = local
    n_x = channels.stop - channels.start
    if state["ssm"].shape[1] != heads.stop - heads.start:
        raise ValueError(f"the SSD state holds {state['ssm'].shape[1]} heads, this process's projections "
                         f"{heads.stop - heads.start}: the cache and the parameters are placed differently")

    z, xs, B, C, dt = _project(p, cfg, x, local)
    xc = torch.cat([xs, B, C], dim=-1)  # conv channel layout (x|B|C)
    window = state["conv"]
    if n_x != d_inner:  # this process's x channels of the whole window, and B|C
        window = torch.cat([window[..., channels], window[..., d_inner:]], dim=-1)
    hist = torch.cat([window.to(xc.dtype), xc], dim=1)
    conv_x = take(p["conv_x"], shards, "conv_x", 1, channels)
    conv_bx = take(p["conv_bx"], shards, "conv_bx", 0, channels)
    w = torch.cat([conv_x, p["conv_B"], p["conv_C"]], dim=-1).to(xc.dtype)
    bias = torch.cat([conv_bx, p["conv_bB"], p["conv_bC"]])
    conv = torch.einsum("btc,tc->bc", hist, w)[:, None, :] + bias.to(xc.dtype)
    conv = F.silu(conv)
    new_conv_state = hist[:, 1:, :]
    if n_x != d_inner:
        new_conv_state = torch.cat([shards.gather(new_conv_state[..., :n_x], 2, channels, d_inner),
                                    new_conv_state[..., n_x:]], dim=-1)  # fmt: skip

    xs = conv[..., :n_x]
    B = conv[..., n_x : n_x + g * n]
    C = conv[..., n_x + g * n :]
    xs = xs.reshape(b, 1, heads.stop - heads.start, s_cfg.head_dim)
    B = B.reshape(b, 1, g, n)
    C = C.reshape(b, 1, g, n)
    A, D, dt_bias = _heads_of(p, shards, heads)
    dtv = F.softplus(dt.float() + dt_bias)

    y, new_ssm = ssd_recurrent(xs, dtv, A, B, C, initial_state=state["ssm"])
    y = y + xs * D.to(y.dtype)[None, None, :, None]
    y = y.reshape(b, 1, n_x)
    y = _gated_norm(p, y, z, channels, d_inner, shards)
    out = dense_rows(p["out_proj"], y, channels, d_inner, sub(shards, "out_proj"))
    return out, {"ssm": new_ssm, "conv": new_conv_state}
