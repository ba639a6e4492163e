"""Model / run configuration system (jax-free copy of ``repro/configs/base.py``).

The dataclasses, their fields, defaults and methods are those of the JAX
package, so a config of one package equals the other's field by field.
``input_specs`` gives the step functions' inputs as ``meta`` tensors (shape
and type, no storage), where the JAX function gives ``ShapeDtypeStruct``s.

One :class:`ModelConfig` dataclass covers all ten assigned architecture
families (dense / GQA / MLA / MoE / SSM / hybrid / audio / vlm backbones).
``registry.py`` holds the exact published numbers of each architecture and a
reduced same-family variant for CPU tests.

Input shapes (assigned): ``train_4k``, ``prefill_32k``, ``decode_32k``,
``long_500k`` -- see :data:`SHAPES`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

__all__ = [
    "MoEConfig",
    "MLAConfig",
    "SSMConfig",
    "ModelConfig",
    "ShapeConfig",
    "SHAPES",
    "input_specs",
    "shape_applicable",
    "sync_policy_choices",
    "validate_sync_policy",
]


def sync_policy_choices() -> Tuple[str, ...]:
    """Registered ``repro_torch.sync`` policy names -- the valid values for
    every sync-policy config field / CLI flag (launchers build argparse
    choices from this, so new registered disciplines appear everywhere at
    once)."""
    from repro_torch.sync import available_policies  # deferred: keep configs light

    return available_policies()


def validate_sync_policy(name: str) -> str:
    """Canonicalize a sync-policy config value against the registry.

    Returns the canonical (lowercase) registered name; raises ``KeyError``
    naming the available policies for anything unknown.
    """
    from repro_torch.sync import canonical_name  # deferred: keep configs light

    return canonical_name(name)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int  # routed experts
    top_k: int
    d_ff_expert: int  # per-expert FFN hidden size
    n_shared: int = 0  # shared (always-on) experts, deepseek-style
    first_k_dense: int = 0  # leading dense layers (deepseek-v2: 1)
    every_k: int = 1  # MoE layer every k-th layer (jamba: 2)
    capacity_factor: float = 1.25
    router_norm_topk: bool = True  # renormalize top-k weights


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    # --- normalization / residual topology ----------------------------------
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    parallel_block: bool = False  # command-r: attn and MLP in parallel
    act: str = "swiglu"  # swiglu | gelu
    qkv_bias: bool = False
    qk_norm: bool = False  # qwen3-style per-head RMSNorm on q/k
    tie_embeddings: bool = False
    # --- positions -----------------------------------------------------------
    use_rope: bool = True
    rope_fraction: float = 1.0  # partial rotary (phi-4: 0.75, stablelm: 0.25)
    rope_theta: float = 10_000.0
    # --- mixture / attention variants / ssm ----------------------------------
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_every: int = 1  # hybrid (jamba): attention layer every k-th, SSM else
    # --- modality frontend (stub: precomputed embeddings) ---------------------
    frontend: Optional[str] = None  # audio | vision
    # --- numerics -------------------------------------------------------------
    dtype: str = "bfloat16"  # activation / weight compute dtype
    # --- scan over layers -----------------------------------------------------
    scan_layers: bool = True
    block_group: int = 1  # layers per scan step (jamba: 8)
    # --- perf variants (§Perf hillclimb levers) --------------------------------
    moe_shard_hints: bool = False  # constrain MoE dispatch to EP sharding


    # ------------------------------------------------------------------ utils
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def layer_kind(self, layer_idx: int) -> str:
        """'attn' or 'ssm' mixer for layer ``layer_idx``."""
        if self.family == "ssm":
            return "ssm"
        if self.family == "hybrid":
            # jamba: one attention layer per group of ``attn_every`` layers
            # (placed in the middle of the group, as in the released model)
            return "attn" if layer_idx % self.attn_every == self.attn_every // 2 else "ssm"
        return "attn"

    def layer_is_moe(self, layer_idx: int) -> bool:
        if self.moe is None:
            return False
        if layer_idx < self.moe.first_k_dense:
            return False
        return (layer_idx - self.moe.first_k_dense) % self.moe.every_k == 0

    def n_params(self) -> int:
        """Approximate parameter count (embeddings included once)."""
        d, h, kv, hd = self.d_model, self.n_heads, self.n_kv_heads, self.resolved_head_dim
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        for i in range(self.n_layers):
            if self.layer_kind(i) == "attn":
                if self.mla is not None:
                    m = self.mla
                    total += d * h * (m.qk_nope_dim + m.qk_rope_dim)  # W_q
                    total += d * (m.kv_lora_rank + m.qk_rope_dim)  # W_dkv + W_kr
                    total += m.kv_lora_rank * h * (m.qk_nope_dim + m.v_head_dim)
                    total += h * m.v_head_dim * d  # W_o
                else:
                    total += d * (h + 2 * kv) * hd + h * hd * d
            else:
                s = self.ssm
                d_in = s.expand * d
                conv_dim = d_in + 2 * s.n_groups * s.d_state
                n_h = d_in // s.head_dim
                total += d * (2 * d_in + 2 * s.n_groups * s.d_state + n_h)  # in_proj
                total += conv_dim * s.d_conv + d_in * d + 2 * n_h  # conv, out, A/D
            if self.layer_is_moe(i):
                m = self.moe
                total += m.n_experts * 3 * d * m.d_ff_expert
                total += m.n_shared * 3 * d * m.d_ff_expert
                total += d * m.n_experts  # router
            else:
                mult = 3 if self.act == "swiglu" else 2
                total += mult * d * self.d_ff
        return total

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: only top-k experts count)."""
        if self.moe is None:
            return self.n_params()
        m = self.moe
        total = self.n_params()
        # subtract the inactive routed experts' weights
        n_moe_layers = sum(self.layer_is_moe(i) for i in range(self.n_layers))
        inactive = (m.n_experts - m.top_k) * 3 * self.d_model * m.d_ff_expert
        return total - n_moe_layers * inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether (arch x shape) is a runnable cell (assignment rules)."""
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, (
            "long_500k needs sub-quadratic attention; "
            f"{cfg.name} is a full-attention arch (skip per assignment)"
        )
    return True, ""


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """``meta`` tensors (shape and type, no storage) for every model input of
    the step function, the global batch.

    ``train``/``prefill``: token ids + labels (or stub embeddings for
    audio/vlm frontends).  ``decode``: one new token per sequence plus the
    current position; the KV/SSM cache is part of the step *state*
    (``serve.decode.cache_shapes``).
    """
    b, s = shape.global_batch, shape.seq_len

    def meta(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        if cfg.frontend is not None:
            # modality stub: precomputed frame/patch embeddings
            return {"embeddings": meta((b, s, cfg.d_model), torch.bfloat16), "labels": meta((b, s), torch.int32)}
        return {"tokens": meta((b, s), torch.int32), "labels": meta((b, s), torch.int32)}
    # decode: one token step against a cache of length s
    return {"tokens": meta((b, 1), torch.int32), "position": meta((b,), torch.int32)}
