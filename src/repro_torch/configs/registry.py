"""Architecture registry: the ten assigned configs + reduced smoke variants
(copy of ``repro/configs/registry.py``; it imports this package's ``base``).

Every entry lists the exact published configuration from the assignment
(``[source]`` per config docstring) and a ``smoke`` reduction of the same
family for CPU tests (small widths/depths/experts/vocab, same structural
features so the code paths are identical).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from .base import MLAConfig, ModelConfig, MoEConfig, SSMConfig

__all__ = ["ARCHS", "get_config", "get_smoke_config", "list_archs"]


def _mamba2_1p3b() -> ModelConfig:
    # [ssm] 48L d_model=2048 (attn-free) vocab=50280, ssm_state=128 -- SSD
    # [arXiv:2405.21060]
    return ModelConfig(
        name="mamba2-1.3b",
        family="ssm",
        n_layers=48,
        d_model=2048,
        n_heads=1,  # no attention; SSD heads derive from ssm config
        n_kv_heads=1,
        d_ff=0,  # mamba2 blocks are norm + mixer only (no FFN), per assignment
        vocab_size=50280,
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1),
        tie_embeddings=True,
        use_rope=False,
    )


def _jamba_52b() -> ModelConfig:
    # [hybrid] 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536,
    # MoE 16e top-2 -- Mamba+attn 1:7 interleave [arXiv:2403.19887]
    return ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=65536,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64, n_groups=1, chunk=128),
        moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=14336, every_k=2),
        attn_every=8,
        block_group=8,
        use_rope=False,  # jamba uses no positional embeddings (Mamba provides order)
    )


def _musicgen_medium() -> ModelConfig:
    # [audio] 48L d_model=1536 24H (kv=24) d_ff=6144 vocab=2048 -- decoder-only
    # over EnCodec tokens [arXiv:2306.05284]; frontend stubbed (embeddings in).
    return ModelConfig(
        name="musicgen-medium",
        family="audio",
        n_layers=48,
        d_model=1536,
        n_heads=24,
        n_kv_heads=24,
        d_ff=6144,
        vocab_size=2048,
        act="gelu",
        norm="layernorm",
        use_rope=False,  # sinusoidal positions
        frontend="audio",
    )


def _deepseek_v2_lite() -> ModelConfig:
    # [moe] 27L d_model=2048 16H d_ff(expert)=1408 vocab=102400, MoE 64e top-6,
    # MLA kv_lora=512, 2 shared experts, first layer dense [arXiv:2405.04434]
    return ModelConfig(
        name="deepseek-v2-lite-16b",
        family="moe",
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=192,  # qk_nope 128 + rope 64
        d_ff=10944,  # dense FFN width of the first (non-MoE) layer
        vocab_size=102400,
        mla=MLAConfig(kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
        moe=MoEConfig(
            n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2, first_k_dense=1
        ),
    )


def _qwen3_moe_30b() -> ModelConfig:
    # [moe] 48L d_model=2048 32H (GQA kv=4) d_ff(expert)=768 vocab=151936,
    # MoE 128e top-8 [hf:Qwen/Qwen3-30B-A3B]
    return ModelConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        head_dim=128,
        d_ff=768,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1_000_000.0,
        moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=768),
    )


def _command_r_plus() -> ModelConfig:
    # [dense] 64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000 --
    # parallel block, no bias [hf:CohereForAI/c4ai-command-r-plus]
    return ModelConfig(
        name="command-r-plus-104b",
        family="dense",
        n_layers=64,
        d_model=12288,
        n_heads=96,
        n_kv_heads=8,
        d_ff=33792,
        vocab_size=256000,
        parallel_block=True,
        norm="layernorm",
        tie_embeddings=True,
        rope_theta=75_000_000.0,
    )


def _phi4_mini() -> ModelConfig:
    # [dense] 32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064 --
    # RoPE (partial 0.75) SwiGLU GQA [arXiv:2412.08905]
    return ModelConfig(
        name="phi4-mini-3.8b",
        family="dense",
        n_layers=32,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=200064,
        rope_fraction=0.75,
        tie_embeddings=True,
    )


def _stablelm_3b() -> ModelConfig:
    # [dense] 32L d_model=2560 32H (kv=32) d_ff=6912 vocab=50304 --
    # LayerNorm, partial rotary 0.25 [hf:stabilityai/stablelm-3b-4e1t]
    return ModelConfig(
        name="stablelm-3b",
        family="dense",
        n_layers=32,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        d_ff=6912,
        vocab_size=50304,
        norm="layernorm",
        rope_fraction=0.25,
    )


def _codeqwen_7b() -> ModelConfig:
    # [dense] 32L d_model=4096 32H (kv=32) d_ff=13440 vocab=92416 --
    # qwen1.5 arch: QKV bias [hf:Qwen/CodeQwen1.5-7B]
    return ModelConfig(
        name="codeqwen1.5-7b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=32,
        d_ff=13440,
        vocab_size=92416,
        qkv_bias=True,
        rope_theta=1_000_000.0,
    )


def _llava_next_34b() -> ModelConfig:
    # [vlm] 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000 --
    # anyres tiling; vision frontend stubbed (patch embeddings in)
    # [hf:llava-hf/llava-v1.6-34b-hf backbone]
    return ModelConfig(
        name="llava-next-34b",
        family="vlm",
        n_layers=60,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=20480,
        vocab_size=64000,
        frontend="vision",
        rope_theta=5_000_000.0,
    )


ARCHS: Dict[str, Callable[[], ModelConfig]] = {
    "mamba2-1.3b": _mamba2_1p3b,
    "jamba-v0.1-52b": _jamba_52b,
    "musicgen-medium": _musicgen_medium,
    "deepseek-v2-lite-16b": _deepseek_v2_lite,
    "qwen3-moe-30b-a3b": _qwen3_moe_30b,
    "command-r-plus-104b": _command_r_plus,
    "phi4-mini-3.8b": _phi4_mini,
    "stablelm-3b": _stablelm_3b,
    "codeqwen1.5-7b": _codeqwen_7b,
    "llava-next-34b": _llava_next_34b,
}


def list_archs():
    return sorted(ARCHS)


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {list_archs()}")
    return ARCHS[name]()


def get_smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config: tiny widths, few layers/experts, small vocab."""
    full = get_config(name)
    kw = dict(
        name=full.name + "-smoke",
        n_layers=4 if full.block_group == 1 else full.block_group,
        d_model=64,
        d_ff=0 if full.d_ff == 0 else 128,
        vocab_size=128,
    )
    if full.family == "ssm":
        kw.update(n_heads=1, n_kv_heads=1)
    else:
        # keep the GQA ratio when possible
        ratio = max(1, full.n_heads // full.n_kv_heads)
        kw.update(n_heads=4, n_kv_heads=max(1, 4 // ratio), head_dim=16)
    if full.ssm is not None:
        kw["ssm"] = dataclasses.replace(
            full.ssm, d_state=16, head_dim=16, expand=2, n_groups=1
        )
    if full.moe is not None:
        kw["moe"] = dataclasses.replace(
            full.moe,
            n_experts=8,
            top_k=2,
            d_ff_expert=64,
            first_k_dense=min(full.moe.first_k_dense, 1),
        )
        if full.moe.first_k_dense > 0:
            kw["n_layers"] = kw["n_layers"] + 1
    if full.mla is not None:
        kw["mla"] = MLAConfig(kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)
        kw["head_dim"] = 24
    return dataclasses.replace(full, **kw)
