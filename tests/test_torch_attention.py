"""The port's attention functions against the JAX package's, on shared inputs.

Where the JAX side is the Pallas kernel it runs in interpret mode, as
``tests/test_kernels.py`` runs it.  The CUDA kernel itself has no CPU form:
``tests/test_torch_cuda_kernels.py`` holds it against ``attention_ref`` on
the card.  Tolerances: float32 2e-5 against the Pallas kernel (its own test's
figure) and 1e-5 function against function, bfloat16 2e-2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.kernels.flash_attention.kernel import flash_attention_fwd as pallas_flash_fwd
from repro.kernels.flash_attention.ops import flash_attention as jax_flash_attention
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.models.layers import attention as ja
from repro.models.layers import flash_core as jfc
from repro_torch.configs.registry import get_smoke_config
from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref, attention_ref_lse
from repro_torch.models.layers import attention as ta
from repro_torch.models.layers import flash_core as tfc

from _torch_parity import TOL, both, close, jax_to_torch_params, normal

# (b, h, kvh, s, d, block_q, block_k): the shapes of tests/test_kernels.py
KERNEL_SHAPES = [
    (1, 4, 4, 128, 64, 64, 64),  # MHA
    (2, 8, 2, 256, 64, 64, 128),  # GQA 4:1, rectangular blocks
    (1, 4, 1, 256, 128, 128, 64),  # MQA, 128-dim heads
    (1, 2, 2, 512, 64, 128, 128),  # longer sequence
]


def _head_major(rng, b, h, kvh, sq, sk, d, dtype):
    return (
        both(normal(rng, b, h, sq, d), dtype),
        both(normal(rng, b, kvh, sk, d), dtype),
        both(normal(rng, b, kvh, sk, d), dtype),
    )


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("b,h,kvh,s,d,bq,bk", KERNEL_SHAPES)
def test_attention_ref_matches_pallas_kernel_and_jax_ref(b, h, kvh, s, d, bq, bk, dtype, tol):
    rng = np.random.default_rng(7)
    (jq, tq), (jk, tk), (jv, tv) = _head_major(rng, b, h, kvh, s, s, d, dtype)
    out = attention_ref(tq, tk, tv, causal=True)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    pallas = pallas_flash_fwd(jq, jk, jv, causal=True, block_q=bq, block_k=bk, interpret=True)
    close(out, pallas, tol)
    close(out, jax_attention_ref(jq, jk, jv, causal=True), tol)


def test_attention_ref_non_causal():
    rng = np.random.default_rng(7)
    (jq, tq), (jk, tk), (jv, tv) = _head_major(rng, 1, 2, 2, 128, 128, 64, "float32")
    out = attention_ref(tq, tk, tv, causal=False)
    pallas = pallas_flash_fwd(jq, jk, jv, causal=False, block_q=64, block_k=64, interpret=True)
    close(out, pallas, 2e-5)
    close(out, jax_attention_ref(jq, jk, jv, causal=False), 1e-5)


def test_ops_wrapper_layout_on_cpu_takes_the_plain_version():
    """``(b, s, h, d)`` in and out; a CPU tensor never reaches the kernel."""
    rng = np.random.default_rng(7)
    b, s, h, d = 1, 128, 4, 32
    jq, tq = both(normal(rng, b, s, h, d))
    jk, tk = both(normal(rng, b, s, 2, d))
    jv, tv = both(normal(rng, b, s, 2, d))
    before = flash_attention_fwd.launches
    out = flash_attention(tq, tk, tv, causal=True)
    assert flash_attention_fwd.launches == before
    assert out.shape == (b, s, h, d)
    close(out, jax_flash_attention(jq, jk, jv, block_q=64, block_k=64, interpret=True), 2e-5)
    close(out, jax_flash_attention(jq, jk, jv, block_q=64, block_k=64, interpret=False), 2e-5)


def test_kernel_binding_refuses_cpu_tensors():
    q = torch.zeros(1, 2, 8, 64)
    before = flash_attention_fwd.launches
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_fwd(q, q, q)
    assert flash_attention_fwd.launches == before


def _grouped(rng, b, sq, sk, kvh, g, dqk, dv, dtype):
    return (
        both(normal(rng, b, sq, kvh, g, dqk), dtype),
        both(normal(rng, b, sk, kvh, dqk), dtype),
        both(normal(rng, b, sk, kvh, dv), dtype),
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,sq,sk,kvh,g,dqk,dv,causal,qc,kc,off",
    [
        (2, 64, 64, 2, 2, 16, 16, True, 16, 32, 0),  # GQA, rectangular chunks
        (1, 32, 96, 2, 1, 24, 16, True, 16, 32, 64),  # MLA-like dqk != dv, q offset
        (1, 48, 48, 1, 4, 16, 16, False, 16, 16, 0),  # MQA, non-causal
    ],
)
def test_flash_core_fwd_impl_out_and_lse(b, sq, sk, kvh, g, dqk, dv, causal, qc, kc, off, dtype):
    rng = np.random.default_rng(5)
    (jq, tq), (jk, tk), (jv, tv) = _grouped(rng, b, sq, sk, kvh, g, dqk, dv, dtype)
    jout, jlse = jfc._fwd_impl(jq, jk, jv, causal, qc, kc, off)
    tout, tlse = tfc._fwd_impl(tq, tk, tv, causal, qc, kc, off)
    assert tout.dtype == tq.dtype and tuple(tlse.shape) == jlse.shape
    close(tout, jout, TOL[dtype])
    close(tlse, jlse, 1e-5 if dtype == "float32" else 2e-2)
    close(tfc.flash_attention_core(tq, tk, tv, causal, qc, kc, off), jout, TOL[dtype])


def test_flash_core_lse_is_the_kernel_plain_lse():
    """``attention_ref_lse`` (what the CUDA kernel's lse is held to) is the
    core's lse, un-blocked."""
    rng = np.random.default_rng(5)
    b, s, kvh, g, d = 2, 64, 2, 2, 16
    (_, tq), (_, tk), (_, tv) = _grouped(rng, b, s, s, kvh, g, d, d, "float32")
    _, lse = tfc._fwd_impl(tq, tk, tv, True, 16, 16, 0)  # (nq, b, kvh, g, qc)
    lse = lse.permute(1, 2, 3, 0, 4).reshape(b, kvh * g, s)
    q_hm = tq.reshape(b, s, kvh * g, d).transpose(1, 2)
    close(attention_ref_lse(q_hm, tk.transpose(1, 2), causal=True), lse, 1e-5)


def _model_layout(rng, b, sq, sk, h, kvh, d, dtype):
    return (
        both(normal(rng, b, sq, h, d), dtype),
        both(normal(rng, b, sk, kvh, d), dtype),
        both(normal(rng, b, sk, kvh, d), dtype),
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,off,sq", [(True, 0, 48), (False, 0, 48), (True, 40, 8)])
def test_naive_attention(dtype, causal, off, sq):
    rng = np.random.default_rng(3)
    (jq, tq), (jk, tk), (jv, tv) = _model_layout(rng, 2, sq, 48, 4, 2, 16, dtype)
    close(
        ta.naive_attention(tq, tk, tv, causal=causal, q_offset=off),
        ja.naive_attention(jq, jk, jv, causal=causal, q_offset=off),
        TOL[dtype],
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_attention(dtype):
    rng = np.random.default_rng(3)
    (jq, tq), (jk, tk), (jv, tv) = _model_layout(rng, 2, 64, 64, 4, 2, 16, dtype)
    out = ta.chunked_attention(tq, tk, tv, causal=True, q_chunk=16, kv_chunk=32)
    close(out, ja.chunked_attention(jq, jk, jv, causal=True, q_chunk=16, kv_chunk=32), TOL[dtype])
    # twin of test_models.py::test_chunked_attention_matches_naive, inside the port
    close(out, ta.naive_attention(tq, tk, tv, causal=True), 2e-5 if dtype == "float32" else 2e-2)


def _attention_case(arch, dtype, **overrides):
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype=dtype, **overrides)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype, **overrides)
    jp = ja.init_attention(jax.random.PRNGKey(2), jcfg, jnp.dtype(dtype))
    if jcfg.qkv_bias:  # zero biases would hide a missing bias add
        for name in ("wq", "wk", "wv"):
            jp[name]["b"] = jp[name]["b"] + 0.1
    return jcfg, tcfg, jp, jax_to_torch_params(jp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "arch,overrides",
    [
        ("phi4-mini-3.8b", {}),  # GQA 3:1, partial rotary 0.75
        ("stablelm-3b", {}),  # MHA, partial rotary 0.25
        ("codeqwen1.5-7b", {}),  # qkv bias
        ("command-r-plus-104b", {"qk_norm": True}),  # GQA + per-head q/k norm
        ("musicgen-medium", {}),  # no rope
    ],
)
def test_attention_qkv_and_apply(arch, overrides, dtype):
    rng = np.random.default_rng(9)
    jcfg, tcfg, jp, tp = _attention_case(arch, dtype, **overrides)
    jx, tx = both(normal(rng, 2, 24, jcfg.d_model), dtype)
    for j, t in zip(
        ja.attention_qkv(jp, jcfg, jx, jnp.arange(24)),
        ta.attention_qkv(tp, tcfg, tx, torch.arange(24)),
    ):
        close(t, j, TOL[dtype])
    sink = {}
    out = ta.attention_apply(tp, tcfg, tx, kv_sink=sink)
    close(out, ja.attention_apply(jp, jcfg, jx), TOL[dtype])
    assert sink["k"].shape == (2, 24, tcfg.n_kv_heads, tcfg.resolved_head_dim)


def test_attention_apply_long_sequence_takes_the_chunked_core():
    """Above 2048 tokens the CPU path is the chunked core, as in the JAX package."""
    rng = np.random.default_rng(9)
    jcfg, tcfg, jp, tp = _attention_case("phi4-mini-3.8b", "float32", n_heads=2, n_kv_heads=1)
    jx, tx = both(normal(rng, 1, 3072, jcfg.d_model))
    close(ta.attention_apply(tp, tcfg, tx), ja.attention_apply(jp, jcfg, jx), 1e-5)


def test_init_attention_twin_has_the_jax_tree():
    for arch, over in [("codeqwen1.5-7b", {}), ("phi4-mini-3.8b", {"qk_norm": True})]:
        jcfg, tcfg, jp, _ = _attention_case(arch, "float32", **over)
        tp = ta.init_attention(torch.Generator().manual_seed(0), tcfg)
        assert set(tp) == set(jp)
        for name in tp:
            assert set(tp[name]) == set(jp[name])
            for leaf in tp[name]:
                assert tuple(tp[name][leaf].shape) == jp[name][leaf].shape
        assert abs(float(tp["wo"]["w"].std()) - float(jp["wo"]["w"].std())) < 0.02


def _mla_case(dtype, seed=4):
    jcfg = dataclasses.replace(jax_smoke_config("deepseek-v2-lite-16b"), dtype=dtype)
    tcfg = dataclasses.replace(get_smoke_config("deepseek-v2-lite-16b"), dtype=dtype)
    jp = ja.init_mla(jax.random.PRNGKey(seed), jcfg, jnp.dtype(dtype))
    # a kv_norm scale of ones would hide a missing scale
    jp["kv_norm"]["scale"] = jp["kv_norm"]["scale"] + 0.1 * jnp.arange(jcfg.mla.kv_lora_rank) / jcfg.mla.kv_lora_rank
    return jcfg, tcfg, jp, jax_to_torch_params(jp)


def test_mla_raises_until_its_slice():
    """The MLA slice has landed: ``init_mla`` and ``mla_apply`` run on the
    smoke config (they raised ``NotImplementedError`` before it), and the
    sink receives the latents that the decode cache holds."""
    cfg = get_smoke_config("deepseek-v2-lite-16b")
    p = ta.init_mla(torch.Generator().manual_seed(0), cfg)
    sink = {}
    out = ta.mla_apply(p, cfg, torch.randn(2, 4, cfg.d_model, generator=torch.Generator().manual_seed(1)),
                       cache_sink=sink)
    assert out.shape == (2, 4, cfg.d_model) and torch.isfinite(out).all()
    assert sink["c_kv"].shape == (2, 4, cfg.mla.kv_lora_rank)
    assert sink["k_r"].shape == (2, 4, cfg.mla.qk_rope_dim)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_mla_twin_has_the_jax_tree(dtype):
    jcfg, tcfg, jp, _ = _mla_case(dtype)
    tp = ta.init_mla(torch.Generator().manual_seed(0), tcfg, {"float32": torch.float32,
                                                              "bfloat16": torch.bfloat16}[dtype])
    assert set(tp) == set(jp) == {"wq", "w_dkv", "kv_norm", "w_kr", "w_uk", "w_uv", "wo"}
    for name in tp:
        assert set(tp[name]) == set(jp[name])
        for leaf in tp[name]:
            assert tuple(tp[name][leaf].shape) == jp[name][leaf].shape
            assert str(tp[name][leaf].dtype).replace("torch.", "") == str(jp[name][leaf].dtype)
    assert tp["kv_norm"]["scale"].dtype == torch.float32  # f32 whatever the model's type
    assert abs(float(tp["wo"]["w"].float().std()) - float(jnp.std(jp["wo"]["w"].astype(jnp.float32)))) < 0.02


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_latents_match_jax(dtype):
    rng = np.random.default_rng(6)
    jcfg, tcfg, jp, tp = _mla_case(dtype)
    jx, tx = both(normal(rng, 2, 20, jcfg.d_model), dtype)
    jpos = jnp.arange(20) + 3
    jc, jk = ja.mla_latents(jp, jcfg, jx, jpos)
    tc, tk = ta.mla_latents(tp, tcfg, tx, torch.arange(20) + 3)
    assert tc.dtype == tx.dtype and tk.shape == (2, 20, tcfg.mla.qk_rope_dim)
    close(tc, jc, TOL[dtype])
    close(tk, jk, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_apply_matches_jax(dtype):
    """Up to 2048 tokens the CPU core is ``_mla_core``, as in the JAX package."""
    rng = np.random.default_rng(8)
    jcfg, tcfg, jp, tp = _mla_case(dtype)
    jx, tx = both(normal(rng, 2, 24, jcfg.d_model), dtype)
    sink = {}
    before = flash_attention_fwd.launches
    out = ta.mla_apply(tp, tcfg, tx, cache_sink=sink)
    assert flash_attention_fwd.launches == before  # a CPU tensor never reaches the kernel
    assert out.dtype == tx.dtype
    close(out, ja.mla_apply(jp, jcfg, jx), TOL[dtype])
    jc, jk = ja.mla_latents(jp, jcfg, jx, jnp.arange(24))
    close(sink["c_kv"], jc, TOL[dtype])
    close(sink["k_r"], jk, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("qc,kc", [(8, 16), (16, 8), (32, 32)])
def test_mla_core_chunked_matches_jax(qc, kc, dtype):
    """The flash core at qk 24 / v 16 (the smoke config's pair) in small chunks."""
    rng = np.random.default_rng(10)
    (jq, tq), (jk, tk), (jv, tv) = (both(normal(rng, 2, 32, 4, dd), dtype) for dd in (24, 24, 16))
    out = ta._mla_core_chunked(tq, tk, tv, qc, kc)
    assert out.shape == (2, 32, 4, 16)
    close(out, ja._mla_core_chunked(jq, jk, jv, qc, kc), TOL[dtype])
    close(ta._mla_core(tq, tk, tv), ja._mla_core(jq, jk, jv), TOL[dtype])
    if dtype == "float32":  # the two cores compute one function
        close(out, ta._mla_core(tq, tk, tv), 2e-5)


def test_mla_apply_long_sequence_takes_the_chunked_core():
    """Above 2048 tokens the CPU path is the chunked core, as in the JAX package."""
    rng = np.random.default_rng(9)
    jcfg, tcfg, jp, tp = _mla_case("float32")
    jx, tx = both(normal(rng, 1, 3072, jcfg.d_model))
    close(ta.mla_apply(tp, tcfg, tx), ja.mla_apply(jp, jcfg, jx), 1e-5)


def test_attention_ref_takes_distinct_qk_and_v_head_dims():
    """The kernel's plain version at dqk != dv is the flash core's function
    (MLA: kvh == h, g == 1), with the scale of dqk; lse included."""
    rng = np.random.default_rng(12)
    b, h, s, dqk, dv = 2, 4, 40, 24, 16
    (_, tq), (_, tk), (_, tv) = (both(normal(rng, b, s, h, dd)) for dd in (dqk, dqk, dv))
    out, lse = tfc._fwd_impl(tq.reshape(b, s, h, 1, dqk), tk, tv, True, 8, 8, 0)
    ref = attention_ref(tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2), causal=True)
    assert ref.shape == (b, h, s, dv)
    close(ref.transpose(1, 2), out.reshape(b, s, h, dv), 2e-5)
    lse = lse.permute(1, 2, 3, 0, 4).reshape(b, h, s)
    close(attention_ref_lse(tq.transpose(1, 2), tk.transpose(1, 2), causal=True), lse, 1e-5)
    # and through the ops wrapper in the models' layout, on the CPU
    close(flash_attention(tq, tk, tv, causal=True), ref.transpose(1, 2), 0)
