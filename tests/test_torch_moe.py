"""The port's MoE layer against the JAX package's, on shared inputs.

Inputs are made with numpy from a seed; parameters are drawn by the JAX
``init_moe`` and converted.  Router logits are continuous float32 draws, so
no two probabilities of a token tie and ``torch.topk`` and ``jax.lax.top_k``
pick the same experts.  Tolerances: 1e-6 on the routing weights (one
softmax and one division in float32), 2e-5 on ``moe_apply`` in float32 (three
products and a weighted sum taken in another order), 2e-2 in bfloat16.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models.layers import moe as jmoe
from repro_torch.configs import base as tbase
from repro_torch.models.layers import moe as tmoe

from _torch_parity import both, close, jax_to_torch_params, normal

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _cfgs(n_experts=8, top_k=2, d_ff_expert=32, n_shared=0, capacity_factor=1.25, d=16, dtype="float32",
          router_norm_topk=True):
    """(jax config, torch config) of a one-layer MoE model."""
    kw = dict(n_experts=n_experts, top_k=top_k, d_ff_expert=d_ff_expert, n_shared=n_shared,
              capacity_factor=capacity_factor, router_norm_topk=router_norm_topk)
    common = dict(name="t", family="moe", n_layers=1, d_model=d, n_heads=1, n_kv_heads=1, d_ff=32,
                  vocab_size=8, dtype=dtype)
    return (jbase.ModelConfig(moe=jbase.MoEConfig(**kw), **common),
            tbase.ModelConfig(moe=tbase.MoEConfig(**kw), **common))  # fmt: skip


def _idx_np(x):
    return np.asarray(x).astype(np.int64)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "T,E,K,norm",
    [(64, 8, 2, True), (37, 16, 4, True), (50, 64, 6, True), (20, 128, 8, True), (33, 8, 3, False)],
)
def test_router_topk_matches_jax(T, E, K, norm):
    rng = np.random.default_rng(T * E + K)
    jl, tl = both(normal(rng, T, E) * 2.0)
    jcfg, tcfg = _cfgs(n_experts=E, top_k=K, router_norm_topk=norm)
    jw, ji = jmoe.router_topk(jl, jcfg.moe)
    tw, ti = tmoe.router_topk(tl, tcfg.moe)
    assert tw.dtype == torch.float32 and tuple(ti.shape) == (T, K)
    np.testing.assert_array_equal(ti.numpy(), _idx_np(ji))
    close(tw, jw, 1e-6)


# (T, E, K, seed): the ranges of tests/test_models.py::test_dispatch_indices_properties,
# explicit so the count never wobbles; C = max(1, T*K // E) as there, which
# drops slots whenever an expert draws more than its share
DISPATCH_CASES = [
    (4, 4, 1, 0),
    (5, 8, 3, 11),
    (16, 4, 2, 1),
    (17, 16, 3, 2),
    (32, 8, 1, 3),
    (40, 16, 2, 4),
    (63, 4, 3, 5),
    (64, 8, 2, 6),
    (64, 16, 3, 7),
    (33, 8, 2, 65535),
]


@pytest.mark.parametrize("T,E,K,seed", DISPATCH_CASES)
def test_dispatch_indices_bitwise_equal_to_jax(T, E, K, seed):
    idx = np.random.default_rng(seed).integers(0, E, (T, K)).astype(np.int32)
    C = max(1, (T * K) // E)
    jdest, jtoken, jorder = jmoe.dispatch_indices(jnp.asarray(idx), E, C)
    tdest, ttoken, torder = tmoe.dispatch_indices(torch.from_numpy(idx).long(), E, C)
    for t, j in ((tdest, jdest), (ttoken, jtoken), (torder, jorder)):
        np.testing.assert_array_equal(t.numpy(), _idx_np(j))
    # twin of the properties the JAX test asserts, on the port's output
    dest, token = tdest.numpy(), ttoken.numpy()
    flat_expert = idx.reshape(-1)[torder.numpy()]
    kept = dest < E * C
    assert (dest[kept] // C == flat_expert[kept]).all()
    for e in range(E):
        slots = dest[kept & (flat_expert == e)]
        assert len(np.unique(slots)) == len(slots) == min(C, (flat_expert == e).sum())
    for s_i in np.where(kept)[0]:
        assert flat_expert[s_i] in idx[token[s_i]]


def test_dispatch_cases_include_drops():
    dropped = 0
    for T, E, K, seed in DISPATCH_CASES:
        idx = np.random.default_rng(seed).integers(0, E, (T, K))
        C = max(1, (T * K) // E)
        dest, _, _ = tmoe.dispatch_indices(torch.from_numpy(idx), E, C)
        dropped += int((dest == E * C).sum())
    assert dropped > 0


@pytest.mark.parametrize("T", [4, 22, 24, 2048, 2052, 16384])
@pytest.mark.parametrize("E,K,cf", [(8, 2, 1.25), (16, 2, 1.25), (64, 6, 1.25), (128, 8, 1.25), (64, 6, 64 / 6)])
def test_capacity_is_the_references(T, E, K, cf):
    m = tbase.MoEConfig(n_experts=E, top_k=K, d_ff_expert=8, capacity_factor=cf)
    expect = max(8, min(int(T * K / E * cf), T))
    assert tmoe.moe_capacity(T, m) == expect


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------


def _moe_case(dtype="float32", seed=0, b=2, s=24, **kw):
    jcfg, tcfg = _cfgs(dtype=dtype, **kw)
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.dtype(dtype))
    rng = np.random.default_rng(seed + 1)
    jx, tx = both(normal(rng, b, s, jcfg.d_model), dtype)
    return jcfg, tcfg, jp, jax_to_torch_params(jp), jx, tx


def _n_dropped(tcfg, tp, tx):
    m = tcfg.moe
    T = tx.shape[0] * tx.shape[1]
    _, idx = tmoe.router_topk(tx.reshape(T, -1).float() @ tp["router"], m)
    C = tmoe.moe_capacity(T, m)
    dest, _, _ = tmoe.dispatch_indices(idx, m.n_experts, C)
    return int((dest == m.n_experts * C).sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "n_shared,capacity_factor,drops",
    [(0, 8.0, False), (2, 8.0, False), (0, 1.0, True), (2, 1.0, True)],
)
def test_moe_apply_matches_jax(n_shared, capacity_factor, drops, dtype):
    jcfg, tcfg, jp, tp, jx, tx = _moe_case(dtype, n_shared=n_shared, capacity_factor=capacity_factor)
    assert (_n_dropped(tcfg, tp, tx) > 0) == drops
    out = tmoe.moe_apply(tp, tcfg, tx)
    assert out.dtype == tx.dtype and out.shape == tx.shape
    close(out, jmoe.moe_apply(jp, jcfg, jx), TOL[dtype])


def test_moe_apply_deepseek_like_routing_matches_jax():
    """Many experts, top-6, two shared experts, drops at the config's 1.25."""
    jcfg, tcfg, jp, tp, jx, tx = _moe_case(n_experts=64, top_k=6, n_shared=2, d=32, s=40)
    assert _n_dropped(tcfg, tp, tx) > 0
    close(tmoe.moe_apply(tp, tcfg, tx), jmoe.moe_apply(jp, jcfg, jx), TOL["float32"])


def _dense_moe_reference(xf, router, gate, up, down, m):
    """Loop-over-experts reference (no capacity drops), as tests/test_models.py has it."""
    weights, idx = tmoe.router_topk(xf.float() @ router, m)
    out = torch.zeros(xf.shape, dtype=torch.float32)
    for e in range(m.n_experts):
        h = torch.nn.functional.silu(xf @ gate[e]) * (xf @ up[e])
        w = ((idx == e) * weights).sum(-1)  # (T,)
        out = out + w[:, None] * (h @ down[e]).float()
    return out


def test_moe_matches_dense_reference_when_capacity_ample():
    """Twin of tests/test_models.py's test of the same name, inside the port
    (its tolerance, 2e-3)."""
    m = tbase.MoEConfig(n_experts=8, top_k=2, d_ff_expert=32, capacity_factor=8.0)
    T, d = 64, 16
    rng = np.random.default_rng(0)
    xf = torch.from_numpy(normal(rng, T, d))
    router = torch.from_numpy(normal(rng, d, m.n_experts))
    gate, up = (torch.from_numpy(normal(rng, m.n_experts, d, m.d_ff_expert) * 0.1) for _ in range(2))
    down = torch.from_numpy(normal(rng, m.n_experts, m.d_ff_expert, d) * 0.1)
    cfg = tbase.ModelConfig(name="t", family="moe", n_layers=1, d_model=d, n_heads=1, n_kv_heads=1,
                            d_ff=32, vocab_size=8, moe=m)  # fmt: skip
    params = {"router": router, "gate": gate, "up": up, "down": down}
    out = tmoe.moe_apply(params, cfg, xf[None])
    ref = _dense_moe_reference(xf, router, gate, up, down, m)
    np.testing.assert_allclose(out[0].numpy(), ref.numpy(), rtol=2e-3, atol=2e-3)


def test_combine_adds_each_tokens_slots_in_ascending_expert_order():
    """In bfloat16 the order of the K additions shows: the combine must add
    them in the reference's order, the sorted slots one after the other (the
    order of a sequential ``index_add_`` over the sorted slots on the CPU)."""
    _, tcfg, _, tp, _, tx = _moe_case("bfloat16", n_experts=8, top_k=4, capacity_factor=8.0)
    m = tcfg.moe
    T, d = tx.shape[0] * tx.shape[1], tx.shape[2]
    xf = tx.reshape(T, d)
    weights, idx = tmoe.router_topk(xf.float() @ tp["router"], m)
    C = tmoe.moe_capacity(T, m)
    dest, token, order = tmoe.dispatch_indices(idx, m.n_experts, C)
    buf = torch.zeros((m.n_experts * C + 1, d), dtype=tx.dtype)
    buf[dest] = xf[token]
    h = buf[:-1].view(m.n_experts, C, d)
    g = torch.nn.functional.silu(torch.bmm(h, tp["gate"])) * torch.bmm(h, tp["up"])
    y = torch.cat([torch.bmm(g, tp["down"]).reshape(-1, d), torch.zeros(1, d, dtype=tx.dtype)])
    slot_out = y[dest] * weights.reshape(-1)[order].to(tx.dtype)[:, None]
    expect = torch.zeros((T, d), dtype=tx.dtype)
    for i in range(slot_out.shape[0]):  # the sorted slots, one at a time
        expect[token[i]] += slot_out[i]
    got = tmoe.moe_apply(tp, tcfg, tx).reshape(T, d)
    assert torch.equal(got, expect)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_shared", [0, 2])
def test_init_moe_twin_has_the_jax_tree(n_shared, dtype):
    jcfg, tcfg = _cfgs(n_shared=n_shared, dtype=dtype)
    jp = jmoe.init_moe(jax.random.PRNGKey(0), jcfg, jnp.dtype(dtype))
    tp = tmoe.init_moe(torch.Generator().manual_seed(0), tcfg, {"float32": torch.float32,
                                                                "bfloat16": torch.bfloat16}[dtype])
    shapes = lambda tree, f: {k: shapes(v, f) if isinstance(v, dict) else f(v) for k, v in tree.items()}
    jshapes = shapes(jp, lambda x: (tuple(x.shape), str(x.dtype)))
    tshapes = shapes(tp, lambda x: (tuple(x.shape), str(x.dtype).replace("torch.", "")))
    assert tshapes == jshapes
    assert tp["router"].dtype == torch.float32  # f32 whatever the model's type
    assert abs(float(tp["down"].float().std()) - float(jnp.std(jp["down"].astype(jnp.float32)))) < 0.02


def test_moe_smoke_configs_route_as_the_reference():
    """The three MoE archs' smoke configs, one MoE layer each, against JAX."""
    from repro.configs.registry import get_smoke_config as jax_smoke_config
    from repro_torch.configs.registry import get_smoke_config

    for arch in ("jamba-v0.1-52b", "deepseek-v2-lite-16b", "qwen3-moe-30b-a3b"):
        jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32")
        tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        jp = jmoe.init_moe(jax.random.PRNGKey(3), jcfg)
        rng = np.random.default_rng(3)
        jx, tx = both(normal(rng, 2, 12, jcfg.d_model))
        close(tmoe.moe_apply(jax_to_torch_params(jp), tcfg, tx), jmoe.moe_apply(jp, jcfg, jx), TOL["float32"])
