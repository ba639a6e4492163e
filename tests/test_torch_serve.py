"""The slices as a whole: the port's forward, prefill and decode step
against the JAX package's, from the same parameters and the same inputs.

Parameters are drawn by the JAX package's ``init_lm`` and converted; inputs
are made with numpy.  The JAX functions run on a one-device host mesh.
Tolerance for the whole slice in float32: 2e-4, the figure of
``tests/test_serve.py`` (four layers of float32 sums taken in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.launch.mesh import make_host_mesh
from repro.models import lm as jlm
from repro.serve import decode as jdec
from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch.serve import make_inputs, serve, stage_prefill_cache
from repro_torch.models import blocks as tblocks
from repro_torch.models import lm as tlm
from repro_torch.serve import decode as tdec

from _torch_parity import close, jax_to_torch_params, normal, tree_close

# the archs the port serves, one per code path: GQA + partial rotary; MHA +
# layernorm; qkv bias; parallel block + tied head; no rope + gelu + embeddings
# in; SSD mixer, no FFN, sinusoidal positions, a state cache; MLA + a dense
# prelude layer + MoE with shared experts, a latent cache; GQA + q/k norm +
# MoE in every layer; the hybrid of SSD and attention layers with MoE in
# every other one
ARCHS = [
    "phi4-mini-3.8b",
    "stablelm-3b",
    "codeqwen1.5-7b",
    "command-r-plus-104b",
    "musicgen-medium",
    "mamba2-1.3b",
    "deepseek-v2-lite-16b",
    "qwen3-moe-30b-a3b",
    "jamba-v0.1-52b",
]
# the SSD smoke config with chunks of 4 tokens, so that the scan carries its
# state across chunks at S = 12 (the plain config's chunk covers the prompt)
CHUNKED = ["mamba2-1.3b@chunk4"]
TOL = 2e-4
B, S, MAX_SEQ = 2, 12, 16


def _configs(arch, dtype="float32", ample=False):
    """(jax config, torch config) of a smoke arch; ``name@chunkN`` sets the SSD chunk.

    ``ample`` gives a MoE arch the capacity factor ``n_experts / top_k``, so
    that no slot is dropped.  The capacity depends on the token count, so a
    prefill of n tokens and one of n + 1 (or n decode steps of one token) may
    drop different slots under the reference's own semantics: the tests that
    hold such runs against each other test the cache and the decode step, not
    the routing, and take ample capacity.  The tests against the JAX package
    keep the config's factor and its drops.
    """
    name, _, chunk = arch.partition("@chunk")
    jcfg = dataclasses.replace(jax_smoke_config(name), dtype=dtype)
    tcfg = dataclasses.replace(get_smoke_config(name), dtype=dtype)
    if chunk:
        jcfg = dataclasses.replace(jcfg, ssm=dataclasses.replace(jcfg.ssm, chunk=int(chunk)))
        tcfg = dataclasses.replace(tcfg, ssm=dataclasses.replace(tcfg.ssm, chunk=int(chunk)))
    if ample and tcfg.moe is not None:
        factor = tcfg.moe.n_experts / tcfg.moe.top_k
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=factor))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, capacity_factor=factor))
    return jcfg, tcfg


def _setup(arch, dtype="float32", ample=False):
    jcfg, tcfg = _configs(arch, dtype, ample)
    jparams = jlm.init_lm(jax.random.PRNGKey(0), jcfg, jnp.dtype(dtype))
    tparams = jax_to_torch_params(jparams)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    emb = normal(rng, B, S, jcfg.d_model)
    return jcfg, tcfg, jparams, tparams, tokens, emb


def _inputs(cfg, tokens, emb):
    """(jax inputs, torch inputs) of a prefill: embeddings where the frontend is a stub."""
    if cfg.frontend is not None:
        return {"embeddings": jnp.asarray(emb)}, {"embeddings": torch.from_numpy(emb)}
    return {"tokens": jnp.asarray(tokens)}, {"tokens": torch.from_numpy(tokens).long()}


@pytest.mark.parametrize("arch", ARCHS + CHUNKED)
def test_lm_forward_matches_jax(arch):
    jcfg, tcfg, jparams, tparams, tokens, emb = _setup(arch)
    jin, tin = _inputs(jcfg, tokens, emb)
    jh = jlm.lm_forward(jparams, jcfg, remat_policy="none", **jin)
    with torch.inference_mode():
        th = tlm.lm_forward(tparams, tcfg, remat_policy="none", **tin)
        tl = tlm.lm_logits(tparams, tcfg, th)
    close(th, jh, TOL)
    close(tl, jlm.lm_logits(jparams, jcfg, jh), TOL)


def _stage_jax(big, small):
    """The JAX side of ``stage_prefill_cache``: attention leaves (GQA keys and
    values, MLA latents) into the first S positions, SSD state leaves (no
    sequence axis) whole."""

    def put(path, big_leaf, small_leaf):
        name = path[-1].key
        if name in ("ssm", "conv"):
            return small_leaf
        if name in ("c_kv", "k_r"):  # (..., b, S, r)
            return big_leaf.at[..., :S, :].set(small_leaf)
        return big_leaf.at[..., :S, :, :].set(small_leaf)

    return jax.tree_util.tree_map_with_path(put, big, small)


@pytest.mark.parametrize("arch", ARCHS + CHUNKED)
def test_prefill_and_serve_step_match_jax(arch):
    jcfg, tcfg, jparams, tparams, tokens, emb = _setup(arch)
    jin, tin = _inputs(jcfg, tokens, emb)
    mesh = make_host_mesh(data=1, model=1)
    with mesh:
        jprefill, _, _, _ = jdec.make_prefill(jcfg, mesh, B, S)
        jlogits, jcache = jax.jit(jprefill)(jparams, jin)
        jserve, _, _, _ = jdec.make_serve_step(jcfg, mesh, B, MAX_SEQ)
        # stage the prefill cache into a max_seq cache, then one decode step
        jbig = _stage_jax(jdec.init_cache(jcfg, B, MAX_SEQ), jcache)
        jnext = jnp.argmax(jlogits, -1).astype(jnp.int32)
        jpos = jnp.full((B,), S, jnp.int32)
        jnext2, jlogits2, jbig2 = jax.jit(jserve)(jparams, jbig, jnext[:, None], jpos)

    tlogits, tcache = tdec.make_prefill(tcfg, "cpu", B, S)(tparams, tin)
    close(tlogits, jlogits, TOL)
    assert tlogits.dtype == torch.float32
    tree_close(tcache, jcache, TOL)  # every cache leaf

    tbig = stage_prefill_cache(tcache, tdec.init_cache(tcfg, B, MAX_SEQ, "cpu"), S)
    tree_close(tbig, jbig, TOL)
    # feed the JAX side's token, so that a near-tie in the argmax cannot fork the two
    tnext = torch.from_numpy(np.array(jnext))
    tpos = torch.full((B,), S, dtype=torch.int32)
    serve_fn = tdec.make_serve_step(tcfg, "cpu", B, MAX_SEQ)
    tnext2, tlogits2, tbig2 = serve_fn(tparams, tbig, tnext[:, None], tpos)
    assert tbig2 is tbig  # the step writes into the cache it was given
    close(tlogits2, jlogits2, TOL)
    tree_close(tbig2, jbig2, TOL)
    # the next tokens: the same, or tied within the tolerance under the JAX logits
    ref = np.asarray(jlogits2)
    chosen = ref[np.arange(B), tnext2.numpy()]
    assert tnext2.dtype == torch.int32
    assert (ref.max(-1) - chosen <= 2 * TOL).all()


def test_slice_in_bfloat16_matches_jax():
    """bf16 end to end, as the launcher runs it: 2e-2 on the last logits."""
    jcfg, tcfg, jparams, tparams, tokens, emb = _setup("phi4-mini-3.8b", "bfloat16")
    jin, tin = _inputs(jcfg, tokens, emb)
    mesh = make_host_mesh(data=1, model=1)
    with mesh:
        jprefill, _, _, _ = jdec.make_prefill(jcfg, mesh, B, S)
        jlogits, jcache = jax.jit(jprefill)(jparams, jin)
    tlogits, tcache = tdec.make_prefill(tcfg, "cpu", B, S)(tparams, tin)
    close(tlogits, jlogits, 2e-2)
    assert tcache["blocks"]["pos_0"]["k"].dtype == torch.bfloat16
    tree_close(tcache, jcache, 5e-2)  # four layers of bf16 rounding ahead of the last leaf


@pytest.mark.parametrize("arch", ARCHS + CHUNKED)
def test_teacher_forced_decode_matches_forward(arch):
    """Twin of tests/test_serve.py: the prompt fed token by token through
    ``serve_fn`` gives the last-position logits of one full forward (a MoE
    arch with ample capacity: see ``_configs``)."""
    _, cfg, _, params, tokens, _ = _setup(arch, ample=True)
    tokens = torch.from_numpy(tokens).long()
    with torch.inference_mode():
        hidden = tlm.lm_forward(params, cfg, tokens=tokens)
        ref_logits = tlm.lm_logits(params, cfg, hidden[:, -1, :]).float()
    serve_fn = tdec.make_serve_step(cfg, "cpu", B, MAX_SEQ)
    cache = tdec.init_cache(cfg, B, MAX_SEQ, "cpu")
    for t in range(S):
        pos = torch.full((B,), t, dtype=torch.int32)
        _next, logits, cache = serve_fn(params, cache, tokens[:, t : t + 1], pos)
    close(logits, ref_logits, TOL)
    chosen = ref_logits.numpy()[np.arange(B), torch.argmax(logits, -1).numpy()]
    assert (ref_logits.numpy().max(-1) - chosen < 1e-3).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_stage_decode_equals_forward_of_one_more_token(arch):
    """Prefill s tokens, stage the cache, decode token s+1: the logits are
    those of a forward over all s+1 tokens.  (The JAX launcher decodes
    against an empty cache; the port stages the prefill's.)  A MoE arch runs
    with ample capacity (see ``_configs``)."""
    _, cfg, _, params, tokens, _ = _setup(arch, ample=True)
    model = tdec.CausalLM(cfg, params)
    tokens = torch.from_numpy(tokens).long()
    # musicgen's prefill takes embeddings: look them up, so both paths see the same prompt
    if cfg.frontend is not None:
        prompt = {"embeddings": params["embed"]["table"][tokens[:, : S - 1]]}
    else:
        prompt = {"tokens": tokens[:, : S - 1]}
    _, small = model.prefill(prompt)
    cache = stage_prefill_cache(small, model.init_cache(B, MAX_SEQ), S - 1)
    pos = torch.full((B,), S - 1, dtype=torch.int32)
    _next, logits, _ = model.decode_step(cache, tokens[:, S - 1 :], pos)
    with torch.inference_mode():
        hidden = tlm.lm_forward(params, cfg, tokens=tokens)
        ref_logits = tlm.lm_logits(params, cfg, hidden[:, -1, :]).float()
    close(logits, ref_logits, TOL)


def test_ssd_slice_in_bfloat16_matches_jax():
    """bf16 end to end through the SSD mixer, as the launcher runs it: 3e-2 on
    the last logits (bf16 projections, conv and scan output, rounded at other
    places by the two frameworks)."""
    jcfg, tcfg, jparams, tparams, tokens, emb = _setup("mamba2-1.3b@chunk4", "bfloat16")
    jin, tin = _inputs(jcfg, tokens, emb)
    mesh = make_host_mesh(data=1, model=1)
    with mesh:
        jprefill, _, _, _ = jdec.make_prefill(jcfg, mesh, B, S)
        jlogits, jcache = jax.jit(jprefill)(jparams, jin)
    tlogits, tcache = tdec.make_prefill(tcfg, "cpu", B, S)(tparams, tin)
    close(tlogits, jlogits, 3e-2)
    assert tcache["blocks"]["pos_0"]["ssm"].dtype == torch.float32
    assert tcache["blocks"]["pos_0"]["conv"].dtype == torch.bfloat16
    tree_close(tcache, jcache, 5e-2)  # four layers of bf16 rounding ahead of the last leaf


def test_stage_copies_ssd_state_whole_and_attention_by_position():
    """An SSD leaf has no sequence axis: a prompt shorter than the head count
    must not cut its head axis (8 heads in the smoke config, prompt 4)."""
    _, cfg, _, params, tokens, _ = _setup("mamba2-1.3b")
    model = tdec.CausalLM(cfg, params)
    _, small = model.prefill({"tokens": torch.from_numpy(tokens[:, :4]).long()})
    assert small["blocks"]["pos_0"]["ssm"].shape[-3] == 8 > 4
    big = stage_prefill_cache(small, model.init_cache(B, MAX_SEQ), 4)
    for name in ("ssm", "conv"):
        assert torch.equal(big["blocks"]["pos_0"][name], small["blocks"]["pos_0"][name])
    _, acfg, _, aparams, _, _ = _setup("phi4-mini-3.8b")
    amodel = tdec.CausalLM(acfg, aparams)
    _, asmall = amodel.prefill({"tokens": torch.from_numpy(tokens[:, :4]).long()})
    abig = stage_prefill_cache(asmall, amodel.init_cache(B, MAX_SEQ), 4)
    k = abig["blocks"]["pos_0"]["k"]
    assert torch.equal(k[:, :, :4], asmall["blocks"]["pos_0"]["k"])
    assert not k[:, :, 4:].any()


def test_cache_len_reads_an_attention_leaf_or_none():
    """The decode cache's sequence length comes from an attention leaf (GQA
    keys or MLA latents), never from the head axis of an SSD leaf that comes
    first."""
    for arch, expect in [("phi4-mini-3.8b", MAX_SEQ), ("mamba2-1.3b", None), ("jamba-v0.1-52b", MAX_SEQ),
                         ("deepseek-v2-lite-16b", MAX_SEQ)]:
        cache = tdec.cache_shapes(get_smoke_config(arch), B, MAX_SEQ)
        assert tdec._cache_len(cache) == expect, arch
    first = next(iter(tdec.cache_shapes(get_smoke_config("jamba-v0.1-52b"), B, MAX_SEQ)["blocks"].values()))
    assert set(first) == {"ssm", "conv"}  # jamba's first leaf is an SSD state


def test_init_lm_twin_has_the_jax_tree():
    for arch in ARCHS:
        jcfg, tcfg, jparams, _, _, _ = _setup(arch)
        tparams = tlm.init_lm(torch.Generator().manual_seed(0), tcfg)
        jshapes = jax.tree.map(lambda x: (x.shape, str(x.dtype)), jparams)
        tshapes = _map(lambda x: (tuple(x.shape), str(x.dtype).replace("torch.", "")), tparams)
        assert tshapes == jshapes


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def test_cache_shapes_match_jax():
    for arch in ARCHS:
        jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
        jshapes = jax.tree.map(lambda s: (s.shape, str(s.dtype)), jdec.cache_shapes(jcfg, 3, 20))
        tshapes = _map(
            lambda s: (tuple(s.shape), str(s.dtype).replace("torch.", "")),
            tdec.cache_shapes(tcfg, 3, 20),
        )
        assert tshapes == jshapes


def test_causal_lm_module_owns_the_tree():
    _, cfg, _, params, _, _ = _setup("phi4-mini-3.8b")
    model = tdec.CausalLM(cfg, params)
    assert model.device == torch.device("cpu")
    back = model.params
    assert _map(lambda x: x.data_ptr(), back) == _map(lambda x: x.data_ptr(), params)
    assert len(model.state_dict()) == len(list(model.buffers())) > 10
    half = model.to(torch.bfloat16)
    assert half.params["blocks"]["pos_0"]["mixer"]["wq"]["w"].dtype == torch.bfloat16


def test_launcher_functions_run_the_slice_on_the_cpu():
    cfg = get_smoke_config("phi4-mini-3.8b")
    gen = torch.Generator().manual_seed(0)
    model = tdec.CausalLM(cfg, tlm.init_lm(gen, cfg, torch.bfloat16))
    lines = []
    result = serve(model, make_inputs(cfg, 3, 8, gen), 5, log=lines.append)
    assert result["tokens"].shape == (3, 6) and result["tokens"].dtype == torch.int32
    assert torch.isfinite(result["prefill_logits"]).all() and torch.isfinite(result["last_logits"]).all()
    assert [line.split()[1].split("(")[0] for line in lines] == ["prefill", "decoded", "sample"]


@pytest.mark.parametrize("arch,what", [("jamba-v0.1-52b", "MoE"), ("deepseek-v2-lite-16b", "MLA"),
                                       ("qwen3-moe-30b-a3b", "MoE")])
def test_unported_archs_raise_and_name_their_slice(arch, what):
    """The MoE and MLA slice has landed: the three archs that raised
    ``NotImplementedError`` before it build their parameters and their decode
    cache, and hold their MoE FFNs and (deepseek) their latent cache."""
    cfg = get_smoke_config(arch)
    params = tlm.init_lm(torch.Generator().manual_seed(0), cfg)
    pattern = tblocks.group_pattern(cfg)
    assert any(is_moe for _, is_moe in pattern)
    assert "router" in params["blocks"][f"pos_{[m for _, m in pattern].index(True)}"]["ffn"]
    leaves = {name for entry in tdec.cache_shapes(cfg, 1, 8)["blocks"].values() for name in entry}
    if what == "MLA":
        assert leaves == {"c_kv", "k_r"}
        assert "ffn" in params["prelude_0"] and "router" not in params["prelude_0"]["ffn"]  # the dense prelude
    else:
        assert "k" in leaves


@pytest.mark.parametrize("arch", ARCHS + ["llava-next-34b"])
def test_arch_smoke_forward_matches_jax(arch):
    """Twin of tests/test_models.py::test_arch_smoke_forward over every
    registered arch: the hidden states of one forward at (2, 32) against the
    JAX package's, from its parameters."""
    jcfg, tcfg = _configs(arch)
    jparams = jlm.init_lm(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tparams = jax_to_torch_params(jparams)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    jin, tin = _inputs(jcfg, tokens, normal(rng, 2, 32, jcfg.d_model))
    jh = jlm.lm_forward(jparams, jcfg, remat_policy="none", **jin)
    with torch.inference_mode():
        th = tlm.lm_forward(tparams, tcfg, **tin)
    assert th.shape == (2, 32, jcfg.d_model) and torch.isfinite(th).all()
    close(th, jh, TOL)


def test_every_registered_arch_has_a_smoke_forward_case():
    from repro_torch.configs.registry import list_archs

    assert set(ARCHS + ["llava-next-34b"]) == set(list_archs())


@pytest.mark.parametrize("position", [[5, 11], [0, 7]])
def test_mla_decode_matches_jax(position):
    """The absorbed MLA decode step against the JAX one, on a random latent
    cache: the output and the cache with the new latents written in."""
    jcfg, tcfg = _configs("deepseek-v2-lite-16b")
    from repro.models.layers.attention import init_mla

    jp = init_mla(jax.random.PRNGKey(5), jcfg)
    tp = jax_to_torch_params(jp)
    rng = np.random.default_rng(5)
    m = jcfg.mla
    c_kv, k_r = normal(rng, B, MAX_SEQ, m.kv_lora_rank), normal(rng, B, MAX_SEQ, m.qk_rope_dim)
    x = normal(rng, B, 1, jcfg.d_model)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    pos = np.array(position, np.int32)
    jout, jcache = jdec._mla_decode(jp, jcfg, jx, {"c_kv": jnp.asarray(c_kv), "k_r": jnp.asarray(k_r)},
                                    jnp.asarray(pos))
    tcache = {"c_kv": torch.from_numpy(c_kv.copy()), "k_r": torch.from_numpy(k_r.copy())}
    tout, back = tdec._mla_decode(tp, tcfg, tx, tcache, torch.from_numpy(pos))
    assert back is tcache  # written in place
    close(tout, jout, 1e-5)
    tree_close(tcache, jcache, 1e-5)
