"""The first slice as a whole: the port's forward, prefill and decode step
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

# the five dense archs this slice serves, one per code path: GQA + partial
# rotary; MHA + layernorm; qkv bias; parallel block + tied head; no rope +
# gelu + embeddings in
ARCHS = [
    "phi4-mini-3.8b",
    "stablelm-3b",
    "codeqwen1.5-7b",
    "command-r-plus-104b",
    "musicgen-medium",
]
TOL = 2e-4
B, S, MAX_SEQ = 2, 12, 16


def _setup(arch, dtype="float32"):
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype=dtype)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_forward_matches_jax(arch):
    jcfg, tcfg, jparams, tparams, tokens, emb = _setup(arch)
    jin, tin = _inputs(jcfg, tokens, emb)
    jh = jlm.lm_forward(jparams, jcfg, remat_policy="none", **jin)
    with torch.inference_mode():
        th = tlm.lm_forward(tparams, tcfg, remat_policy="none", **tin)
        tl = tlm.lm_logits(tparams, tcfg, th)
    close(th, jh, TOL)
    close(tl, jlm.lm_logits(jparams, jcfg, jh), TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_serve_step_match_jax(arch):
    jcfg, tcfg, jparams, tparams, tokens, emb = _setup(arch)
    jin, tin = _inputs(jcfg, tokens, emb)
    mesh = make_host_mesh(data=1, model=1)
    with mesh:
        jprefill, _, _, _ = jdec.make_prefill(jcfg, mesh, B, S)
        jlogits, jcache = jax.jit(jprefill)(jparams, jin)
        jserve, _, _, _ = jdec.make_serve_step(jcfg, mesh, B, MAX_SEQ)
        # stage the prefill cache into a max_seq cache, then one decode step
        jbig = jax.tree.map(
            lambda big, small: big.at[..., :S, :, :].set(small),
            jdec.init_cache(jcfg, B, MAX_SEQ),
            jcache,
        )
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


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_matches_forward(arch):
    """Twin of tests/test_serve.py: the prompt fed token by token through
    ``serve_fn`` gives the last-position logits of one full forward."""
    _, cfg, _, params, tokens, _ = _setup(arch)
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
    against an empty cache; the port stages the prefill's.)"""
    _, cfg, _, params, tokens, _ = _setup(arch)
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


@pytest.mark.parametrize("arch,what", [("mamba2-1.3b", "SSD"), ("jamba-v0.1-52b", "SSD"),
                                       ("deepseek-v2-lite-16b", "MLA"), ("qwen3-moe-30b-a3b", "MoE")])
def test_unported_archs_raise_and_name_their_slice(arch, what):
    cfg = get_smoke_config(arch)
    with pytest.raises(NotImplementedError, match=what):
        tlm.init_lm(torch.Generator().manual_seed(0), cfg)
    if what != "MoE":
        with pytest.raises(NotImplementedError, match=what):
            tdec.cache_shapes(cfg, 1, 8)
    assert tblocks.group_pattern(cfg)  # the pattern itself is config arithmetic and works
