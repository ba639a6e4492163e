"""The port's configs equal the JAX package's, field by field."""

import dataclasses

import pytest

from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg


def test_same_archs():
    assert treg.list_archs() == jreg.list_archs()
    assert len(treg.list_archs()) == 10


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", jreg.list_archs())
def test_config_equals_jax(arch, smoke):
    jcfg = (jreg.get_smoke_config if smoke else jreg.get_config)(arch)
    tcfg = (treg.get_smoke_config if smoke else treg.get_config)(arch)
    assert isinstance(tcfg, tbase.ModelConfig)
    assert [f.name for f in dataclasses.fields(tcfg)] == [f.name for f in dataclasses.fields(jcfg)]
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    # the methods, too
    assert tcfg.resolved_head_dim == jcfg.resolved_head_dim
    assert tcfg.is_attention_free == jcfg.is_attention_free
    assert tcfg.n_params() == jcfg.n_params()
    assert tcfg.n_active_params() == jcfg.n_active_params()
    for i in range(tcfg.n_layers):
        assert tcfg.layer_kind(i) == jcfg.layer_kind(i)
        assert tcfg.layer_is_moe(i) == jcfg.layer_is_moe(i)


def test_shapes_and_applicability_equal_jax():
    assert {k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()
    }
    for arch in treg.list_archs():
        for name in tbase.SHAPES:
            assert tbase.shape_applicable(treg.get_config(arch), tbase.SHAPES[name]) == (
                jbase.shape_applicable(jreg.get_config(arch), jbase.SHAPES[name])
            )


def test_unknown_arch_raises():
    with pytest.raises(KeyError):
        treg.get_config("no-such-arch")


def test_phi4_mini_is_the_published_width():
    cfg = treg.get_config("phi4-mini-3.8b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads) == (32, 3072, 24, 8)
    assert (cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size) == (128, 8192, 200064)
    assert cfg.rope_fraction == 0.75 and cfg.tie_embeddings
