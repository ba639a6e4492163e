"""``repro_torch.models.layers.basics`` and ``convert`` against the JAX package.

Tolerances (``_torch_parity.TOL``): float32 1e-5, bfloat16 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import basics as jb
from repro_torch.convert import from_jax_params
from repro_torch.models.layers import basics as tb

from _torch_parity import TOL, both, close, jax_to_torch_params, normal

DTYPES = ["float32", "bfloat16"]


@pytest.fixture
def rng():
    return np.random.default_rng(11)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm(rng, dtype):
    jx, tx = both(normal(rng, 2, 5, 64) * 3.0, dtype)
    js, ts = both(1.0 + 0.1 * normal(rng, 64))
    close(tb.rmsnorm(tx, ts), jb.rmsnorm(jx, js), TOL[dtype])
    assert tb.rmsnorm(tx, ts).dtype == tx.dtype


@pytest.mark.parametrize("dtype", DTYPES)
def test_layernorm_and_apply_norm(rng, dtype):
    jx, tx = both(normal(rng, 2, 5, 64) * 3.0 + 1.0, dtype)
    js, ts = both(1.0 + 0.1 * normal(rng, 64))
    jbias, tbias = both(0.1 * normal(rng, 64))
    close(tb.layernorm(tx, ts, tbias), jb.layernorm(jx, js, jbias), TOL[dtype])
    jp, tp = {"scale": js, "bias": jbias}, {"scale": ts, "bias": tbias}
    for kind in ("layernorm", "rmsnorm"):
        close(tb.apply_norm(tp, tx, kind), jb.apply_norm(jp, jx, kind), TOL[dtype])


@pytest.mark.parametrize("fraction,theta", [(0.75, 1e4), (0.25, 1e4), (1.0, 1e6), (0.0, 1e4)])
def test_rope_frequencies(fraction, theta):
    jrot, jinv = jb.rope_frequencies(128, fraction, theta)
    trot, tinv = tb.rope_frequencies(128, fraction, theta)
    assert trot == jrot
    # float32 pow differs by an ulp between the two libraries
    np.testing.assert_allclose(tinv.numpy(), np.asarray(jinv), rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fraction", [0.75, 0.25, 1.0])
def test_apply_rope(rng, dtype, fraction):
    jx, tx = both(normal(rng, 2, 12, 4, 32), dtype)
    jrot, jinv = jb.rope_frequencies(32, fraction, 1e4)
    trot, tinv = tb.rope_frequencies(32, fraction, 1e4)
    # shared positions (prefill) and per-sequence positions (decode)
    close(
        tb.apply_rope(tx, torch.arange(12), trot, tinv),
        jb.apply_rope(jx, jnp.arange(12), jrot, jinv),
        TOL[dtype],
    )
    pos = np.array([[3], [9]], np.int32)
    close(
        tb.apply_rope(tx[:, :1], torch.from_numpy(pos), trot, tinv),
        jb.apply_rope(jx[:, :1], jnp.asarray(pos), jrot, jinv),
        TOL[dtype],
    )
    # the unrotated tail passes through untouched
    assert torch.equal(tb.apply_rope(tx, torch.arange(12), trot, tinv)[..., trot:], tx[..., trot:])


@pytest.mark.parametrize("dtype", DTYPES)
def test_dense_with_and_without_bias(rng, dtype):
    jx, tx = both(normal(rng, 2, 7, 48), dtype)
    jw, tw = both(normal(rng, 48, 40) * 48**-0.5)  # f32 weights, cast to x.dtype inside
    jbias, tbias = both(0.1 * normal(rng, 40))
    close(tb.dense({"w": tw}, tx), jb.dense({"w": jw}, jx), TOL[dtype])
    close(
        tb.dense({"w": tw, "b": tbias}, tx), jb.dense({"w": jw, "b": jbias}, jx), TOL[dtype]
    )
    assert tb.dense({"w": tw}, tx).dtype == tx.dtype


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_apply(rng, dtype, act):
    jx, tx = both(normal(rng, 2, 7, 32), dtype)
    jp, tp = {}, {}
    for name, (d_in, d_out) in {"up": (32, 64), "down": (64, 32), "gate": (32, 64)}.items():
        if name == "gate" and act != "swiglu":
            continue
        jw, tw = both(normal(rng, d_in, d_out) * d_in**-0.5, dtype)
        jp[name], tp[name] = {"w": jw}, {"w": tw}
    close(tb.mlp_apply(tp, tx, act), jb.mlp_apply(jp, jx, act), TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_embed_and_unembed(rng, dtype):
    jt, tt = both(normal(rng, 50, 16) * 0.02, dtype)
    tokens = rng.integers(0, 50, (3, 6)).astype(np.int32)
    je = jb.embed({"table": jt}, jnp.asarray(tokens), jnp.dtype(dtype))
    te = tb.embed({"table": tt}, torch.from_numpy(tokens), getattr(torch, dtype))
    assert np.array_equal(np.asarray(je, np.float32), te.float().numpy())  # a lookup is exact
    jx, tx = both(normal(rng, 3, 6, 16), dtype)
    close(tb.unembed({"table": tt}, tx), jb.unembed({"table": jt}, jx), TOL[dtype])


def test_init_twins_have_the_jax_shapes_and_scales():
    gen = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    pairs = [
        (tb.init_dense(gen, 256, 512, bias=True), jb.init_dense(key, 256, 512, bias=True)),
        (tb.init_mlp(gen, 64, 128, "swiglu"), jb.init_mlp(key, 64, 128, "swiglu")),
        (tb.init_mlp(gen, 64, 128, "gelu"), jb.init_mlp(key, 64, 128, "gelu")),
        (tb.init_embedding(gen, 300, 64), jb.init_embedding(key, 300, 64)),
        (tb.init_norm("layernorm", 32), jb.init_norm("layernorm", 32)),
        (tb.init_norm("rmsnorm", 32), jb.init_norm("rmsnorm", 32)),
    ]
    for tp, jp in pairs:
        tleaves = dict(_flat(tp))
        jleaves = dict(_flat(jp))
        assert set(tleaves) == set(jleaves)
        for name, t in tleaves.items():
            j = np.asarray(jleaves[name])
            assert tuple(t.shape) == j.shape and str(t.dtype) == f"torch.{j.dtype}"
            # same distribution: the standard deviations agree to a few per cent
            assert abs(float(t.std()) - float(j.std())) <= 0.05 * float(j.std()) + 1e-12
    w = tb.init_dense(gen, 64, 32, scale=0.5, dtype=torch.bfloat16)["w"]
    assert w.dtype == torch.bfloat16 and abs(float(w.float().std()) - 0.5) < 0.05


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("dtype", DTYPES)
def test_convert_round_trip(dtype):
    """Every leaf of a JAX tree arrives bit for bit, bf16 through float32."""
    from repro.configs.registry import get_smoke_config
    from repro.models.lm import init_lm

    params = init_lm(jax.random.PRNGKey(3), get_smoke_config("stablelm-3b"), jnp.dtype(dtype))
    tparams = jax_to_torch_params(params)
    jflat, tflat = dict(_flat(params)), dict(_flat(tparams))
    assert set(jflat) == set(tflat)
    for name, j in jflat.items():
        t = tflat[name]
        assert str(t.dtype) == f"torch.{j.dtype}", name
        assert np.array_equal(np.asarray(j, np.float32), t.float().numpy()), name
    assert tflat["blocks.pos_0.mixer.wq.w"].shape[0] == 4  # the stacked group axis is kept


def test_convert_casts_when_asked():
    tree = {"a": {"w": np.ones((2, 3), np.float32)}, "n": np.arange(3, dtype=np.int32)}
    out = from_jax_params(tree, dtype=torch.bfloat16)
    assert out["a"]["w"].dtype == torch.bfloat16 and out["n"].dtype == torch.int32
