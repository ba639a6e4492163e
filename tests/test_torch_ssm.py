"""The port's SSD layer and the SSD scan's plain version against the JAX package's.

Inputs are made with numpy and handed to both.  Where the JAX side is the
Pallas kernel it runs in interpret mode, as ``tests/test_kernels.py`` runs it.
The CUDA kernel itself has no CPU form: ``tests/test_torch_cuda_kernels.py``
holds it against ``ref.ssd_scan_ref`` on the card.  Tolerances:

- float32, function against function: 2e-5 (the same f32 arithmetic, summed
  in another order);
- float32, chunked against the token-by-token recurrence: 2e-4, and the
  ``initial_state`` continuation 1e-4, the figures of ``tests/test_models.py``;
- float32, the plain version against the Pallas kernel: 3e-4, the figure of
  ``tests/test_kernels.py``;
- the mixer: float32 1e-4, bfloat16 3e-2 (bf16 projections and conv, rounded
  at other places by the two frameworks).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.kernels.ssd_scan.kernel import ssd_scan_fwd as pallas_ssd_scan_fwd
from repro.kernels.ssd_scan.ref import ssd_scan_ref as jax_ssd_scan_ref
from repro.models.layers import ssm as jssm
from repro_torch.configs.registry import get_smoke_config
from repro_torch.kernels.ssd_scan.kernel import ssd_scan_fwd
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
from repro_torch.models.layers import ssm as tssm

from _torch_parity import both, close, jax_to_torch_params, normal

# (b, s, h, p, n, chunk): the shapes of tests/test_kernels.py
KERNEL_SHAPES = [
    (1, 128, 2, 32, 16, 32),
    (2, 128, 4, 64, 32, 64),
    (1, 256, 2, 64, 128, 128),  # mamba2-1.3b-like head/state dims
]


def _scan_inputs(rng, b, s, h, p, g, n, dtype="float32"):
    """(jax, torch) pairs of x, dt, A, B, C drawn as tests/test_kernels.py draws them."""
    x = both(normal(rng, b, s, h, p) * 0.5, dtype)
    dt = both(np.log1p(np.exp(normal(rng, b, s, h))), dtype)  # softplus
    A = both(-np.exp(normal(rng, h) * 0.3))
    B = both(normal(rng, b, s, g, n) * 0.3, dtype)
    C = both(normal(rng, b, s, g, n) * 0.3, dtype)
    return x, dt, A, B, C


def _jax(pairs):
    return [j for j, _ in pairs]


def _torch(pairs):
    return [t for _, t in pairs]


@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_ssd_chunked_matches_jax_and_the_recurrence(chunk):
    """Twin of test_models.py::test_ssd_chunked_matches_recurrent, with two B/C groups."""
    pairs = _scan_inputs(np.random.default_rng(0), 2, 64, 4, 8, 2, 16)
    y, st = tssm.ssd_chunked(*_torch(pairs), chunk=chunk)
    jy, jst = jssm.ssd_chunked(*_jax(pairs), chunk=chunk)
    assert y.dtype == torch.float32 and st.shape == (2, 4, 8, 16)
    close(y, jy, 2e-5)
    close(st, jst, 2e-5)
    ry, rst = tssm.ssd_recurrent(*_torch(pairs))
    close(ry, jssm.ssd_recurrent(*_jax(pairs))[0], 2e-5)
    close(y, ry, 2e-4)
    close(st, rst, 2e-4)


def test_ssd_chunked_initial_state_continuation():
    """Twin of test_models.py::test_ssd_chunked_initial_state_continuation."""
    (jx, x), (jdt, dt), (jA, A), (jB, B), (jC, C) = _scan_inputs(
        np.random.default_rng(1), 1, 64, 2, 8, 1, 8
    )
    y_full, st_full = tssm.ssd_chunked(x, dt, A, B, C, chunk=16)
    half = 32
    _, st1 = tssm.ssd_chunked(x[:, :half], dt[:, :half], A, B[:, :half], C[:, :half], chunk=16)
    y2, st2 = tssm.ssd_chunked(
        x[:, half:], dt[:, half:], A, B[:, half:], C[:, half:], chunk=16, initial_state=st1
    )
    close(y2, y_full[:, half:], 1e-4)
    close(st2, st_full, 1e-4)
    _, jst1 = jssm.ssd_chunked(jx[:, :half], jdt[:, :half], jA, jB[:, :half], jC[:, :half], chunk=16)
    jy2, jst2 = jssm.ssd_chunked(
        jx[:, half:], jdt[:, half:], jA, jB[:, half:], jC[:, half:], chunk=16, initial_state=jst1
    )
    close(y2, jy2, 2e-5)
    close(st2, jst2, 2e-5)
    # the recurrence continues from a state too, as ssm_decode_step uses it
    ry, rst = tssm.ssd_recurrent(x[:, half:], dt[:, half:], A, B[:, half:], C[:, half:], initial_state=st1)
    close(ry, y2, 2e-4)
    close(rst, st2, 2e-4)


def test_segsum_and_causal_conv_match_jax():
    rng = np.random.default_rng(2)
    jv, tv = both(normal(rng, 3, 12))
    s = tssm._segsum(tv)
    js = np.asarray(jssm._segsum(jv))
    assert torch.isinf(s).sum() == np.isinf(js).sum() == 3 * 66  # -inf above the diagonal
    close(torch.nan_to_num(s, neginf=0.0), np.nan_to_num(js, neginf=0.0), 1e-5)
    jx, tx = both(normal(rng, 2, 9, 6))
    jw, tw = both(normal(rng, 4, 6))
    jb, tb = both(normal(rng, 6))
    close(tssm._causal_conv(tx, tw, tb), jssm._causal_conv(jx, jw, jb), 1e-5)


@pytest.mark.parametrize("b,s,h,p,n,chunk", KERNEL_SHAPES)
def test_kernel_plain_version_matches_jax_ref_and_the_pallas_kernel(b, s, h, p, n, chunk):
    pairs = _scan_inputs(np.random.default_rng(7), b, s, h, p, 1, n)
    (jx, x), (jdt, dt), (jA, A), (jB, B), (jC, C) = pairs
    y, st = ssd_scan_ref(x, dt, A, B[:, :, 0], C[:, :, 0], chunk=chunk)
    assert y.shape == (b, s, h, p) and st.shape == (b, h, p, n) and st.dtype == torch.float32
    close(y, jax_ssd_scan_ref(jx, jdt, jA, jB[:, :, 0], jC[:, :, 0], chunk=chunk), 2e-5)
    close(st, jssm.ssd_chunked(jx, jdt, jA, jB, jC, chunk=chunk)[1], 2e-5)
    pallas = pallas_ssd_scan_fwd(jx, jdt, jA, jB[:, :, 0], jC[:, :, 0], chunk=chunk, interpret=True)
    close(y, pallas, 3e-4)


def test_ops_on_cpu_tensors_takes_the_plain_version():
    pairs = _scan_inputs(np.random.default_rng(3), 2, 24, 2, 16, 1, 16)
    x, dt, A, B, C = _torch(pairs)
    init = torch.from_numpy(normal(np.random.default_rng(4), 2, 2, 16, 16))
    before = ssd_scan_fwd.launches
    y, st = ssd_scan(x, dt, A, B, C, chunk=12, initial_state=init)
    assert ssd_scan_fwd.launches == before
    ry, rst = ssd_scan_ref(x, dt, A, B[:, :, 0], C[:, :, 0], chunk=12, initial_state=init)
    assert torch.equal(y, ry) and torch.equal(st, rst)
    with pytest.raises(ValueError, match="single-group"):
        ssd_scan(x, dt, A, B.expand(-1, -1, 2, -1), C.expand(-1, -1, 2, -1), chunk=12)


def test_kernel_binding_refuses_cpu_tensors():
    x, dt, A, B, C = _torch(_scan_inputs(np.random.default_rng(5), 1, 16, 2, 16, 1, 16))
    before = ssd_scan_fwd.launches
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_fwd(x, dt, A, B[:, :, 0], C[:, :, 0], chunk=16)
    assert ssd_scan_fwd.launches == before


def _ssm_case(dtype, **ssm_overrides):
    jcfg = dataclasses.replace(jax_smoke_config("mamba2-1.3b"), dtype=dtype)
    tcfg = dataclasses.replace(get_smoke_config("mamba2-1.3b"), dtype=dtype)
    if ssm_overrides:
        jcfg = dataclasses.replace(jcfg, ssm=dataclasses.replace(jcfg.ssm, **ssm_overrides))
        tcfg = dataclasses.replace(tcfg, ssm=dataclasses.replace(tcfg.ssm, **ssm_overrides))
    jp = jssm.init_ssm(jax.random.PRNGKey(3), jcfg, jnp.dtype(dtype))
    # zero conv biases, zero dt_bias and unit D would hide a missing term
    rng = np.random.default_rng(6)
    for name in ("conv_bx", "conv_bB", "conv_bC", "dt_bias"):
        jp[name] = jp[name] + jnp.asarray(normal(rng, *jp[name].shape) * 0.1, jp[name].dtype)
    jp["D"] = jp["D"] * 0.5
    return jcfg, tcfg, jp, jax_to_torch_params(jp)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("s,chunk", [(24, 256), (24, 8)])  # one chunk; three chunks
def test_ssm_apply_matches_jax(dtype, tol, s, chunk):
    jcfg, tcfg, jp, tp = _ssm_case(dtype, chunk=chunk)
    jx, tx = both(normal(np.random.default_rng(8), 2, s, jcfg.d_model), dtype)
    sink = {}
    out = tssm.ssm_apply(tp, tcfg, tx, state_sink=sink)
    assert out.dtype == tx.dtype
    close(out, jssm.ssm_apply(jp, jcfg, jx), tol)
    # the sink holds what the JAX prefill computes for the cache (serve/decode.py:391-401)
    d_inner, n_heads, conv_dim, g, n = jssm._dims(jcfg)
    z, xs, B, C, dt = jssm._project(jp, jcfg, jx)
    tail = jnp.concatenate([xs, B, C], axis=-1)[:, -(jcfg.ssm.d_conv - 1) :, :]
    close(sink["conv"], tail, tol)
    xs = jssm._causal_conv(xs, jp["conv_x"].astype(xs.dtype), jp["conv_bx"]).reshape(2, s, n_heads, -1)
    B = jssm._causal_conv(B, jp["conv_B"].astype(B.dtype), jp["conv_bB"]).reshape(2, s, g, n)
    C = jssm._causal_conv(C, jp["conv_C"].astype(C.dtype), jp["conv_bC"]).reshape(2, s, g, n)
    dtv = jax.nn.softplus(dt.astype(jnp.float32) + jp["dt_bias"])
    _, final = jssm.ssd_chunked(xs, dtv, -jnp.exp(jp["A_log"]), B, C, chunk=min(chunk, s))
    assert sink["ssm"].dtype == torch.float32
    close(sink["ssm"], final, 1e-4 if dtype == "float32" else 5e-2)


def test_conv_tail_of_a_prompt_shorter_than_the_conv_is_zero_padded():
    _, tcfg, _, tp = _ssm_case("float32")
    sink = {}
    x = torch.from_numpy(normal(np.random.default_rng(9), 1, 2, tcfg.d_model))
    tssm.ssm_apply(tp, tcfg, x, state_sink=sink)
    w = tcfg.ssm.d_conv - 1
    assert sink["conv"].shape == (1, w, tssm._dims(tcfg)[2])
    assert torch.equal(sink["conv"][:, : w - 2], torch.zeros_like(sink["conv"][:, : w - 2]))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 3e-2)])
def test_ssm_decode_step_matches_jax(dtype, tol):
    jcfg, tcfg, jp, tp = _ssm_case(dtype)
    rng = np.random.default_rng(10)
    shapes = jssm.ssm_state_shapes(jcfg, 2)
    assert tssm.ssm_state_shapes(tcfg, 2) == shapes
    jssm_state, tssm_state = both(normal(rng, *shapes["ssm"]) * 0.3)
    jconv, tconv = both(normal(rng, *shapes["conv"]), dtype)
    jx, tx = both(normal(rng, 2, 1, jcfg.d_model), dtype)
    state = {"ssm": tssm_state, "conv": tconv}
    kept = {k: v.clone() for k, v in state.items()}
    out, new = tssm.ssm_decode_step(tp, tcfg, tx, state)
    jout, jnew = jssm.ssm_decode_step(jp, jcfg, jx, {"ssm": jssm_state, "conv": jconv})
    close(out, jout, tol)
    close(new["ssm"], jnew["ssm"], tol)
    close(new["conv"], jnew["conv"], tol)
    assert all(torch.equal(state[k], kept[k]) for k in state)  # the state given is not written


def test_decode_steps_continue_the_full_sequence_mixer():
    """ssm_apply over 16 tokens == ssm_apply over 12 tokens, its state, then 4 decode steps."""
    _, tcfg, _, tp = _ssm_case("float32", chunk=4)
    x = torch.from_numpy(normal(np.random.default_rng(11), 2, 16, tcfg.d_model))
    full = tssm.ssm_apply(tp, tcfg, x)
    state = {}
    tssm.ssm_apply(tp, tcfg, x[:, :12], state_sink=state)
    for t in range(12, 16):
        out, state = tssm.ssm_decode_step(tp, tcfg, x[:, t : t + 1], state)
        close(out[:, 0], full[:, t], 1e-4)


def test_init_ssm_twin_has_the_jax_tree():
    jcfg, tcfg = jax_smoke_config("mamba2-1.3b"), get_smoke_config("mamba2-1.3b")
    jp = jssm.init_ssm(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
    tp = tssm.init_ssm(torch.Generator().manual_seed(0), tcfg, torch.bfloat16)
    assert set(tp) == set(jp)
    for name, leaf in tp.items():
        jleaf = jp[name]["w"] if isinstance(jp[name], dict) else jp[name]
        tleaf = leaf["w"] if isinstance(leaf, dict) else leaf
        assert tuple(tleaf.shape) == jleaf.shape, name
        assert str(tleaf.dtype).replace("torch.", "") == str(jleaf.dtype), name
    for name in ("A_log", "D", "dt_bias", "norm_scale"):
        assert tp[name].dtype == torch.float32
        close(tp[name], jp[name], 1e-6)
    assert abs(float(tp["conv_x"].float().std()) - 0.2) < 0.02


def test_converted_mamba2_tree_equals_the_jax_tree_leaf_by_leaf():
    """The parameter bridge on the SSD model: every leaf keeps its type (the
    f32 A_log, D, dt_bias and norm scales stay f32 in a bf16 tree) and its value."""
    from repro.models.lm import init_lm as jax_init_lm

    jparams = jax_init_lm(jax.random.PRNGKey(0), jax_smoke_config("mamba2-1.3b"), jnp.bfloat16)
    tparams = jax_to_torch_params(jparams)
    leaves = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(leaves) == 19  # embed, final norm; the stacked layers' norm and 16 mixer leaves
    for path, jleaf in leaves:
        tleaf = tparams
        for key in path:
            tleaf = tleaf[key.key]
        assert str(tleaf.dtype).replace("torch.", "") == str(jleaf.dtype), path
        assert np.array_equal(tleaf.float().numpy(), np.asarray(jleaf, np.float32)), path
    mixer = tparams["blocks"]["pos_0"]["mixer"]
    for name in ("A_log", "D", "dt_bias", "norm_scale"):
        assert mixer[name].dtype == torch.float32
    assert mixer["in_x"]["w"].dtype == torch.bfloat16
