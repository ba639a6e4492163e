"""The training core: the port's backward passes, ``lm_loss``, AdamW and the
train step against the JAX package's, from the same parameters and inputs.

Inputs are made with numpy from a seed; parameters are drawn by the JAX
package's ``init_lm`` and converted.  The JAX functions run on the CPU (the
flash core through ``jax.vjp`` of its ``custom_vjp``, the train step jitted
on a one-device host mesh).  Tolerances are stated beside each test.
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
from repro.models.layers import flash_core as jfc
from repro.models.layers import ssm as jssm
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch.configs.registry import get_smoke_config
from repro_torch.kernels.flash_attention.ops import attention_bwd
from repro_torch.kernels.flash_attention.ref import attention_ref, attention_ref_lse
from repro_torch.kernels.ssd_scan.ops import ssd_scan_bwd
from repro_torch.models import lm as tlm
from repro_torch.models.layers import flash_core as tfc
from repro_torch.train import loop as tloop
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep
from repro_torch.train.data import SyntheticLM

from _torch_parity import close, f32, jax_to_torch_params, normal, tree_close

MESH = {"data": 1, "model": 1}
FAST_OPT = dict(lr=1e-2, warmup_steps=5)


def _tensors(*arrays, grad=False):
    return [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad) for a in arrays]


def _jax_vjp(fn, dout, *inputs):
    """``(fn(*inputs), the vjp of dout)``, jitted (one compile beats the scans' eager ones)."""

    def both(dout, *inputs):
        out, vjp = jax.vjp(fn, *inputs)
        return out, vjp(dout)

    return jax.jit(both)(jnp.asarray(dout), *map(jnp.asarray, inputs))


# ---------------------------------------------------------------------------
# K1's backward: the flash core's FlashAttention-2 backward
# ---------------------------------------------------------------------------


# float32, s = 32 in chunks of 8 (four q and four kv blocks, the blocks above
# the diagonal skipped when causal): the same float32 products summed in
# another order, 1e-5.
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("dqk,dv", [(16, 16), (24, 16)])
def test_flash_core_backward_matches_jax_vjp(causal, g, dqk, dv):
    rng = np.random.default_rng(3)
    b, s, kvh = 2, 32, 2
    q, k, v = normal(rng, b, s, kvh, g, dqk), normal(rng, b, s, kvh, dqk), normal(rng, b, s, kvh, dv)
    dout = normal(rng, b, s, kvh, g, dv)
    jout, jgrads = _jax_vjp(lambda *a: jfc.flash_attention_core(*a, causal, 8, 8, 0), dout, q, k, v)
    tq, tk, tv = _tensors(q, k, v, grad=True)
    tout = tfc.flash_attention_core(tq, tk, tv, causal, 8, 8, 0)
    tout.backward(torch.from_numpy(dout))
    close(tout, jout, 1e-5)
    for t, j in zip((tq, tk, tv), jgrads):
        close(t.grad, j, 1e-5)


def test_flash_core_backward_with_q_offset_and_ragged_chunks_matches_jax():
    """A q offset (the queries are the last 16 of 40 keys) in chunks that do
    not divide the lengths on the port's side: the blocks are ragged there,
    whole in JAX's (which takes chunks of 8).  float32, 1e-5."""
    rng = np.random.default_rng(4)
    b, sq, sk, kvh, g, d = 1, 16, 40, 2, 2, 16
    q, k, v = normal(rng, b, sq, kvh, g, d), normal(rng, b, sk, kvh, d), normal(rng, b, sk, kvh, d)
    dout = normal(rng, b, sq, kvh, g, d)
    _, jgrads = _jax_vjp(lambda *a: jfc.flash_attention_core(*a, True, 8, 8, 24), dout, q, k, v)
    tq, tk, tv = _tensors(q, k, v, grad=True)
    _, lse = tfc._fwd_impl(tq, tk, tv, True, 8, 8, 24)
    lse = lse.permute(1, 2, 3, 0, 4).reshape(b, kvh, g, sq)
    out = tfc.flash_attention_core(tq, tk, tv, True, 8, 8, 24)
    grads = tfc.flash_attention_bwd(tq, tk, tv, out, lse, torch.from_numpy(dout), True, 6, 7, 24)
    for t, j in zip(grads, jgrads):
        close(t, j, 1e-5)


# The kernel's layout: q (b, s, h, d), lse (b, h, s), reshaped into the core's
# (kvh, g) split.  q head i belongs to kv head i // g; a wrong split moves the
# gradients only where g > 1.  float32, 1e-5.
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,kvh,dqk,dv", [(6, 2, 24, 16), (8, 1, 16, 24)])
def test_kernel_layout_backward_matches_jax_vjp(causal, h, kvh, dqk, dv):
    rng = np.random.default_rng(5)
    b, s, g = 2, 32, h // kvh
    q, k, v = normal(rng, b, s, h, dqk), normal(rng, b, s, kvh, dqk), normal(rng, b, s, kvh, dv)
    dout = normal(rng, b, s, h, dv)

    def jax_attention(q, k, v):
        out = jfc.flash_attention_core(q.reshape(b, s, kvh, g, dqk), k, v, causal, 8, 8, 0)
        return out.reshape(b, s, h, dv)

    _, jgrads = _jax_vjp(jax_attention, dout, q, k, v)
    tq, tk, tv = _tensors(q, k, v)
    qt, kt, vt = tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2)
    out = attention_ref(qt, kt, vt, causal=causal).transpose(1, 2)
    lse = attention_ref_lse(qt, kt, causal=causal)  # what K1 writes, (b, h, s)
    grads = attention_bwd(tq, tk, tv, out, lse, torch.from_numpy(dout), causal=causal)
    for t, j, x in zip(grads, jgrads, (q, k, v)):
        assert t.shape == x.shape
        close(t, j, 1e-5)


# ---------------------------------------------------------------------------
# K2's backward: ssd_chunked recomputed under autograd
# ---------------------------------------------------------------------------


# float32, four chunks of 8 with the state carried across them: 1e-4 (the
# exp of cumulative sums and the sums over chunks in another order).
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_scan_backward_matches_jax_grad(with_state):
    rng = np.random.default_rng(6)
    b, s, h, p, n, chunk = 2, 32, 3, 8, 4, 8
    x = 0.5 * normal(rng, b, s, h, p)
    dt = np.log1p(np.exp(normal(rng, b, s, h)))
    A = -np.exp(0.3 * normal(rng, h))
    B, C = 0.3 * normal(rng, b, s, n), 0.3 * normal(rng, b, s, n)
    init = normal(rng, b, h, p, n) if with_state else None
    dy, dfinal = normal(rng, b, s, h, p), normal(rng, b, h, p, n)

    def jax_loss(x, dt, A, B, C, init):
        y, final = jssm.ssd_chunked(x, dt, A, B[:, :, None], C[:, :, None], chunk, init)
        return jnp.sum(y * dy) + jnp.sum(final * dfinal)

    argnums = (0, 1, 2, 3, 4, 5) if with_state else (0, 1, 2, 3, 4)
    jgrads = jax.jit(jax.grad(jax_loss, argnums))(*map(jnp.asarray, (x, dt, A, B, C)),
                                                  None if init is None else jnp.asarray(init))
    tin = _tensors(x, dt, A, B, C) + ([] if init is None else _tensors(init))
    grads = ssd_scan_bwd(*tin[:5], tin[5] if with_state else None, chunk, *_tensors(dy, dfinal))
    assert (grads[5] is None) == (not with_state)
    for t, j in zip(grads, jgrads):
        close(t, j, 1e-4)
    # the final state's gradient alone, and y's alone
    only_y = ssd_scan_bwd(*tin[:5], tin[5] if with_state else None, chunk, torch.from_numpy(dy), None)
    only_final = ssd_scan_bwd(*tin[:5], tin[5] if with_state else None, chunk, None, torch.from_numpy(dfinal))
    for a, b_, both in zip(only_y, only_final, grads):
        if both is not None:  # None: the input does not reach that output (C the final state)
            close(sum(t for t in (a, b_) if t is not None), both, 1e-5)


# ---------------------------------------------------------------------------
# lm_loss and its gradients
# ---------------------------------------------------------------------------


def _setup(arch, dtype="float32", seed=0):
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype=dtype)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    jparams = jlm.init_lm(jax.random.PRNGKey(seed), jcfg, jnp.dtype(dtype))
    return jcfg, tcfg, jparams, jax_to_torch_params(jparams)


def _batch(vocab, b, s, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": torch.from_numpy(toks[:, :-1]).long(), "labels": torch.from_numpy(toks[:, 1:]).long()}
    return jb, tb


# float32 smoke configs (GQA + partial rotary; SSD; MLA + MoE): loss 1e-5,
# every parameter's gradient 2e-4 against its largest entry (four layers of
# float32 sums in another order, then the backward's).
@pytest.mark.parametrize("arch", ["stablelm-3b", "mamba2-1.3b", "deepseek-v2-lite-16b"])
def test_lm_loss_and_gradients_match_jax(arch):
    jcfg, tcfg, jparams, tparams = _setup(arch)
    jb, tb = _batch(jcfg.vocab_size, 2, 16, seed=1)
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p, b: jlm.lm_loss(p, jcfg, b, remat_policy="none")))(jparams, jb)
    tloss, tgrads = tstep.value_and_grad(lambda p, b: tlm.lm_loss(p, tcfg, b, remat_policy="none"), tparams, tb)
    close(tloss, jloss, 1e-5)
    _grads_close(tgrads, jgrads, 2e-4)


def test_lm_loss_in_chunks_matches_jax():
    """4096 tokens: two checkpointed CE chunks of 2048, and on the CPU the
    attention's chunked flash core (and its backward) above 2048 tokens.
    float32, loss 1e-5, gradients 2e-4 against each leaf's largest entry."""
    arch = "phi4-mini-3.8b"
    jcfg, tcfg, jparams, tparams = _setup(arch)
    jcfg = dataclasses.replace(jcfg, n_layers=1)
    tcfg = dataclasses.replace(tcfg, n_layers=1)
    jparams = dict(jparams, blocks=jax.tree.map(lambda x: x[:1], jparams["blocks"]))
    tparams = dict(tparams, blocks=topt.tree_map(lambda x: x[:1].clone(), tparams["blocks"]))
    jb, tb = _batch(jcfg.vocab_size, 1, 4096, seed=2)
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p, b: jlm.lm_loss(p, jcfg, b, remat_policy="full")))(jparams, jb)
    tloss, tgrads = tstep.value_and_grad(lambda p, b: tlm.lm_loss(p, tcfg, b, remat_policy="full"), tparams, tb)
    close(tloss, jloss, 1e-5)
    _grads_close(tgrads, jgrads, 2e-4)


def _grads_close(tgrads, jgrads, tol):
    """Each leaf within ``tol`` of its largest entry (an absolute tolerance per leaf)."""
    jleaves = jax.tree.leaves(jgrads)
    tleaves = topt.tree_leaves(tgrads)
    assert len(jleaves) == len(tleaves)
    for t, j in zip(tleaves, jleaves):
        j = f32(j)
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(f32(t), j, rtol=tol, atol=tol * max(1e-6, float(np.abs(j).max())))


# the gradients with the group's activations recomputed: the same recomputed
# float32 values, so equal within float32 rounding of another evaluation, 1e-6
@pytest.mark.parametrize("policy", ["full", "dots", "dots_no_batch"])
@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "mamba2-1.3b", "deepseek-v2-lite-16b"])
def test_gradients_equal_under_every_remat_policy(arch, policy):
    _, tcfg, _, tparams = _setup(arch)
    _, tb = _batch(tcfg.vocab_size, 2, 16, seed=3)

    def grads(remat):
        return tstep.value_and_grad(lambda p, b: tlm.lm_loss(p, tcfg, b, remat_policy=remat), tparams, tb)

    base_loss, base = grads("none")
    loss, got = grads(policy)
    close(loss, base_loss, 1e-6)
    for a, b_ in zip(topt.tree_leaves(got), topt.tree_leaves(base)):
        torch.testing.assert_close(a, b_, rtol=1e-6, atol=1e-7)


def test_unknown_remat_policy_raises():
    _, tcfg, _, tparams = _setup("phi4-mini-3.8b")
    _, tb = _batch(tcfg.vocab_size, 1, 8, seed=0)
    with pytest.raises(ValueError, match="remat"):
        tlm.lm_loss(tparams, tcfg, tb, remat_policy="everything")
    with pytest.raises(ValueError, match="remat"):
        tstep.TrainConfig(remat_policy="everything")


# ---------------------------------------------------------------------------
# The optimizer
# ---------------------------------------------------------------------------


def test_compress_decompress_matches_jax():
    """int8 quantization with and without error feedback: the same float32
    scale and rounding (half to even), 1e-6."""
    rng = np.random.default_rng(7)
    g, res = normal(rng, 64, 33), 0.01 * normal(rng, 64, 33)
    jd, jr = jopt.compress_decompress(jnp.asarray(g), jnp.asarray(res))
    td, tr = topt.compress_decompress(*_tensors(g, res))
    close(td, jd, 1e-6)
    close(tr, jr, 1e-6)
    jd, jr = jopt.compress_decompress(jnp.asarray(g), None)
    td, tr = topt.compress_decompress(torch.from_numpy(g), None)
    assert jr is None and tr is None
    close(td, jd, 1e-6)
    assert len(torch.unique(td)) <= 255


@pytest.mark.parametrize("step", [0, 7])
def test_adamw_update_matches_jax(step):
    """One AdamW step from a state with moments, clipped (the global norm
    above 1) and inside the warm-up: params out in bf16 and the float32
    state, 1e-6 relative (float32 arithmetic in another fusion) and, for the
    bf16 params, one bf16 step."""
    rng = np.random.default_rng(8)
    shapes = {"b": {"w": (5, 7), "scale": (7,)}, "a": (3,), "emb": {"table": (11, 4)}}
    mk = lambda scale: jax.tree.map(lambda sh: scale * normal(rng, *sh), shapes, is_leaf=lambda x: isinstance(x, tuple))
    params, grads = mk(1.0), mk(2.0)
    m, v = mk(0.1), jax.tree.map(np.abs, mk(0.01))
    cfg = dict(lr=1e-2, warmup_steps=10)
    jstate = {"master": jax.tree.map(jnp.asarray, params), "m": jax.tree.map(jnp.asarray, m),
              "v": jax.tree.map(jnp.asarray, v)}  # fmt: skip
    jp, jst, jmet = jopt.adamw_update(jopt.OptConfig(**cfg), jax.tree.map(jnp.asarray, grads), jstate,
                                      jnp.asarray(step, jnp.int32))  # fmt: skip
    conv = lambda tree: topt.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)
    tst = {"master": conv(params), "m": conv(m), "v": conv(v)}
    tp, tst, tmet = topt.adamw_update(topt.OptConfig(**cfg), conv(grads), tst, torch.tensor(step, dtype=torch.int32))
    assert float(jmet["grad_norm"]) > 1.0
    close(tmet["grad_norm"], jmet["grad_norm"], 1e-6)
    close(tmet["lr"], jmet["lr"], 1e-7)
    for key in ("master", "m", "v"):
        tree_close(tst[key], jst[key], 1e-6)
    for t, j in zip(topt.tree_leaves(tp), jax.tree.leaves(jp)):
        assert t.dtype == torch.bfloat16
        np.testing.assert_allclose(f32(t), f32(j), rtol=2**-8, atol=1e-6)


def test_init_opt_state_copies_float32_params():
    p = {"w": torch.ones(3), "x": {"y": torch.ones(2, dtype=torch.bfloat16)}}
    state = topt.init_opt_state(p)
    assert state["master"]["w"].data_ptr() != p["w"].data_ptr()
    assert state["master"]["x"]["y"].dtype == torch.float32
    assert float(state["m"]["w"].abs().sum() + state["v"]["x"]["y"].abs().sum()) == 0.0


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------


def test_train_step_loss_path_matches_jax():
    """Five float32 steps of ``make_train_step`` against the JAX step jitted
    on a one-device host mesh, from the same converted init and the same
    ``SyntheticLM`` batches.  Step 0's loss and gradient norm 1e-5; the path
    over five steps 1e-4 (Adam moves each parameter by about lr sign(g), and
    float32 rounding noise in a near-zero gradient may flip a sign: the
    losses drift apart only at that noise)."""
    arch = "stablelm-3b"
    jcfg, tcfg, jparams, tparams = _setup(arch)
    data = SyntheticLM(vocab_size=jcfg.vocab_size, seq_len=16, seed=0)
    jt = jstep.TrainConfig(remat_policy="none", param_dtype="float32", opt=jopt.OptConfig(**FAST_OPT))
    tt = tstep.TrainConfig(remat_policy="none", param_dtype="float32", opt=topt.OptConfig(**FAST_OPT))
    mesh = make_host_mesh(data=1, model=1)
    jfn, (jin, _), jout, _ = jstep.make_train_step(jcfg, jt, mesh)
    with mesh:
        jitted = jax.jit(jfn, in_shardings=jin, out_shardings=jout)
        jopt_state = jax.jit(jopt.init_opt_state, out_shardings=jin[1])(jparams)
        jp, js = jparams, jnp.asarray(0, jnp.int32)
        jhist = []
        for i in range(5):
            batch = {k: jnp.asarray(v) for k, v in data.batch(i, batch_size=4).items()}
            jp, jopt_state, js, met = jitted(jp, jopt_state, js, batch)
            jhist.append({k: float(v) for k, v in met.items()})
    tfn, _, _, _ = tstep.make_train_step(tcfg, tt, MESH)
    tp, topt_state, ts = tparams, topt.init_opt_state(tparams), torch.tensor(0, dtype=torch.int32)
    thist = []
    for i in range(5):
        batch = {k: torch.from_numpy(v).long() for k, v in data.batch(i, batch_size=4).items()}
        tp, topt_state, ts, met = tfn(tp, topt_state, ts, batch)
        thist.append({k: float(v) for k, v in met.items()})
    assert int(ts) == int(js) == 5
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(thist[0][key], jhist[0][key], rtol=1e-5)
        np.testing.assert_allclose([h[key] for h in thist], [h[key] for h in jhist], rtol=1e-4)
    assert thist[-1]["loss"] < thist[0]["loss"]
    tree_close(tp, jp, 1e-3)


def _history(cfg, tcfg, steps, batch_fn, seed=0):
    """The metrics history of the port's ``train`` from a seeded init, on the CPU."""
    trainer = tloop.TrainerConfig(steps=steps, ckpt_every=1000, log_every=1000, seed=seed)
    return tloop.train(cfg, tcfg, trainer, MESH, batch_fn, device="cpu")[2]


def test_tiny_training_loss_decreases():
    """Twin of ``tests/test_train.py::test_tiny_training_loss_decreases``."""
    cfg = get_smoke_config("stablelm-3b")
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=32, seed=0)
    tcfg = tstep.TrainConfig(remat_policy="none", opt=topt.OptConfig(**FAST_OPT))
    history = _history(cfg, tcfg, 30, lambda i: data.batch(i, batch_size=8))
    first = np.mean([h["loss"] for h in history[:5]])
    last = np.mean([h["loss"] for h in history[-5:]])
    assert last < first - 0.1, f"loss did not decrease: {first:.3f} -> {last:.3f}"


@pytest.mark.parametrize("pair", [("scu", "tas"), ("scu", "sw")])
def test_sync_strategies_numerically_identical(pair):
    """Twin of ``tests/test_train.py::test_sync_strategies_numerically_identical``:
    the disciplines change the schedule, not the math."""
    cfg = get_smoke_config("phi4-mini-3.8b")
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=16, seed=1)
    losses = {}
    for strategy in pair:
        tcfg = tstep.TrainConfig(sync_strategy=strategy, remat_policy="none")
        losses[strategy] = [h["loss"] for h in _history(cfg, tcfg, 5, lambda i: data.batch(i, batch_size=4), seed=3)]
    a, b = pair
    np.testing.assert_allclose(losses[a], losses[b], rtol=2e-4, atol=2e-4)


def test_grad_accum_matches_full_batch():
    """Twin of ``tests/test_train.py::test_grad_accum_matches_full_batch``:
    accum=2 over the same global batch gives (nearly) the same loss path."""
    cfg = get_smoke_config("stablelm-3b")
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=16, seed=2)
    losses = {}
    for accum in (1, 2):
        tcfg = tstep.TrainConfig(remat_policy="none", grad_accum=accum)
        losses[accum] = [h["loss"] for h in _history(cfg, tcfg, 4, lambda i: data.batch(i, batch_size=8), seed=5)]
    np.testing.assert_allclose(losses[1], losses[2], rtol=1e-3, atol=1e-3)


def test_int8_compression_trains():
    """``compression="int8"`` runs through the step and the loss falls."""
    cfg = get_smoke_config("stablelm-3b")
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=16, seed=4)
    tcfg = tstep.TrainConfig(remat_policy="none", opt=topt.OptConfig(compression="int8", **FAST_OPT))
    history = _history(cfg, tcfg, 6, lambda i: data.batch(0, batch_size=4))
    assert history[-1]["loss"] < history[0]["loss"]


def test_train_state_specs_and_abstract_params():
    """The spec trees mirror the JAX function's on a (data 2, model 2) mesh
    (the ZeRO layout of the scu policy), and the abstract params hold no storage."""
    cfg = get_smoke_config("phi4-mini-3.8b")
    sds = tstep.abstract_params(cfg)
    assert all(t.device.type == "meta" for t in topt.tree_leaves(sds))
    jcfg = jax_smoke_config("phi4-mini-3.8b")
    jsds = jstep.abstract_params(jcfg)
    assert [tuple(t.shape) for t in topt.tree_leaves(sds)] == [tuple(t.shape) for t in jax.tree.leaves(jsds)]
    specs = tstep.train_state_specs(cfg, tstep.TrainConfig(), {"data": 2, "model": 2})
    assert set(specs) == {"params", "opt", "step"} and set(specs["opt"]) == {"master", "m", "v"}
    assert specs["step"] == ()
    assert len(topt.tree_leaves(specs["opt"]["m"])) == len(topt.tree_leaves(sds))
