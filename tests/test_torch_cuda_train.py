"""The training core on the card: the kernels' autograd Functions against
PyTorch's autograd of their plain versions, remat, and the gate of
gradients that must not stop at a kernel.

These tests need an NVIDIA GPU and ``nvcc``; without a card they skip.  Run
them on a machine with one:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_train.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd, flash_attention_fwd
from repro_torch.kernels.flash_attention.ops import attention_bwd, flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan.kernel import ssd_scan_fwd
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
from repro_torch.models import lm as tlm
from repro_torch.models.layers.attention import attention_apply, init_attention, init_mla, mla_apply
from repro_torch.models.layers.ssm import init_ssm, ssm_apply
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _normal(rng, shape, device, dtype, scale=1.0):
    return (scale * torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))).to(device, dtype)


def _grads(out_fn, inputs, dout):
    leaves = [t.detach().requires_grad_(True) for t in inputs]
    out = out_fn(*leaves)
    return out.detach(), torch.autograd.grad(out, leaves, dout)


# Each gradient of K1's Function (kernel forward, kernel backward) and
# of PyTorch's autograd of the plain version on the same inputs, both against
# autograd of the plain version on float32 copies of them.  float32: 1e-4 of
# the largest entry (the same float32 arithmetic in another order).  bf16:
# the kernel path may stray no further than 1.5x the plain bf16 path does,
# plus 1e-2 of the largest entry (both round p, out and dq's ds to 8 bits of
# mantissa, at different places; the kernel path rounds dk's and dv's p and ds
# too, as tensor-core operands).
#
# The grid: every (dqk, dv) that K1 builds, g = 1, 3 and 8, and lengths that
# the kernels' tiles do not divide.
FLASH_GRID = [
    (2, 4, 4, 130, 16, 16),
    (1, 6, 2, 256, 64, 64),
    (2, 8, 1, 200, 64, 64),
    (1, 3, 1, 333, 80, 80),
    (1, 24, 8, 512, 128, 128),
    (2, 8, 8, 256, 128, 128),
    (1, 16, 16, 300, 192, 128),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,kvh,s,dqk,dv", FLASH_GRID)
def test_flash_attention_function_gradients_match_plain_autograd(card, b, h, kvh, s, dqk, dv, causal, dtype):
    rng = np.random.default_rng(11)
    q = _normal(rng, (b, s, h, dqk), card, dtype)
    k = _normal(rng, (b, s, kvh, dqk), card, dtype)
    v = _normal(rng, (b, s, kvh, dv), card, dtype)
    dout = _normal(rng, (b, s, h, dv), card, dtype)

    def plain(q, k, v):
        return attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=causal).transpose(1, 2)

    before = (flash_attention_fwd.launches, flash_attention_bwd.launches)
    out, got = _grads(lambda q, k, v: flash_attention(q, k, v, causal=causal), (q, k, v), dout)
    assert (flash_attention_fwd.launches, flash_attention_bwd.launches) == (before[0] + 1, before[1] + 1)
    _, plain_grads = _grads(plain, (q, k, v), dout)
    _, ref = _grads(plain, [t.float() for t in (q, k, v)], dout.float())
    _assert_grads_within(got, plain_grads, ref, (q, k, v), dtype)


def _assert_grads_within(got, plain_grads, ref, like, dtype):
    """The tolerances above: float32 1e-4 of the largest entry; bf16 1.5x the
    plain bf16 path's error plus 1e-2 of the largest entry."""
    for name, g, p, r, x in zip("qkv", got, plain_grads, ref, like):
        assert g.shape == x.shape and g.dtype == x.dtype and torch.isfinite(g).all(), name
        scale = r.abs().max().item()
        err = (g.float() - r).abs().max().item()
        if dtype == torch.float32:
            assert err <= 1e-4 * max(1.0, scale), (name, err)
        else:
            plain_err = (p.float() - r).abs().max().item()
            assert err <= 1.5 * plain_err + 1e-2 * max(1.0, scale), (name, err, plain_err)


# K1's backward kernel called directly, on the grid above, against its plain
# version (``flash_attention_bwd`` of ``models/layers/flash_core.py``, through
# ``ops.attention_bwd``) on the same q, k, v, out, lse and dout, both held to
# the plain version on float32 copies of them with the Function's tolerances.
# One call adds one launch to ``flash_attention_bwd.launches``.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,kvh,s,dqk,dv", FLASH_GRID)
def test_flash_bwd_kernel_matches_plain_backward(card, b, h, kvh, s, dqk, dv, causal, dtype):
    rng = np.random.default_rng(12)
    q = _normal(rng, (b, s, h, dqk), card, dtype)
    k = _normal(rng, (b, s, kvh, dqk), card, dtype)
    v = _normal(rng, (b, s, kvh, dv), card, dtype)
    dout = _normal(rng, (b, s, h, dv), card, dtype)
    out, lse = flash_attention_fwd(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=causal)
    out = out.transpose(1, 2)

    before = flash_attention_bwd.launches
    got = flash_attention_bwd(*(x.transpose(1, 2) for x in (q, k, v, out)), lse, dout.transpose(1, 2),
                              causal=causal)  # fmt: skip
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    got = [g.transpose(1, 2) for g in got]
    plain_grads = attention_bwd(q, k, v, out, lse, dout, causal=causal)
    ref = attention_bwd(*(x.float() for x in (q, k, v, out)), lse, dout.float(), causal=causal)
    _assert_grads_within(got, plain_grads, [r.float() for r in ref], (q, k, v), dtype)


# K1's backward at the heads one process of model = 2 hands it in training
# (phi4-mini: 12 of 24 q heads and 4 of 8 kv heads of 128; deepseek-v2-lite's
# MLA: 8 of 16 heads at (192, 128)), against its plain version as above; at
# 512 tokens, at the training shape's 4096 (phi4's 12 / 4 heads take one q
# head an item there) and at a ragged 1000.
@pytest.mark.parametrize("s", [512, 4096, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "deepseek-v2-lite-16b"])
def test_flash_bwd_kernel_at_a_model_rank_head_count(card, arch, dtype, s):
    cfg, model, b = get_config(arch), 2, 1
    if cfg.mla is not None:
        h = kvh = cfg.n_heads // model
        dqk, dv = cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim, cfg.mla.v_head_dim
    else:
        h, kvh = cfg.n_heads // model, cfg.n_kv_heads // model
        dqk = dv = cfg.resolved_head_dim
    rng = np.random.default_rng(13)
    q, k, v, dout = (_normal(rng, shape, card, dtype) for shape in
                     ((b, s, h, dqk), (b, s, kvh, dqk), (b, s, kvh, dv), (b, s, h, dv)))  # fmt: skip
    out, lse = flash_attention_fwd(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=True)
    out = out.transpose(1, 2)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(*(x.transpose(1, 2) for x in (q, k, v, out)), lse, dout.transpose(1, 2), causal=True)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    plain_grads = attention_bwd(q, k, v, out, lse, dout, causal=True)
    ref = attention_bwd(*(x.float() for x in (q, k, v, out)), lse, dout.float(), causal=True)
    _assert_grads_within([g.transpose(1, 2) for g in got], plain_grads, [r.float() for r in ref], (q, k, v), dtype)


# What K1 does not build raises on CUDA tensors before any launch: widths
# past the widest square (160) and past MLA's pair (qk 192, v 128), and
# float16.  (Every width up to those is built: 48, say, takes the 64
# instance.)
@pytest.mark.parametrize(
    "dtype,dqk,dv",
    [(torch.bfloat16, 176, 176), (torch.float32, 200, 200), (torch.bfloat16, 256, 256), (torch.bfloat16, 192, 160),
     (torch.float32, 128, 192), (torch.float16, 128, 128)],
)
def test_flash_bwd_kernel_raises_on_what_is_not_built(card, dtype, dqk, dv):
    b, h, kvh, s = 1, 4, 2, 64
    q, k = torch.zeros(b, h, s, dqk, device=card, dtype=dtype), torch.zeros(b, kvh, s, dqk, device=card, dtype=dtype)
    v = torch.zeros(b, kvh, s, dv, device=card, dtype=dtype)
    out = dout = torch.zeros(b, h, s, dv, device=card, dtype=dtype)
    lse = torch.zeros(b, h, s, device=card)
    before = flash_attention_bwd.launches
    with pytest.raises(ValueError, match="not built|float32 or bfloat16"):
        flash_attention_bwd(q, k, v, out, lse, dout, causal=True)
    assert flash_attention_bwd.launches == before


def _ssd_inputs(rng, b, s, h, p, n, device, dtype):
    x = _normal(rng, (b, s, h, p), device, dtype, 0.5)
    dt = torch.nn.functional.softplus(_normal(rng, (b, s, h), device, torch.float32))
    A = -torch.exp(_normal(rng, (h,), device, torch.float32, 0.3))
    B = _normal(rng, (b, s, 1, n), device, dtype, 0.3)
    C = _normal(rng, (b, s, 1, n), device, dtype, 0.3)
    return x, dt, A, B, C


# K2's Function recomputes the plain version (ssd_chunked) under autograd, so
# its gradients are the plain version's at the same inputs: 1e-5 of the
# largest entry (the same function evaluated twice).  Forms: sequential (b h =
# 128), clusters of 2, 4 and 8 (b h = 64, 32, 2) at mamba2's dims, and float32.
@pytest.mark.parametrize(
    "b,h,dtype,form",
    [
        (2, 64, torch.bfloat16, "sequential"),
        (1, 64, torch.bfloat16, "cluster2"),
        (1, 32, torch.bfloat16, "cluster4"),
        (1, 2, torch.bfloat16, "cluster8"),
        (1, 8, torch.float32, "f32"),
    ],
)
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_scan_function_gradients_match_plain_autograd(card, b, h, dtype, form, with_state):
    s, p, n, chunk = 512, 64, 128, 256
    if dtype == torch.bfloat16:
        got_form = ssd_kernel.scan_form(b, h, s, chunk, p, n, ssd_kernel.cluster_limit(p, n, card.index or 0))
        if got_form.name != form:
            pytest.skip(f"this card gives ({b}, {h}) the {got_form.name} form")
    rng = np.random.default_rng(12)
    x, dt, A, B, C = _ssd_inputs(rng, b, s, h, p, n, card, dtype)
    init = _normal(rng, (b, h, p, n), card, torch.float32) if with_state else None
    dy = _normal(rng, (b, s, h, p), card, dtype)
    dfinal = _normal(rng, (b, h, p, n), card, torch.float32)
    inputs = (x, dt, A, B, C) + ((init,) if with_state else ())

    def run(scan):
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        y, final = scan(*leaves[:5], chunk=chunk, initial_state=leaves[5] if with_state else None)
        return torch.autograd.grad((y, final), leaves, (dy, dfinal))

    def plain(x, dt, A, B, C, *, chunk, initial_state):
        return ssd_scan_ref(x, dt, A, B[:, :, 0], C[:, :, 0], chunk=chunk, initial_state=initial_state)

    before = ssd_scan_fwd.launches
    got = run(ssd_scan)
    assert ssd_scan_fwd.launches == before + 1
    want = run(plain)
    for g, w, t in zip(got, want, inputs):
        assert g.shape == t.shape and torch.isfinite(g).all()
        assert (g.float() - w.float()).abs().max().item() <= 1e-5 * max(1.0, w.abs().max().item())


def _step_grads(cfg, params, batch, remat):
    return tstep.value_and_grad(lambda p, b: tlm.lm_loss(p, cfg, b, remat_policy=remat), params, batch)


# float32 smoke configs through K1 (GQA, head dim 16) and K2 ((16, 16)): the
# group's forward recomputed through the same kernels gives the same values,
# so the gradients under "full" and "dots" equal those under "none", 1e-6; the
# kernels launch twice a layer under "full" (forward, then recompute).
@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "mamba2-1.3b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gradients_equal_under_remat_on_the_card(card, arch, dtype):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    params = tlm.init_lm(torch.Generator(device=card).manual_seed(0), cfg, getattr(torch, dtype))
    tokens = torch.randint(0, cfg.vocab_size, (2, 65), generator=torch.Generator(device=card).manual_seed(1),
                           device=card)  # fmt: skip
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    counter = flash_attention_fwd if cfg.ssm is None else ssd_scan_fwd
    results = {}
    for remat in ("none", "full", "dots"):
        counter.launches = 0
        results[remat] = _step_grads(cfg, params, batch, remat)
        assert counter.launches == cfg.n_layers * (1 if remat == "none" else 2), (remat, counter.launches)
    loss, base = results["none"]
    for remat in ("full", "dots"):
        assert torch.equal(results[remat][0], loss) or abs(float(results[remat][0] - loss)) <= 1e-6
        for a, b_ in zip(topt.tree_leaves(results[remat][1]), topt.tree_leaves(base)):
            torch.testing.assert_close(a, b_, rtol=1e-6, atol=1e-6)


def _every_leaf_gets_a_gradient(params, loss):
    leaves = topt.tree_leaves(params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for i, (leaf, g) in enumerate(zip(leaves, grads)):
        assert g is not None, f"leaf {i} {tuple(leaf.shape)} got no gradient"
        assert torch.isfinite(g).all() and g.abs().max().item() > 0, f"leaf {i} {tuple(leaf.shape)}"


def _require_grad(tree):
    return topt.tree_map(lambda t: t.requires_grad_(True), tree)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_mixer_parameter_gets_a_gradient_through_the_kernels(card, dtype):
    """ROADMAP Queue 3 fault 1: on CUDA tensors a loss through
    ``attention_apply`` (K1 at head dim 128, GQA), ``mla_apply`` (K1 at qk
    192 / v 128) and ``ssm_apply`` (K2 at mamba2's head and state dims)
    gives every parameter a finite, non-zero gradient."""
    gen = torch.Generator(device=card).manual_seed(2)
    phi4 = dataclasses.replace(get_config("phi4-mini-3.8b"), d_model=512, n_heads=8, n_kv_heads=2)
    deepseek = dataclasses.replace(get_config("deepseek-v2-lite-16b"), d_model=512, n_heads=4)
    mamba2 = dataclasses.replace(get_config("mamba2-1.3b"), d_model=256)
    for cfg, init, apply, counter in (
        (phi4, init_attention, attention_apply, flash_attention_fwd),
        (deepseek, init_mla, mla_apply, flash_attention_fwd),
        (mamba2, init_ssm, ssm_apply, ssd_scan_fwd),
    ):
        cfg = dataclasses.replace(cfg, dtype="float32" if dtype == torch.float32 else "bfloat16")
        params = _require_grad(init(gen, cfg, dtype, card))
        x = torch.randn(2, 256, cfg.d_model, generator=gen, device=card).to(dtype).requires_grad_(True)
        before = counter.launches
        out = apply(params, cfg, x)
        assert counter.launches == before + 1, cfg.name
        loss = out.float().square().mean()
        _every_leaf_gets_a_gradient({"params": params, "x": x}, loss)
