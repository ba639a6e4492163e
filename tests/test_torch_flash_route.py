"""Which of the flash-attention source's kernels takes a call: a pure function
of (dtype, qk head dim, v head dim), held here on the CPU for every built
head dim and pair.  The tests marked ``cuda`` show on the card that MLA's
layer goes through the kernel; they skip without one."""

import dataclasses

import pytest
import torch

from repro_torch.configs.registry import get_smoke_config
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention.kernel import HEAD_DIM_PAIRS, HEAD_DIMS, PATHS, kernel_path
from repro_torch.models.layers import attention as ta

# bf16 at every built instance (phi4's, codeqwen's, command-r's, llava's 128,
# musicgen's 64, stablelm's 80, and 32, 96 and 160) goes to the Hopper
# kernel; float32 always to the full-precision one
EXPECTED = {(dtype, d): path for d in (32, 64, 80, 96, 128, 160)
            for dtype, path in ((torch.bfloat16, "wgmma"), (torch.float32, "f32"))}


def test_every_built_head_dim_has_a_case():
    assert {d for _, d in EXPECTED} == set(HEAD_DIMS)
    assert set(EXPECTED.values()) == set(PATHS)


@pytest.mark.parametrize("dtype,d", sorted(EXPECTED, key=str))
def test_kernel_path(dtype, d):
    assert kernel_path(dtype, d) == EXPECTED[(dtype, d)]


@pytest.fixture
def no_build(monkeypatch):
    """Any build of the CUDA source fails the test."""

    def refuse(*_):
        raise AssertionError("the CUDA source was built")

    monkeypatch.setattr(flash_kernel, "build", refuse)


@pytest.mark.parametrize("d", [161, 176, 192, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_unbuilt_head_dim_raises_before_any_build(no_build, dtype, d):
    with pytest.raises(ValueError, match="not built"):
        kernel_path(dtype, d)


@pytest.mark.parametrize("dtype", [torch.float16, torch.int8])
def test_unbuilt_dtype_raises_before_any_build(no_build, dtype):
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        kernel_path(dtype, 128)


# MLA's pair (qk 192 = nope 128 + rope 64, v 128): the Hopper kernel in bf16
EXPECTED_PAIRS = {
    (torch.bfloat16, 192, 128): "wgmma",
    (torch.float32, 192, 128): "f32",
}


def test_every_built_pair_has_a_case():
    assert {(dqk, dv) for _, dqk, dv in EXPECTED_PAIRS} == set(HEAD_DIM_PAIRS)


@pytest.mark.parametrize("dtype,dqk,dv", sorted(EXPECTED_PAIRS, key=str))
def test_kernel_path_of_a_pair(dtype, dqk, dv):
    assert kernel_path(dtype, dqk, dv) == EXPECTED_PAIRS[(dtype, dqk, dv)]


@pytest.mark.parametrize("dtype,d", sorted(EXPECTED, key=str))
def test_kernel_path_of_equal_dims_is_the_one_dim_path(dtype, d):
    assert kernel_path(dtype, d, d) == kernel_path(dtype, d)


@pytest.mark.parametrize("dqk,dv", [(193, 64), (128, 192), (256, 128), (192, 192), (192, 136), (176, 144)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_unbuilt_pair_raises_before_any_build(no_build, dtype, dqk, dv):
    with pytest.raises(ValueError, match="not built"):
        kernel_path(dtype, dqk, dv)


def test_mla_inputs_are_no_broadcast_and_are_not_copied():
    """``mla_apply`` concatenates K's rope part, broadcast over the heads,
    onto its nope part: the result has a stride for every head, so the
    Hopper path reads it where it lies; only a genuinely broadcast head (a
    zero stride) is copied."""
    b, s, h = 2, 5, 4
    k_nope, k_r = torch.randn(b, s, h, 128), torch.randn(b, s, 1, 64)
    broadcast = k_r.expand(b, s, h, 64)
    kk = torch.cat([k_nope, broadcast], dim=-1)
    assert flash_kernel._no_broadcast(kk.transpose(1, 2))
    assert not flash_kernel._no_broadcast(broadcast.transpose(1, 2))
    assert flash_kernel._no_broadcast(broadcast[:, :, :1].transpose(1, 2))  # extent 1: never followed


def test_mla_apply_on_a_cpu_tensor_never_builds_or_launches(no_build):
    cfg = get_smoke_config("deepseek-v2-lite-16b")
    p = ta.init_mla(torch.Generator().manual_seed(0), cfg)
    before = flash_kernel.flash_attention_fwd.launches
    out = ta.mla_apply(p, cfg, torch.randn(1, 6, cfg.d_model, generator=torch.Generator().manual_seed(1)))
    assert out.shape == (1, 6, cfg.d_model)
    assert flash_kernel.flash_attention_fwd.launches == before


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
def test_mla_apply_on_the_card_launches_k1(card, dtype, tol):
    """deepseek's MLA layer at its full head dims (qk 192, v 128), 16 heads:
    one K1 launch a call, the output the CPU path's (``_mla_core``) within
    the tolerance of one layer in ``dtype``."""
    full = get_smoke_config("deepseek-v2-lite-16b")
    cfg = dataclasses.replace(full, n_heads=16, n_kv_heads=16, head_dim=192, mla=type(full.mla)())
    p = ta.init_mla(torch.Generator().manual_seed(0), cfg, dtype)
    x = torch.randn(2, 77, cfg.d_model, generator=torch.Generator().manual_seed(1)).to(dtype)
    want = ta.mla_apply(p, cfg, x)  # CPU: the plain core
    on_card = _to(p, card)
    before = flash_kernel.flash_attention_fwd.launches
    got = ta.mla_apply(on_card, cfg, x.to(card))
    torch.cuda.synchronize()
    assert flash_kernel.flash_attention_fwd.launches == before + 1
    assert kernel_path(dtype, 192, 128) in ("wgmma", "f32")
    torch.testing.assert_close(got.float().cpu(), want.float(), rtol=tol, atol=tol)


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device) for k, v in tree.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("dqk,dv", [(200, 64), (128, 192)])
def test_an_unbuilt_pair_raises_on_the_card(card, dqk, dv):
    q = torch.zeros(1, 2, 16, dqk, device=card, dtype=torch.bfloat16)
    v = torch.zeros(1, 2, 16, dv, device=card, dtype=torch.bfloat16)
    before = flash_kernel.flash_attention_fwd.launches
    with pytest.raises(ValueError, match="not built"):
        flash_kernel.flash_attention_fwd(q, q, v)
    assert flash_kernel.flash_attention_fwd.launches == before
