"""K1's backward on the CPU: which of the backward source's kernel families
takes a call (a pure function of dtype and head dims, the same table of built
dims as the forward's ``kernel_path``), the CPU route that neither builds nor
launches anything, and the plain version that the card holds the CUDA
backward to (``ops.attention_bwd``) against JAX's ``jax.vjp`` of
``flash_attention_core`` in the kernel's layout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import flash_core as jfc
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention.kernel import (
    BWD_PATHS,
    HEAD_DIM_PAIRS,
    HEAD_DIMS,
    kernel_bwd_path,
    kernel_path,
)
from repro_torch.kernels.flash_attention.ops import attention_bwd, flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref, attention_ref_lse

from _torch_parity import close, normal


@pytest.fixture
def no_build(monkeypatch):
    """Any build of either flash-attention source fails the test."""

    def refuse(*_):
        raise AssertionError("a CUDA source was built")

    monkeypatch.setattr(flash_kernel, "build", refuse)
    monkeypatch.setattr(flash_kernel, "build_bwd", refuse)


# ---------------------------------------------------------------------------
# the path table
# ---------------------------------------------------------------------------

# The backward's paths, a static table by instance: bf16 takes the one pass
# at every instance (80's rows padded to 96; at 160 and (192, 128) a dQ
# share in slices of 64 columns); float32 takes the FMA passes
ONE_PASS = ((32, 32), (64, 64), (80, 80), (96, 96), (128, 128))
WIDE_ONE_PASS = ((160, 160), (192, 128))
EXPECTED_BWD = {(dtype, dqk, dv): path for dqk, dv in ONE_PASS + WIDE_ONE_PASS
                for dtype, path in ((torch.bfloat16, "wgmma1"), (torch.float32, "fma"))}  # fmt: skip

# a grid around the built head dims, built and not
GRID_DIMS = (8, 16, 32, 48, 64, 80, 96, 128, 160, 192, 256)


def test_every_built_backward_has_a_case():
    built = {(d, d) for d in HEAD_DIMS} | set(HEAD_DIM_PAIRS)
    assert {(dqk, dv) for _, dqk, dv in EXPECTED_BWD} == built
    assert set(EXPECTED_BWD.values()) == set(BWD_PATHS)


@pytest.mark.parametrize("dtype,dqk,dv", sorted(EXPECTED_BWD, key=str))
def test_kernel_bwd_path(no_build, dtype, dqk, dv):
    assert kernel_bwd_path(dtype, dqk, dv) == EXPECTED_BWD[(dtype, dqk, dv)]


# Which bf16 path each width takes: the one pass at every instance, the
# widest (160 and (192, 128), beyond 128) with its dQ share in slices
@pytest.mark.parametrize("dqk,dv,path", [
    (8, 8, "wgmma1"), (16, 16, "wgmma1"), (24, 16, "wgmma1"), (32, 32, "wgmma1"), (48, 48, "wgmma1"),
    (72, 72, "wgmma1"), (80, 80, "wgmma1"), (96, 64, "wgmma1"), (112, 112, "wgmma1"), (128, 128, "wgmma1"),
    (129, 8, "wgmma1"), (144, 144, "wgmma1"), (160, 160, "wgmma1"), (161, 16, "wgmma1"), (170, 100, "wgmma1"),
    (192, 128, "wgmma1"),
])  # fmt: skip
def test_bf16_path_by_instance(no_build, dqk, dv, path):
    assert kernel_bwd_path(torch.bfloat16, dqk, dv) == path
    width = flash_kernel.ONE_PASS_WIDTHS[flash_kernel.kernel_instance(dqk, dv)[0]]
    assert flash_kernel.dq_slices(width) == (3 if max(dqk, dv) > 128 else 1)


# The rule that sizes the one pass's items (the source's ``groups_of``): the
# fewest groups G (a divisor of g) whose heaviest item, key tile 0's g / G
# heads of every q tile, is no heavier than the work spread over 132 SMs.
@pytest.mark.parametrize("b,kvh,g,s,causal,groups", [
    (1, 8, 3, 4096, True, 1),   # phi4's training shape: 256 items, two each on 124 SMs
    (1, 4, 3, 4096, True, 3),   # a model = 2 rank's 12 / 4 heads: one head an item
    (4, 8, 3, 4096, True, 1),   # the smoke widths at b=4
    (1, 16, 1, 4096, True, 1),  # g = 1 cannot split: deepseek's 16 / 16 MLA heads, 512 items
    (1, 8, 1, 4096, True, 1),   # a deepseek rank's 8 / 8 at model = 2: 256 items
    (4, 16, 1, 4096, True, 1),  # deepseek's heads at b=4
    (1, 1, 8, 4096, True, 8),
    (1, 2, 4, 4096, True, 4),
    (1, 4, 4, 4096, False, 2),  # not causal: every item meets every q tile
    (1, 1, 1, 65, True, 1),
])  # fmt: skip
def test_one_pass_item_groups(b, kvh, g, s, causal, groups):
    n_qt, n_kt = -(-s // 64), -(-s // 128)
    assert flash_kernel.bwd_groups(b, kvh, g, n_qt, n_kt, causal) == groups
    per_head = sum(n_qt - 2 * kt if causal else n_qt for kt in range(n_kt))
    assert (g // groups) * n_qt * 132 <= per_head * b * kvh * g or groups == g
    assert g % groups == 0


# The scratch a call takes, written out from the C entry's layout: lse *
# log2(e) and delta; for the one pass the counters (one a q tile and dQ
# slice, then one a key tile where G > 1; padded to 4 floats), dQ's f32
# accumulator and, where G > 1, dK's and dV's.  At 160 and (192, 128) a
# share is 3 slices, each behind a counter of its own
@pytest.mark.parametrize("path,b,h,kvh,sq,sk,dqk,dv,causal,want", [
    ("wgmma1", 1, 24, 8, 4096, 4096, 128, 128, True,
     2 * 24 * 4096 + 24 * 64 + 24 * 64 * 64 * 128),
    ("wgmma1", 1, 12, 4, 4096, 4096, 128, 128, True,
     2 * 12 * 4096 + (12 * 64 + 4 * 32) + 12 * 64 * 64 * 128 + 4 * 32 * 128 * 256),
    ("wgmma1", 2, 4, 2, 300, 300, 80, 80, True,  # G = 2: dK and dV summed over two items
     2 * 2 * 4 * 384 + (2 * 4 * 5 + 2 * 2 * 3) + 2 * 4 * 5 * 64 * 96 + 2 * 2 * 3 * 128 * 2 * 96),
    ("wgmma1", 1, 4, 2, 129, 1000, 128, 128, False,
     2 * 4 * 256 + (4 * 3 + 2 * 8) + 4 * 3 * 64 * 128 + 2 * 8 * 128 * 256),
    ("wgmma1", 1, 1, 1, 65, 65, 32, 32, True, 2 * 128 + 4 + 2 * 64 * 32),
    ("wgmma1", 1, 24, 8, 4096, 4096, 160, 160, True,
     2 * 24 * 4096 + 24 * 64 * 3 + 24 * 64 * 64 * 160),
    ("wgmma1", 1, 16, 16, 4096, 4096, 192, 128, True,  # deepseek's MLA training shape
     2 * 16 * 4096 + 16 * 64 * 3 + 16 * 64 * 64 * 192),
    ("wgmma1", 1, 8, 8, 4096, 4096, 192, 128, True,  # a deepseek rank's at model = 2
     2 * 8 * 4096 + 8 * 64 * 3 + 8 * 64 * 64 * 192),
    ("wgmma1", 1, 12, 4, 4096, 4096, 160, 160, True,  # G = 3 at 160
     2 * 12 * 4096 + (12 * 64 * 3 + 4 * 32) + 12 * 64 * 64 * 160 + 4 * 32 * 128 * 2 * 160),
    ("wgmma1", 2, 4, 2, 300, 300, 192, 128, True,  # G = 2, ragged: 5 q tiles, 3 key tiles
     2 * 2 * 4 * 384 + (2 * 4 * 5 * 3 + 2 * 2 * 3) + 2 * 4 * 5 * 64 * 192 + 2 * 2 * 3 * 128 * 2 * 192),
    ("fma", 1, 24, 8, 4096, 4096, 128, 128, True, 2 * 24 * 4096),
])  # fmt: skip
def test_scratch_floats_is_the_c_entrys_layout(path, b, h, kvh, sq, sk, dqk, dv, causal, want):
    assert flash_kernel.scratch_floats(path, b, h, kvh, sq, sk, dqk, dv, causal) == want


def _refusal(fn, *args):
    try:
        fn(*args)
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
def test_backward_table_is_the_forwards(no_build, dtype):
    """Over the grid, the backward takes exactly what the forward takes and
    refuses the rest with the forward's own words, before any build."""
    for dqk in GRID_DIMS:
        for dv in GRID_DIMS:
            fwd, bwd = _refusal(kernel_path, dtype, dqk, dv), _refusal(kernel_bwd_path, dtype, dqk, dv)
            assert fwd == bwd, (dqk, dv, fwd, bwd)
            if bwd is None:
                assert kernel_bwd_path(dtype, dqk, dv) in BWD_PATHS


@pytest.mark.parametrize("dqk,dv", [(161, 161), (176, 176), (192, 192), (256, 256), (193, 64), (128, 192)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_unbuilt_backward_raises_before_any_build(no_build, dtype, dqk, dv):
    with pytest.raises(ValueError, match="not built"):
        kernel_bwd_path(dtype, dqk, dv)


def test_backward_of_an_unbuilt_dtype_raises_before_any_build(no_build):
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        kernel_bwd_path(torch.float16, 128)


# ---------------------------------------------------------------------------
# the CPU route
# ---------------------------------------------------------------------------


def test_kernel_backward_refuses_cpu_tensors(no_build):
    q = torch.zeros(1, 2, 8, 64)
    lse = torch.zeros(1, 2, 8)
    before = flash_kernel.flash_attention_bwd.launches
    with pytest.raises(ValueError, match="on the card"):
        flash_kernel.flash_attention_bwd(q, q, q, q, lse, q)
    assert flash_kernel.flash_attention_bwd.launches == before


# A CPU tensor's gradient through ``flash_attention`` is autograd of the plain
# version: neither library is built and no kernel launches.  GQA (g = 3 and
# 8), MLA's (192, 128) and the smoke configs' 16, causal and not; exact,
# since both sides run the same PyTorch ops.
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,kvh,dqk,dv", [(6, 2, 64, 64), (8, 1, 16, 16), (2, 2, 192, 128)])
def test_cpu_backward_builds_and_launches_nothing(no_build, h, kvh, dqk, dv, causal):
    gen = torch.Generator().manual_seed(4)
    b, s = 2, 37
    q, k, v = (torch.randn(b, s, n, d, generator=gen) for n, d in ((h, dqk), (kvh, dqk), (kvh, dv)))
    dout = torch.randn(b, s, h, dv, generator=gen)

    def grads(fn):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        return torch.autograd.grad(fn(*leaves), leaves, dout)

    def plain(q, k, v):
        return attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=causal).transpose(1, 2)

    before = (flash_kernel.flash_attention_fwd.launches, flash_kernel.flash_attention_bwd.launches)
    got = grads(lambda q, k, v: flash_attention(q, k, v, causal=causal))
    assert (flash_kernel.flash_attention_fwd.launches, flash_kernel.flash_attention_bwd.launches) == before
    for g, w, x in zip(got, grads(plain), (q, k, v)):
        assert g.shape == x.shape
        torch.testing.assert_close(g, w, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the plain version against JAX
# ---------------------------------------------------------------------------


# The plain version in the kernel's layout (q (b, s, h, d), lse (b, h, s),
# reshaped into the core's (kvh, g) split) against jax.vjp of the JAX core,
# at lengths that the kernels' tiles (32, 64 and 128 rows) do not divide: 37
# (shorter than a tile) and 130 (a tile and a ragged one), where JAX takes
# chunks of 37 and 13 and the port one block.  g = 3 and 8; dqk != dv both
# ways.  float32, 1e-5.
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,kvh,dqk,dv", [(6, 2, 24, 16), (8, 1, 16, 24)])
@pytest.mark.parametrize("s,chunk", [(37, 37), (130, 13)])
def test_plain_backward_at_ragged_lengths_matches_jax_vjp(causal, h, kvh, dqk, dv, s, chunk):
    rng = np.random.default_rng(5)
    b, g = 2, h // kvh
    q, k, v = normal(rng, b, s, h, dqk), normal(rng, b, s, kvh, dqk), normal(rng, b, s, kvh, dv)
    dout = normal(rng, b, s, h, dv)

    def jax_attention(q, k, v):
        out = jfc.flash_attention_core(q.reshape(b, s, kvh, g, dqk), k, v, causal, chunk, chunk, 0)
        return out.reshape(b, s, h, dv)

    def both(dout, q, k, v):
        out, vjp = jax.vjp(jax_attention, q, k, v)
        return out, vjp(dout)

    jout, jgrads = jax.jit(both)(*map(jnp.asarray, (dout, q, k, v)))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    qt, kt, vt = tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2)
    out = attention_ref(qt, kt, vt, causal=causal).transpose(1, 2)
    close(out, jout, 1e-5)
    lse = attention_ref_lse(qt, kt, causal=causal)  # what K1 writes, (b, h, s)
    grads = attention_bwd(tq, tk, tv, out, lse, torch.from_numpy(dout), causal=causal)
    for t, j, x in zip(grads, jgrads, (q, k, v)):
        assert t.shape == x.shape
        close(t, j, 1e-5)
