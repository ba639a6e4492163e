"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and ``nvcc``; without a card they skip.  Run
them on a machine with one:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref, attention_ref_lse

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, h, kvh, sq, sk, d, dtype, device, seed=7):
    rng = np.random.default_rng(seed)
    mk = lambda *shape: torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device, dtype)
    return mk(b, h, sq, d), mk(b, kvh, sk, d), mk(b, kvh, sk, d)


# f32 2e-5: same f32 arithmetic in another summation order.  bf16 2e-2: both
# sides round p and the output to bf16 (8 bits of mantissa) at different places.
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize(
    "b,h,kvh,s,d",
    [
        (1, 4, 4, 128, 64),  # MHA
        (2, 8, 2, 256, 64),  # GQA 4:1
        (1, 4, 1, 256, 128),  # MQA, 128-dim heads
        (1, 2, 2, 512, 64),  # longer sequence
        (2, 6, 2, 200, 128),  # ragged: no multiple of any tile
        (1, 4, 4, 37, 80),  # head dim 80, shorter than one tile
        (2, 4, 2, 130, 16),  # the smoke configs' head dim
    ],
)
def test_flash_kernel_matches_plain(card, b, h, kvh, s, d, causal, dtype, tol):
    q, k, v = _inputs(b, h, kvh, s, s, d, dtype, card)
    out, lse = flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    ref = attention_ref(q.float(), k.float(), v.float(), causal=causal)
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.cpu().numpy(), rtol=tol, atol=tol)
    ref_lse = attention_ref_lse(q, k, causal=causal)
    np.testing.assert_allclose(lse.cpu().numpy(), ref_lse.cpu().numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("sq,sk", [(70, 333), (300, 40)])
def test_flash_kernel_cross_attention(card, sq, sk):
    q, k, v = _inputs(1, 4, 2, sq, sk, 64, torch.bfloat16, card)
    out, _ = flash_attention_fwd(q, k, v, causal=False)
    ref = attention_ref(q.float(), k.float(), v.float(), causal=False)
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.cpu().numpy(), rtol=2e-2, atol=2e-2)


def test_flash_ops_wrapper_layout_and_count(card):
    rng = np.random.default_rng(0)
    mk = lambda *shape: torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(card)
    q, k, v = mk(2, 96, 4, 64), mk(2, 96, 2, 64), mk(2, 96, 2, 64)
    before = flash_attention_fwd.launches
    out = flash_attention(q, k, v, causal=True)
    assert flash_attention_fwd.launches == before + 1
    ref = attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)).transpose(1, 2)
    assert out.shape == q.shape and out.is_contiguous()
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), rtol=2e-5, atol=2e-5)


def test_flash_kernel_refuses_what_it_does_not_take(card):
    q, k, v = _inputs(1, 2, 2, 32, 32, 48, torch.bfloat16, card)
    with pytest.raises(ValueError):
        flash_attention_fwd(q, k, v)  # head dim 48
    q, k, v = _inputs(1, 2, 2, 32, 64, 64, torch.bfloat16, card)
    with pytest.raises(ValueError):
        flash_attention_fwd(q, k, v, causal=True)  # sq != sk
