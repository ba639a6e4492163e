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
from repro_torch.kernels.ssd_scan.kernel import ssd_scan_fwd
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

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


# ---------------------------------------------------------------------------
# SSD scan
# ---------------------------------------------------------------------------


def _scan_inputs(b, s, h, p, n, dtype, device, seed=7):
    """x, dt, A, B, C drawn as tests/test_kernels.py draws them (dt in the input type)."""
    rng = np.random.default_rng(seed)
    mk = lambda *shape: rng.standard_normal(shape, dtype=np.float32)
    x = torch.from_numpy(mk(b, s, h, p) * 0.5).to(device, dtype)
    dt = torch.from_numpy(np.log1p(np.exp(mk(b, s, h)))).to(device, dtype)
    A = torch.from_numpy(-np.exp(mk(h) * 0.3)).to(device)
    B = torch.from_numpy(mk(b, s, n) * 0.3).to(device, dtype)
    C = torch.from_numpy(mk(b, s, n) * 0.3).to(device, dtype)
    return x, dt, A, B, C


def _ref32(x, dt, A, B, C, chunk, initial_state=None):
    """The plain version on the same values widened to float32, as test_kernels.py holds its kernel."""
    return ssd_scan_ref(x.float(), dt.float(), A, B.float(), C.float(), chunk=chunk,
                        initial_state=initial_state)


# float32 3e-4 and bfloat16 3e-2: the figures of tests/test_kernels.py.  The
# bf16 kernel rounds only the output where the reference does; its products
# split f32 operands into bf16 hi + lo, so it must also hold half the bf16
# tolerance.  The final state is f32 on both sides: 3e-4 for both types.
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 3e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize(
    "b,s,h,p,n,chunk",
    [
        (1, 128, 2, 32, 16, 32),  # the three shapes of tests/test_kernels.py
        (2, 128, 4, 64, 32, 64),
        (1, 256, 2, 64, 128, 128),
        (1, 255, 2, 64, 128, 255),  # one ragged chunk, no multiple of 16
        (2, 132, 2, 16, 16, 11),  # the smoke configs' dims, twelve chunks of 11
        (2, 48, 3, 64, 16, 12),  # jamba's dims
    ],
)
def test_ssd_kernel_matches_plain(card, b, s, h, p, n, chunk, dtype, tol):
    x, dt, A, B, C = _scan_inputs(b, s, h, p, n, dtype, card)
    y, st = ssd_scan_fwd(x, dt, A, B, C, chunk=chunk)
    torch.cuda.synchronize()
    ry, rst = _ref32(x, dt, A, B, C, chunk)
    assert y.dtype == dtype and st.dtype == torch.float32
    np.testing.assert_allclose(y.float().cpu().numpy(), ry.cpu().numpy(), rtol=tol, atol=tol)
    np.testing.assert_allclose(st.cpu().numpy(), rst.cpu().numpy(), rtol=3e-4, atol=3e-4)
    err = ((y.float() - ry).abs() / (1 + ry.abs())).max().item()
    assert err <= tol / 2, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_state_carry_across_chunks(card, dtype):
    """Multiple chunks agree with one chunk: the state is carried inside the block."""
    x, dt, A, B, C = _scan_inputs(1, 256, 2, 64, 128, dtype, card, seed=3)
    y_multi, st_multi = ssd_scan_fwd(x, dt, A, B, C, chunk=32)
    y_single, st_single = ssd_scan_fwd(x, dt, A, B, C, chunk=256)
    tol = 3e-4 if dtype == torch.float32 else 3e-2
    np.testing.assert_allclose(y_multi.float().cpu().numpy(), y_single.float().cpu().numpy(), rtol=tol, atol=tol)
    np.testing.assert_allclose(st_multi.cpu().numpy(), st_single.cpu().numpy(), rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_initial_state_continuation(card, dtype):
    """The second half from the first half's final state == the whole; and == the plain version."""
    x, dt, A, B, C = _scan_inputs(2, 256, 2, 64, 128, dtype, card, seed=4)
    y, st = ssd_scan_fwd(x, dt, A, B, C, chunk=64)
    _, st1 = ssd_scan_fwd(x[:, :128], dt[:, :128], A, B[:, :128], C[:, :128], chunk=64)
    y2, st2 = ssd_scan_fwd(x[:, 128:], dt[:, 128:], A, B[:, 128:], C[:, 128:], chunk=64, initial_state=st1)
    tol = 3e-4 if dtype == torch.float32 else 3e-2
    np.testing.assert_allclose(y2.float().cpu().numpy(), y[:, 128:].float().cpu().numpy(), rtol=tol, atol=tol)
    np.testing.assert_allclose(st2.cpu().numpy(), st.cpu().numpy(), rtol=3e-4, atol=3e-4)
    ry2, rst2 = _ref32(x[:, 128:], dt[:, 128:], A, B[:, 128:], C[:, 128:], 64, initial_state=st1)
    np.testing.assert_allclose(y2.float().cpu().numpy(), ry2.cpu().numpy(), rtol=tol, atol=tol)
    np.testing.assert_allclose(st2.cpu().numpy(), rst2.cpu().numpy(), rtol=3e-4, atol=3e-4)


def test_ssd_ops_wrapper_layout_and_count(card):
    """ops.ssd_scan takes the layers' (b, s, g, n) B/C and strided x, and launches once."""
    b, s, h, p, n = 2, 64, 4, 64, 128
    x, dt, A, B, C = _scan_inputs(b, s, h, p, n, torch.bfloat16, card)
    xs = torch.cat([x.reshape(b, s, h * p), B, C], dim=-1)  # the conv output's channel layout
    xv, Bv, Cv = xs[..., : h * p].reshape(b, s, h, p), xs[..., h * p : h * p + n], xs[..., h * p + n :]
    before = ssd_scan_fwd.launches
    y, st = ssd_scan(xv, dt.float(), A, Bv[:, :, None], Cv[:, :, None], chunk=32)
    assert ssd_scan_fwd.launches == before + 1
    ry, rst = _ref32(x, dt, A, B, C, 32)
    np.testing.assert_allclose(y.float().cpu().numpy(), ry.cpu().numpy(), rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(st.cpu().numpy(), rst.cpu().numpy(), rtol=3e-4, atol=3e-4)


def test_ssd_kernel_refuses_what_it_does_not_take(card):
    x, dt, A, B, C = _scan_inputs(1, 64, 2, 64, 128, torch.bfloat16, card)
    with pytest.raises(ValueError, match="single-group"):
        ssd_scan(x, dt, A, B[:, :, None].expand(-1, -1, 2, -1), C[:, :, None].expand(-1, -1, 2, -1), chunk=32)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ssd_scan_fwd(x.half(), dt, A, B.half(), C.half(), chunk=32)
    with pytest.raises(ValueError, match="share"):
        ssd_scan_fwd(x, dt, A, B.float(), C, chunk=32)
    with pytest.raises(ValueError, match="not built"):
        ssd_scan_fwd(x[..., :48], dt, A, B, C, chunk=32)
    with pytest.raises(ValueError, match="chunk"):
        ssd_scan_fwd(x, dt, A, B, C, chunk=48)  # does not divide 64
    xl, dtl, Al, Bl, Cl = _scan_inputs(1, 512, 2, 64, 128, torch.bfloat16, card)
    with pytest.raises(ValueError, match="chunk"):
        ssd_scan_fwd(xl, dtl, Al, Bl, Cl, chunk=512)  # above the kernel's 256
