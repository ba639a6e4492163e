"""K1 forward and backward at every head width the reference takes, on the
card: the widths between and below the built instances (16, 24, 48, 96,
widths that are no multiple of 8, which the wrappers pad), the widest square
(160), and pairs of unequal widths ((24, 16): deepseek's smoke MLA; (96,
64); (170, 100) in the (192, 128) instance), each against the plain
versions in bf16 and float32.  Marked ``cuda``: they skip without a card."""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd, flash_attention_fwd, kernel_instance
from repro_torch.kernels.flash_attention.ops import attention_bwd
from repro_torch.kernels.flash_attention.ref import attention_ref, attention_ref_lse

pytestmark = pytest.mark.cuda

WIDTHS = [(16, 16), (24, 24), (20, 20), (32, 32), (48, 48), (72, 72), (96, 96), (112, 112), (160, 160),
          (24, 16), (96, 64), (40, 88), (170, 100),
          # every instance at its own width, the backward's one pass (a share whole up to 128, in slices above)
          (64, 64), (80, 80), (128, 128), (144, 144), (192, 128), (8, 8)]
# f32 2e-5: the same f32 arithmetic in another order.  bf16 2e-2 (output) and
# 3e-2 of the largest gradient: both sides round p, dS and the output to bf16
# at different places, as in test_torch_cuda_kernels.py
FWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(dqk, dv, dtype, device, b=2, h=4, kvh=2, s=300, seed=5):
    rng = np.random.default_rng(seed)
    mk = lambda *shape: torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device, dtype)
    return mk(b, s, h, dqk), mk(b, s, kvh, dqk), mk(b, s, kvh, dv), mk(b, s, h, dv)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dqk,dv", WIDTHS)
def test_flash_fwd_every_width_matches_plain(card, dqk, dv, causal, dtype):
    q, k, v, _ = _case(dqk, dv, dtype, card)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    before = flash_attention_fwd.launches
    out, lse = flash_attention_fwd(qt, kt, vt, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    assert out.shape == (2, 4, 300, dv) and out.dtype == dtype
    ref = attention_ref(qt.float(), kt.float(), vt.float(), causal=causal)
    tol = FWD_TOL[dtype]
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.cpu().numpy(), rtol=tol, atol=tol)
    np.testing.assert_allclose(lse.cpu().numpy(), attention_ref_lse(qt, kt, causal=causal).cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dqk,dv", WIDTHS)
def test_flash_bwd_every_width_matches_plain(card, dqk, dv, causal, dtype):
    q, k, v, dout = _case(dqk, dv, dtype, card)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    out, lse = flash_attention_fwd(qt, kt, vt, causal=causal)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(qt, kt, vt, out, lse, dout.transpose(1, 2), causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    want = attention_bwd(q, k, v, out.transpose(1, 2), lse, dout, causal=causal)
    for g, w, x in zip(got, want, (q, k, v)):
        g = g.transpose(1, 2)
        assert g.shape == x.shape and g.dtype == x.dtype
        err = (g.float() - w.float()).abs().max().item()
        assert err <= BWD_TOL[dtype] * max(1.0, w.float().abs().max().item()), (err, dqk, dv)


def test_flash_instances_hold_every_width_up_to_the_widest(card):
    """The C tables take every (dqk, dv) of 1..192 that ``kernel_instance``
    takes, with the same instance, and refuse the rest."""
    fn = flash_kernel.build()
    for dqk in range(1, 200):
        for dv in range(1, 200):
            try:
                want = kernel_instance(dqk, dv)[0]
            except ValueError:
                want = 0
            assert fn.instance(dqk, dv) == want, (dqk, dv)


@pytest.mark.parametrize("d", [176, 200])
def test_flash_beyond_the_widest_raises_by_name(card, d):
    q, k, v, _ = _case(d, d, torch.bfloat16, card, s=16)
    with pytest.raises(ValueError, match="up to 160"):
        flash_attention_fwd(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
