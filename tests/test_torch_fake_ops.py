"""The kernels as PyTorch custom ops, on the CPU: on fake tensors that stand
for the card's (``compat.card_stand_in``), K1's forward, K1's backward and
K2's forward give outputs of the shapes, types and strides of their plain
versions' outputs on real tensors, run the launches' checks, build nothing
and launch nothing; their flop formulas count ``kernels/costs.py``'s
FLOPs."""

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.compat import card_stand_in
from repro_torch.kernels.costs import attention_flops, ssd_flops
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention.ops import attention_bwd, flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref, attention_ref_lse
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

# (b, h, kvh, s, dqk, dv): phi4's head, MLA's pair, the smoke widths, one no multiple of 8
ATTENTION = [(2, 6, 2, 40, 128, 128), (1, 4, 4, 33, 192, 128), (2, 4, 2, 24, 24, 16), (1, 2, 1, 17, 20, 20)]
# (b, s, h, p, n, chunk): mamba2's (p, n) at two chunks, one chunk shorter than the sequence
SSD = [(2, 512, 4, 64, 128, 256), (1, 256, 2, 64, 128, 256)]


@pytest.fixture
def no_build(monkeypatch):
    def refuse(*_):
        raise AssertionError("a CUDA source was built or asked")

    for module, names in ((flash_kernel, ("build", "build_bwd")), (ssd_kernel, ("build", "cluster_limit"))):
        for name in names:
            monkeypatch.setattr(module, name, refuse)
    before = (flash_kernel.flash_attention_fwd.launches, flash_kernel.flash_attention_bwd.launches,
              ssd_kernel.ssd_scan_fwd.launches)  # fmt: skip
    yield
    assert before == (flash_kernel.flash_attention_fwd.launches, flash_kernel.flash_attention_bwd.launches,
                      ssd_kernel.ssd_scan_fwd.launches)  # fmt: skip


def _meta(x):
    return tuple(x.shape), x.dtype, x.stride()


def _real(b, h, kvh, s, dqk, dv, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(dtype) for shape in ((b, s, h, dqk), (b, s, kvh, dqk), (b, s, kvh, dv),
                                                                   (b, s, h, dv))]  # fmt: skip


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,kvh,s,dqk,dv", ATTENTION)
def test_k1_forward_fake_matches_the_plain_outputs(no_build, b, h, kvh, s, dqk, dv, dtype):
    q, k, v, _ = _real(b, h, kvh, s, dqk, dv, dtype)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    want_out = attention_ref(qt, kt, vt, causal=True).contiguous()
    want_lse = attention_ref_lse(qt, kt, causal=True)
    with FakeTensorMode() as mode, card_stand_in():
        fq, fk, fv = (mode.from_tensor(x).transpose(1, 2) for x in (q, k, v))
        with FlopCounterMode(display=False) as fc:
            out, lse = flash_kernel.flash_attention_fwd(fq, fk, fv, causal=True)
    assert _meta(out) == _meta(want_out) and _meta(lse) == _meta(want_lse)
    assert fc.get_total_flops() == attention_flops(b, h, s, s, dqk, dv, True)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,kvh,s,dqk,dv", ATTENTION)
def test_k1_backward_fake_matches_the_plain_outputs(no_build, b, h, kvh, s, dqk, dv, dtype):
    q, k, v, dout = _real(b, h, kvh, s, dqk, dv, dtype)
    out = attention_ref(*(x.transpose(1, 2) for x in (q, k, v)), causal=True).transpose(1, 2)
    lse = attention_ref_lse(q.transpose(1, 2), k.transpose(1, 2), causal=True)
    want = [g.transpose(1, 2) for g in attention_bwd(q, k, v, out, lse, dout, causal=True)]
    with FakeTensorMode() as mode, card_stand_in():
        fq, fk, fv, fo, fd = (mode.from_tensor(x).transpose(1, 2) for x in (q, k, v, out, dout))
        flse = mode.from_tensor(lse)
        with FlopCounterMode(display=False) as fc:
            got = flash_kernel.flash_attention_bwd(fq, fk, fv, fo, flse, fd, causal=True)
    for g, w in zip(got, want):
        assert (tuple(g.shape), g.dtype) == (tuple(w.shape), w.dtype)
    assert fc.get_total_flops() == int(2.5 * attention_flops(b, h, s, s, dqk, dv, True))


# The fake backward allocates the real call's scratch: lse * log2(e) and
# delta, and on the one pass (bf16, every instance) the counters and dQ's
# float32 accumulator (with dK's and dV's where a kv head's q heads are split
# over items), sized as the C entry lays them out (``scratch_floats``, the
# source's ``layout_of``); (20, 20) reaches the kernel padded to 24.  At 160
# and (192, 128) a dQ share is 3 slices of 64 columns, a counter each: the
# wide scratch, at deepseek's MLA training shape and at 160.
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,kvh,s,dqk,dv", ATTENTION + [(1, 24, 8, 4096, 128, 128), (1, 16, 16, 4096, 192, 128),
                                                          (1, 24, 8, 4096, 160, 160)])
def test_k1_backward_fake_allocates_the_c_entrys_scratch(no_build, monkeypatch, b, h, kvh, s, dqk, dv, dtype):
    sizes = []

    def spy(n, device):
        sizes.append(n)
        return torch.empty(n, dtype=torch.float32, device=device)

    monkeypatch.setattr(flash_kernel, "_scratch", spy)
    with FakeTensorMode(), card_stand_in():
        q, out = torch.empty(b, h, s, dqk, dtype=dtype), torch.empty(b, h, s, dv, dtype=dtype)
        k, v = torch.empty(b, kvh, s, dqk, dtype=dtype), torch.empty(b, kvh, s, dv, dtype=dtype)
        flash_kernel.flash_attention_bwd(q, k, v, out, torch.empty(b, h, s), out, causal=True)
    path = flash_kernel.kernel_bwd_path(dtype, dqk, dv)
    rows = 2 * b * h * (-(-s // 128) * 128)
    if path == "wgmma1":
        width = flash_kernel.ONE_PASS_WIDTHS[flash_kernel.kernel_instance(dqk, dv)[0]]
        n_qt, n_kt = -(-s // 64), -(-s // 128)
        groups = flash_kernel.bwd_groups(b, kvh, h // kvh, n_qt, n_kt, True)
        split = groups > 1
        slices = 3 if width > 128 else 1
        counters = b * h * n_qt * slices + split * b * kvh * n_kt
        want = rows + -(-counters // 4) * 4 + b * h * n_qt * 64 * width + split * b * kvh * n_kt * 128 * 2 * width
    else:
        want = rows
    aligned = -(-dqk // 8) * 8 if dtype == torch.bfloat16 else dqk
    aligned_v = -(-dv // 8) * 8 if dtype == torch.bfloat16 else dv
    assert sizes == [want] == [flash_kernel.scratch_floats(path, b, h, kvh, s, s, aligned, aligned_v, True)]


@pytest.mark.parametrize("b,h,kvh,s,dqk,dv", ATTENTION)
def test_k1_through_the_autograd_function_on_fake_tensors(no_build, b, h, kvh, s, dqk, dv):
    """The layers' call: (b, s, h, d) in, (b, s, h, dv) out and gradients of
    the inputs' shapes, one forward and one backward op counted."""
    q, k, v, _ = _real(b, h, kvh, s, dqk, dv, torch.bfloat16)
    want = attention_ref(*(x.transpose(1, 2) for x in (q, k, v)), causal=True).transpose(1, 2)
    with FakeTensorMode() as mode, card_stand_in():
        leaves = [mode.from_tensor(x).requires_grad_(True) for x in (q, k, v)]
        with FlopCounterMode(display=False) as fc:
            out = flash_attention(*leaves, causal=True)
            grads = torch.autograd.grad(out.sum(), leaves)
    assert tuple(out.shape) == tuple(want.shape) and out.dtype == want.dtype
    assert [tuple(g.shape) for g in grads] == [tuple(x.shape) for x in (q, k, v)]
    counts = {str(op): n for op, n in fc.get_flop_counts()["Global"].items()}
    assert counts == {"repro_torch.flash_attention_fwd": attention_flops(b, h, s, s, dqk, dv, True),
                      "repro_torch.flash_attention_bwd": int(2.5 * attention_flops(b, h, s, s, dqk, dv, True))}


def test_k1_fake_runs_the_launchs_checks(no_build):
    with FakeTensorMode(), card_stand_in():
        q = torch.empty(1, 2, 16, 176)
        with pytest.raises(ValueError, match="not built"):
            flash_kernel.flash_attention_fwd(q, q, q)
        q, k = torch.empty(1, 2, 16, 64), torch.empty(1, 2, 32, 64)
        with pytest.raises(ValueError, match="sq == sk"):
            flash_kernel.flash_attention_fwd(q, k, k, causal=True)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD)
def test_k2_fake_matches_the_plain_outputs(no_build, b, s, h, p, n, chunk, dtype):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(b, s, h, p, generator=g).to(dtype)
    dt = torch.rand(b, s, h, generator=g) * 0.1 + 0.01
    A = -torch.rand(h, generator=g)
    B, C = (torch.randn(b, s, 1, n, generator=g).to(dtype) for _ in range(2))
    want = ssd_scan_ref(x, dt, A, B[:, :, 0], C[:, :, 0], chunk=chunk)
    with FakeTensorMode() as mode, card_stand_in():
        args = [mode.from_tensor(t) for t in (x, dt, A, B, C)]
        with FlopCounterMode(display=False) as fc:
            got = ssd_scan(*args, chunk=chunk)
    for gt, w in zip(got, want):
        # the launch returns dense outputs; the plain version's y is a view at one chunk
        assert _meta(gt) == _meta(w.contiguous())
        assert gt.stride() == w.stride() or not w.is_contiguous()
    assert fc.get_total_flops() == ssd_flops(b, s, h, p, n, chunk)


def test_k2_fake_runs_the_launchs_checks(no_build):
    with FakeTensorMode(), card_stand_in():
        x, dt, A = torch.empty(1, 96, 2, 64), torch.empty(1, 96, 2), torch.empty(2)
        B = torch.empty(1, 96, 1, 128)
        with pytest.raises(ValueError, match="chunk"):
            ssd_scan(x, dt, A, B, B, chunk=64)
        with pytest.raises(ValueError, match="not built"):
            ssd_scan(torch.empty(1, 64, 2, 48), torch.empty(1, 64, 2), A, B[:, :64], B[:, :64], chunk=64)


def test_outside_the_stand_in_a_fake_cpu_tensor_takes_the_plain_route(no_build):
    with FakeTensorMode():
        q = torch.empty(1, 16, 2, 32)
        with FlopCounterMode(display=False) as fc:
            flash_attention(q, q, q, causal=True)
    assert not any("repro_torch" in str(op) for op in fc.get_flop_counts()["Global"])
