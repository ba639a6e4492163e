"""K1's route at every head width the reference takes, on the CPU: which
instance of the CUDA sources takes (dqk, dv), that the forward's and the
backward's tables take every width up to the widest built and refuse the
rest by name before any build, and that the wrappers pad a width that is no
multiple of 8 (the bf16 kernels store 8 columns at a time)."""

import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention.kernel import (
    HEAD_DIM_PAIRS,
    HEAD_DIMS,
    MAX_SQUARE,
    kernel_bwd_path,
    kernel_instance,
    kernel_path,
)


@pytest.fixture
def no_build(monkeypatch):
    def refuse(*_):
        raise AssertionError("a CUDA source was built")

    monkeypatch.setattr(flash_kernel, "build", refuse)
    monkeypatch.setattr(flash_kernel, "build_bwd", refuse)


def test_the_instances_are_the_built_squares_and_mla():
    assert HEAD_DIMS == (32, 64, 80, 96, 128, 160) and MAX_SQUARE == 160
    assert HEAD_DIM_PAIRS == ((192, 128),)


# the backward's bf16 path by instance: the one pass at every instance, up to
# 128 and at 160 alike (there with its dQ share in slices)
@pytest.mark.parametrize("dtype,path,bwd", [(torch.bfloat16, "wgmma", ("wgmma1", "wgmma1")),
                                            (torch.float32, "f32", ("fma", "fma"))])
def test_every_width_up_to_the_widest_is_taken(no_build, dtype, path, bwd):
    for dqk in range(1, MAX_SQUARE + 1):
        for dv in range(1, MAX_SQUARE + 1):
            assert kernel_path(dtype, dqk, dv) == path
            assert kernel_bwd_path(dtype, dqk, dv) == bwd[kernel_instance(dqk, dv)[0] > 128]


@pytest.mark.parametrize("dqk,dv,instance", [
    (16, 16, (32, 32)), (24, 16, (32, 32)), (24, 24, (32, 32)), (32, 32, (32, 32)), (33, 8, (64, 64)),
    (48, 48, (64, 64)), (64, 64, (64, 64)), (72, 80, (80, 80)), (80, 80, (80, 80)), (96, 64, (96, 96)),
    (96, 96, (96, 96)), (128, 128, (128, 128)), (129, 1, (160, 160)), (160, 160, (160, 160)),
    (161, 16, (192, 128)), (192, 128, (192, 128)), (170, 100, (192, 128)),
])  # fmt: skip
def test_a_call_takes_the_smallest_instance_that_holds_both_widths(dqk, dv, instance):
    assert kernel_instance(dqk, dv) == instance
    assert kernel_instance(dqk, dv)[0] >= dqk and kernel_instance(dqk, dv)[1] >= dv


@pytest.mark.parametrize("dqk,dv", [(161, 161), (176, 176), (192, 192), (193, 64), (160, 161), (192, 129),
                                    (256, 64), (0, 64)])
@pytest.mark.parametrize("fn", [kernel_path, kernel_bwd_path])
def test_beyond_the_widest_raises_by_name_before_any_build(no_build, fn, dqk, dv):
    with pytest.raises(ValueError, match="not built") as err:
        fn(torch.bfloat16, dqk, dv)
    if dqk >= 1:
        assert "up to 160" in str(err.value) and "192" in str(err.value)


@pytest.mark.parametrize("d,aligned", [(1, 8), (8, 8), (20, 24), (24, 24), (100, 104), (160, 160)])
def test_widths_reach_the_kernels_as_multiples_of_eight(d, aligned):
    assert flash_kernel._aligned(d) == aligned
    x = torch.randn(2, 3, 5, d)
    padded = flash_kernel._pad_to(x, aligned)
    assert padded.shape[-1] == aligned and torch.equal(padded[..., :d], x)
    assert not padded[..., d:].any()


@pytest.mark.parametrize("dtype,padded", [(torch.bfloat16, True), (torch.float32, False)])
@pytest.mark.parametrize("dqk,dv", [(20, 20), (24, 17), (170, 100)])
def test_only_bf16_pads_a_width_that_is_no_multiple_of_eight(no_build, dtype, padded, dqk, dv):
    """The float32 kernels load and store a float at a time, bounded by the
    true widths: they take such a width, and a strided output, as it is."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.compat import card_stand_in

    with FakeTensorMode(), card_stand_in():
        q, k = torch.empty(1, 5, 2, dqk, dtype=dtype), torch.empty(1, 5, 1, dqk, dtype=dtype)
        v, out = torch.empty(1, 5, 1, dv, dtype=dtype), torch.empty(1, 5, 2, dv, dtype=dtype)
        qt, kt, vt, ot = (x.transpose(1, 2) for x in (q, k, v, out))
        assert flash_kernel._check_fwd(qt, kt, vt, True, ot)[1] is padded
        assert flash_kernel._check_bwd(qt, kt, vt, ot, torch.empty(1, 2, 5), ot, True, qt, None, None)[1] is padded


def test_a_cpu_tensor_is_refused_by_the_kernels_wrappers(no_build):
    q = torch.zeros(1, 2, 8, 24)
    with pytest.raises(ValueError, match="on the card"):
        flash_kernel.flash_attention_fwd(q, q, q)
