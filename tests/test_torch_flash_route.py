"""Which of the flash-attention source's kernels takes a call: a pure function
of (dtype, head dim), held here on the CPU for every built head dim."""

import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS, PATHS, kernel_path

# bf16 at the head dims of phi4, codeqwen, command-r, llava (128) and musicgen
# (64) goes to the Hopper kernel; stablelm's 80 and the smoke configs' 16 to
# the mma.sync kernel; float32 always to the full-precision one
EXPECTED = {
    (torch.bfloat16, 16): "mma_sync",
    (torch.bfloat16, 64): "wgmma",
    (torch.bfloat16, 80): "mma_sync",
    (torch.bfloat16, 128): "wgmma",
    (torch.float32, 16): "f32",
    (torch.float32, 64): "f32",
    (torch.float32, 80): "f32",
    (torch.float32, 128): "f32",
}


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


@pytest.mark.parametrize("d", [8, 48, 96, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_unbuilt_head_dim_raises_before_any_build(no_build, dtype, d):
    with pytest.raises(ValueError, match="not built"):
        kernel_path(dtype, d)


@pytest.mark.parametrize("dtype", [torch.float16, torch.int8])
def test_unbuilt_dtype_raises_before_any_build(no_build, dtype):
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        kernel_path(dtype, 128)
