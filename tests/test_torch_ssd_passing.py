"""The SSD scan's three-phase decomposition, its form and its route, on the CPU.

The bf16 kernel computes the scan in three phases (each chunk's own part, the
state handed on between segments of chunks, then the outputs); it has no CPU
form, so ``ref.ssd_scan_passing_ref``, the same phases in plain PyTorch, is
held here against the JAX package's ``ssd_chunked`` on numpy inputs drawn
from a fixed seed.  Tolerance: float32 2e-5, the same f32 arithmetic summed
in another order (and 1e-4 where an initial state decays through up to 256
chunk steps, as ``tests/test_models.py`` holds the continuation).

``scan_form`` (which form the kernel takes) is a pure function of the shapes
and the card's cluster limit, held here at the serving, smoke and jamba
shapes.  The kernel itself is held against the plain version on the card by
``tests/test_torch_cuda_kernels.py``.
"""

import numpy as np
import pytest
import torch

from repro.models.layers import ssm as jssm
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan.kernel import SHAPES, TILE, ScanForm, scan_form
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_scan_passing_ref, ssd_scan_ref

from _torch_parity import both, close, normal


def _inputs(seed, b, s, h, p, n):
    """(jax, torch) pairs of x, dt, A, B, C, initial_state, drawn as tests/test_kernels.py draws them."""
    rng = np.random.default_rng(seed)
    x = both(normal(rng, b, s, h, p) * 0.5)
    dt = both(np.log1p(np.exp(normal(rng, b, s, h))))  # softplus
    A = both(-np.exp(normal(rng, h) * 0.3))
    B = both(normal(rng, b, s, 1, n) * 0.3)
    C = both(normal(rng, b, s, 1, n) * 0.3)
    init = both(normal(rng, b, h, p, n))
    return x, dt, A, B, C, init


# (s, chunk, split): one segment, segments of one chunk, a segment count that
# does not divide the chunks (13 = 4 + 4 + 4 + 1), the smoke chunk of 11 and
# jamba's 12 (ragged against the kernel's tile of 64), one chunk
@pytest.mark.parametrize(
    "s,chunk,split",
    [(128, 32, 4), (128, 16, 1), (208, 16, 4), (132, 11, 5), (48, 12, 3), (96, 96, 1), (256, 64, 2)],
)
@pytest.mark.parametrize("with_init", [False, True])
def test_passing_ref_matches_jax_ssd_chunked(s, chunk, split, with_init):
    b, h, p, n = 2, 3, 16, 32
    (jx, x), (jdt, dt), (jA, A), (jB, B), (jC, C), (jinit, init) = _inputs(s + chunk, b, s, h, p, n)
    jy, jst = jssm.ssd_chunked(jx, jdt, jA, jB, jC, chunk, jinit if with_init else None)
    y, st = ssd_scan_passing_ref(x, dt, A, B[:, :, 0], C[:, :, 0], chunk, split, init if with_init else None)
    assert y.shape == (b, s, h, p) and y.dtype == torch.float32
    assert st.shape == (b, h, p, n) and st.dtype == torch.float32
    close(y, jy, 2e-5)
    close(st, jst, 2e-5)


def test_passing_ref_hands_the_initial_state_on():
    """The initial state reaches every segment: with it y differs, and the
    second half from the first half's final state equals the whole."""
    b, s, h, p, n = 1, 256, 2, 16, 16
    _, (_, dt), (_, A), (_, B), (_, C), (_, init) = _inputs(5, b, s, h, p, n)
    x = torch.from_numpy(normal(np.random.default_rng(6), b, s, h, p) * 0.5)
    B, C = B[:, :, 0], C[:, :, 0]
    y0, _ = ssd_scan_passing_ref(x, dt, A, B, C, 16, 4)
    y1, st = ssd_scan_passing_ref(x, dt, A, B, C, 16, 4, init)
    assert (y1 - y0).abs().max().item() > 1e-3
    _, st1 = ssd_scan_passing_ref(x[:, :128], dt[:, :128], A, B[:, :128], C[:, :128], 16, 3, init)
    y2, st2 = ssd_scan_passing_ref(x[:, 128:], dt[:, 128:], A, B[:, 128:], C[:, 128:], 16, 3, st1)
    close(y2, y1[:, 128:], 1e-4)
    close(st2, st, 1e-4)


def test_passing_ref_strong_decay():
    """dt A about -50 a token: exp(cum) underflows to 0 and nothing is NaN."""
    b, s, h, p, n = 1, 128, 2, 16, 16
    (jx, x), (jdt, dt), _, (jB, B), (jC, C), (jinit, init) = _inputs(8, b, s, h, p, n)
    jA, A = both(np.full((h,), -50.0, dtype=np.float32))
    jy, jst = jssm.ssd_chunked(jx, jdt, jA, jB, jC, 64, jinit)
    y, st = ssd_scan_passing_ref(x, dt, A, B[:, :, 0], C[:, :, 0], 64, 1, init)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    close(y, jy, 2e-5)
    close(st, jst, 2e-5)


# scan_form at the shapes the serving paths give the kernel, each at the
# cluster limit of an H100 (the portable 8), at a limit of 16 (more than the
# kernel takes: the form stays within 8) and at that of a card with no
# cluster launch (1), and once at a limit of 2.
# (b, h, s, chunk, p, n) -> {limit: (k, tiles)}
FORMS = {
    # mamba2-1.3b's 4 x 4096 prefill: 256 (batch, head) pairs fill the card alone
    (4, 64, 4096, 256, 64, 128): {16: (1, 64), 8: (1, 64), 1: (1, 64)},
    # one mamba2-1.3b sequence of 4096: 64 pairs, 2 CTAs each
    (1, 64, 4096, 256, 64, 128): {16: (2, 32), 8: (2, 32), 1: (1, 64)},
    # 16 pairs of one chunk: k up to its 4 tiles only
    (1, 16, 256, 256, 64, 128): {16: (4, 1), 8: (4, 1), 1: (1, 4)},
    # the smoke configs' dims in chunks of 11: 3 tiles, the last ragged
    (2, 2, 132, 11, 16, 16): {16: (2, 2), 8: (2, 2), 1: (1, 3)},
    # jamba's (64, 16) at its 128 heads and the serving request
    (4, 128, 4096, 256, 64, 16): {16: (1, 64), 8: (1, 64), 1: (1, 64)},
    # jamba's dims in the card tests: one tile
    (2, 3, 48, 12, 64, 16): {16: (1, 1), 8: (1, 1), 1: (1, 1)},
    # one sequence, one head: clusters of 8, the most the kernel takes
    (1, 1, 4096, 256, 64, 128): {16: (8, 8), 8: (8, 8), 1: (1, 64)},
    # 8 pairs in a card that allows only clusters of 2
    (1, 8, 4096, 256, 64, 128): {2: (2, 32)},
}


@pytest.mark.parametrize("shape,limit", [(shape, limit) for shape in sorted(FORMS) for limit in FORMS[shape]], ids=str)
def test_scan_form(shape, limit):
    b, h, s, chunk, p, n = shape
    form = scan_form(b, h, s, chunk, p, n, limit)
    assert form == ScanForm(*FORMS[shape][limit])
    tiles = -(-s // TILE)
    assert 1 <= form.cluster <= min(limit, tiles) and form.cluster * form.tiles >= tiles
    assert form.name == ("sequential" if form.cluster == 1 else f"cluster{form.cluster}")


def test_scan_form_takes_every_built_shape():
    assert ssd_kernel.MAX_CLUSTER == 8
    for p, n in SHAPES:
        assert scan_form(1, 1, 4096, 256, p, n, 16).cluster == 8
        assert scan_form(4, 64, 4096, 256, p, n, 16).cluster == 1


@pytest.mark.parametrize(
    "args,match",
    [
        ((1, 1, 64, 32, 48, 16, 8), "not built"),
        ((1, 1, 64, 48, 64, 128, 8), "chunk"),
        ((1, 1, 512, 512, 64, 128, 8), "chunk"),
        ((1, 0, 64, 32, 64, 128, 8), "empty"),
        ((1, 1, 64, 32, 64, 128, 0), "cluster_limit"),
    ],
)
def test_scan_form_refuses(args, match):
    with pytest.raises(ValueError, match=match):
        scan_form(*args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ops_on_cpu_tensors_is_the_plain_version(dtype):
    b, s, h, p, n = 2, 64, 2, 16, 16
    (_, x), (_, dt), (_, A), (_, B), (_, C), (_, init) = _inputs(9, b, s, h, p, n)
    x, B, C = x.to(dtype), B.to(dtype), C.to(dtype)
    before = ssd_kernel.ssd_scan_fwd.launches
    y, st = ssd_scan(x, dt, A, B, C, chunk=16, initial_state=init)
    ry, rst = ssd_scan_ref(x, dt, A, B[:, :, 0], C[:, :, 0], chunk=16, initial_state=init)
    assert ssd_kernel.ssd_scan_fwd.launches == before
    assert torch.equal(y, ry) and torch.equal(st, rst)


def test_kernel_refuses_cpu_tensors():
    (_, x), (_, dt), (_, A), (_, B), (_, C), _ = _inputs(10, 1, 64, 2, 16, 16)
    with pytest.raises(ValueError, match="on the card"):
        ssd_kernel.ssd_scan_fwd(x, dt, A, B[:, :, 0], C[:, :, 0], chunk=16)
