"""What the kernels' work costs: FLOPs from the shapes, and the least time
on one H100.

One definition serves the kernels' bounds in ``chip_smoke.py`` and the FLOP
formulas that the kernels' custom ops register for
``torch.utils.flop_counter`` (the dry run's count).  The card's peaks are
``repro_torch/hardware.py``'s.
"""

from __future__ import annotations

from ..hardware import HBM_BW, PEAK_FLOPS

__all__ = ["attention_bwd_bound", "attention_flops", "bound", "ssd_flops"]


def bound(nbytes: float, flops: float, dtype_name: str):
    """Least time for the work: (ms, 'bytes' | 'operations'), the larger of the two."""
    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_flops(b, h, sq, sk, d, dv, causal) -> int:
    """Two products for every (query, key) pair that the mask keeps: q k^T
    (2*d FLOP) and p v (2*dv FLOP)."""
    pairs = sq * (sq + 1) // 2 if causal else sq * sk
    return 2 * (d + dv) * b * h * pairs


def attention_bwd_bound(b, h, kvh, s, d, dv, dtype_name):
    """K1's backward, causal, sq = sk = s.  Bytes: q, k, v, out, dout and lse
    read once, dq, dk, dv written once.  Operations: the function's five
    products (S again, dP, dV, dK, dQ), 2.5x the forward's, which the bf16
    one pass takes exactly, at every instance."""
    size = 2 if dtype_name == "bfloat16" else 4
    nbytes = size * (2 * d * (b * h * s + b * kvh * s) + dv * (b * kvh * s + 2 * b * h * s) + dv * b * kvh * s)
    nbytes += 4 * b * h * s
    return bound(nbytes, 2.5 * attention_flops(b, h, s, s, d, dv, True), dtype_name)


def ssd_flops(b, s, h, p, n, chunk) -> int:
    """Operations of the chunked SSD form, as the reference computes it: per
    (batch, head, chunk of Q), C B^T over the j <= i pairs only (the masked
    half not counted; counted per head, as the reference and the kernel
    compute it per head), those scores times x (j <= i), C times the carried
    state, and the state update: 2 FLOP a multiply-add.  The kernel's second
    (lo) products and the elementwise exp, decay and cumsum are not counted."""
    nc = s // chunk
    pairs = chunk * (chunk + 1) // 2
    return b * h * nc * (2 * pairs * (n + p) + 4 * chunk * n * p)
