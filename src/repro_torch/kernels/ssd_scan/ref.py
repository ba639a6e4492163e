"""Plain PyTorch version of the SSD scan kernel (single B/C group).

Counterpart of ``repro/kernels/ssd_scan/ref.py``: a call into the port's own
``ssd_chunked``.  Unlike the JAX oracle it also returns the final state and
takes an initial one, as the kernel does.  The CPU tests use it, the card
check holds the CUDA kernel against it, and ``ops`` takes it for tensors
that lie on the CPU.  Nothing on the card's main path calls it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models.layers.ssm import ssd_chunked

__all__ = ["ssd_scan_ref"]


def ssd_scan_ref(
    x: torch.Tensor,  # (b, s, h, p)
    dt: torch.Tensor,  # (b, s, h)
    A: torch.Tensor,  # (h,)
    B: torch.Tensor,  # (b, s, n) single group
    C: torch.Tensor,  # (b, s, n)
    chunk: int = 256,
    initial_state: Optional[torch.Tensor] = None,  # (b, h, p, n)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(y (b, s, h, p) in x.dtype, final_state (b, h, p, n) float32)``."""
    return ssd_chunked(x, dt, A, B[:, :, None, :], C[:, :, None, :], chunk, initial_state)
