"""The SSD scan in the layers' layout: B and C as ``(b, s, g, n)``.

Counterpart of ``repro/kernels/ssd_scan/ops.py``.  A CUDA tensor goes to the
Hopper kernel (``kernel.ssd_scan_fwd``) or the call raises; there is no
fallback on the card.  A tensor that lies on the CPU takes the kernel's
plain version, ``ref.ssd_scan_ref``.  Both return the final state as well.

Only one B/C group is taken (``g == 1``), on either device: the Pallas
kernel is single-group too, and both SSD archs of the registry
(``mamba2-1.3b``, ``jamba-v0.1-52b``) have ``n_groups=1``.

The kernel's launches are counted in ``ssd_scan_fwd.launches``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .kernel import ssd_scan_fwd
from .ref import ssd_scan_ref

__all__ = ["ssd_scan"]


def ssd_scan(
    x: torch.Tensor,  # (b, s, h, p)
    dt: torch.Tensor,  # (b, s, h)
    A: torch.Tensor,  # (h,)
    B: torch.Tensor,  # (b, s, g, n)
    C: torch.Tensor,  # (b, s, g, n)
    *,
    chunk: int,
    initial_state: Optional[torch.Tensor] = None,  # (b, h, p, n)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(y (b, s, h, p) in x.dtype, final_state (b, h, p, n) float32)``."""
    if B.dim() != 4 or B.shape[2] != 1 or C.shape != B.shape:
        raise ValueError(
            f"ssd_scan takes one B/C group, (b, s, 1, n), got B {tuple(B.shape)} C {tuple(C.shape)}: "
            "the kernel (like the Pallas one) is single-group, and so are both SSD archs"
        )
    B, C = B[:, :, 0], C[:, :, 0]
    if x.is_cuda:
        return ssd_scan_fwd(x, dt, A, B, C, chunk=chunk, initial_state=initial_state)
    return ssd_scan_ref(x, dt, A, B, C, chunk=chunk, initial_state=initial_state)
