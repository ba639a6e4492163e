"""Plain PyTorch versions of the SCU barrier, notifier and self-signal kernels.

Counterpart of ``repro/kernels/scu_barrier/ref.py``, over the port's stacked
party axis: the parties are the rows of the leading axis of ``(n, *s)``
tensors on one device.  The CPU tests use these, the card check holds the
CUDA kernels against them, and ``ops`` takes them for tensors that lie on
the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["barrier_ref", "notifier_ref", "self_signal_ref"]


def barrier_ref(arrive: torch.Tensor) -> torch.Tensor:
    """The sum of the arrival rows over the party axis, handed to every party."""
    return arrive.sum(0, keepdim=True).expand_as(arrive).clone()


def notifier_ref(payload: torch.Tensor, target: int) -> torch.Tensor:
    """Every party's row but ``target``'s, summed, delivered to ``target``;
    every other party receives zeros (``repro``'s ``ops.notifier``)."""
    sent = payload.clone()
    sent[target] = 0
    out = torch.zeros_like(payload)
    out[target] = sent.sum(0)
    return out


def self_signal_ref(x: torch.Tensor) -> torch.Tensor:
    """Oracle of the single-core signal/wait/consume roundtrip."""
    return x + 1
