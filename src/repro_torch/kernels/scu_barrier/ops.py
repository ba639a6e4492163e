"""The SCU barrier, notifier and self-signal over the stacked party axis.

Counterpart of ``repro/kernels/scu_barrier/ops.py``.  A CUDA tensor goes to
the Hopper kernel (``kernel.scu_barrier``, ``scu_notifier``,
``scu_self_signal``) or the call raises; there is no fallback on the card.
A tensor that lies on the CPU takes the kernel's plain version in ``ref``.

The parties are the rows of the leading axis: ``arrive`` and ``payload`` are
``(n, *s)``, and so is every result.  ``axis`` names that axis, as the
reference's collectives name theirs; here it is always the leading one.

The reference's deprecated ``barrier(arrive, axis, strategy)`` alias, which
dispatched to a policy, is not carried over: the policies' chip barriers are
reached through ``repro_torch.sync.get_policy(name).chip_barrier``, and
:func:`barrier` here is the ``scu`` policy's kernel itself.
"""

from __future__ import annotations

import torch

from .kernel import scu_barrier, scu_notifier, scu_self_signal
from .ref import barrier_ref, notifier_ref, self_signal_ref

__all__ = ["barrier", "notifier", "ref_barrier_count", "self_signal"]


def ref_barrier_count(arrive: torch.Tensor, axis: str) -> torch.Tensor:
    """Oracle: the barrier must release with the full participant count
    (``psum`` over the party axis)."""
    return barrier_ref(arrive)


def barrier(arrive: torch.Tensor) -> torch.Tensor:
    """Every party waits for all; each receives the sum of the arrival rows (K3)."""
    if arrive.is_cuda:
        return scu_barrier(arrive)
    return barrier_ref(arrive)


def notifier(payload: torch.Tensor, axis: str, target: int) -> torch.Tensor:
    """Deliver ``payload`` from every party to ``target``'s slot (any-to-one
    signaling); other parties receive zero -- the SCU notifier's per-core
    event delivery (K4)."""
    if payload.is_cuda:
        return scu_notifier(payload, target)
    return notifier_ref(payload, target)


def self_signal(x: torch.Tensor) -> torch.Tensor:
    """Signal, restful wait, consume on one party: ``x + 1`` (K5)."""
    if x.is_cuda:
        return scu_self_signal(x)
    return self_signal_ref(x)
