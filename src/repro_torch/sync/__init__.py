"""``repro_torch.sync`` -- the unified synchronization-policy API of the port.

    from repro_torch.sync import get_policy, register_policy, available_policies

    policy = get_policy("scu")   # case-insensitive; "SCU" works too
    available_policies()         # ('scu', 'tas', 'sw', 'tree', 'tree4', 'tree_ew', 'fifo')

Counterpart of ``repro.sync``, with a registry of its own.  One
:class:`SyncPolicy` carries the discipline's implementation at every layer:
simulator fragments, chip-level barriers over a stacked party axis (the
``scu`` one is the CUDA kernel K3 on a card), and training-schedule hooks.
See :mod:`repro_torch.sync.api` for the protocol.
"""

from repro_torch.sync.api import (
    LAYER_HOOKS,
    PolicyDef,
    SyncPolicy,
    available_policies,
    canonical_name,
    get_policy,
    register_policy,
    unregister_policy,
)

# Importing the implementation modules registers the builtin policies
# (the paper's triad first, then the tree/tree4/tree_ew tournaments, then
# the producer-consumer event-FIFO discipline).
from repro_torch.sync import policies as _policies  # noqa: F401
from repro_torch.sync import tree as _tree  # noqa: F401
from repro_torch.sync import fifo as _fifo  # noqa: F401
from repro_torch.sync.tree import make_tree_policy
from repro_torch.sync.fifo import fifo_pipeline_programs

__all__ = [
    "LAYER_HOOKS",
    "PolicyDef",
    "SyncPolicy",
    "available_policies",
    "canonical_name",
    "fifo_pipeline_programs",
    "get_policy",
    "make_tree_policy",
    "register_policy",
    "unregister_policy",
]
