"""Elastic scaling and straggler mitigation policies.

At thousand-node scale, failures are routine.  The framework's contract:

  1. **Detection** -- the step watchdog (``loop.py``) flags stragglers;
     at the launcher level, a missing heartbeat marks a pod/host dead.
  2. **Re-carve** -- :func:`shrink_mesh` computes the largest healthy mesh
     compatible with the sharding rules (data axis shrinks first -- model
     parallel degree is preserved so every parameter spec stays valid) and
     :func:`rescale_batch` keeps the *global* batch constant by raising
     grad-accumulation, so training dynamics are unchanged.
  3. **Restore** -- checkpoints are topology-independent
     (``checkpoint.restore_checkpoint`` reassembles global arrays and
     re-shards onto the new mesh), and the data pipeline is a pure function
     of ``step`` -- the restarted run is bit-compatible with a never-failed
     run at the same global batch.
  4. **Straggler mitigation without restart** -- the hierarchical `scu`
     sync schedule confines slow-pod effects: intra-pod collectives
     proceed; only the small inter-pod reduction waits (the paper's
     'do not make everyone spin because one PE is late', Sec. 3.1, at pod
     granularity).

This module is this package's own copy of ``repro/train/elastic.py`` (pure
Python).  Here the meshes are ``{axis: size}`` dicts
(``repro_torch/launch/mesh.py``), and the restore step is
``repro_torch/train/checkpoint.py``'s.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple


__all__ = ["HealthState", "shrink_mesh", "rescale_batch", "plan_recovery"]


@dataclasses.dataclass
class HealthState:
    total_devices: int
    failed_devices: List[int]

    @property
    def healthy(self) -> int:
        return self.total_devices - len(self.failed_devices)


def shrink_mesh(
    health: HealthState, model_parallel: int = 16, pod_size: int = 256
) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """Largest mesh (pod, data, model) that fits the healthy device count.

    The model axis is preserved (param shardings stay valid); whole
    data-parallel replicas are dropped; pods drop when a pod loses too many
    members to host a single replica.
    """
    assert health.healthy >= model_parallel, "cannot preserve model parallelism"
    replicas = health.healthy // model_parallel
    pods = max(1, health.total_devices // pod_size)
    per_pod_replicas = max(1, replicas // pods)
    if pods > 1:
        return (pods, per_pod_replicas, model_parallel), ("pod", "data", "model")
    return (per_pod_replicas, model_parallel), ("data", "model")


def rescale_batch(
    global_batch: int, old_replicas: int, new_replicas: int, grad_accum: int
) -> Tuple[int, int]:
    """Keep the global batch constant across a re-carve: per-replica batch
    rises via gradient accumulation.  Returns (per_replica_batch, accum)."""
    per_replica = global_batch // new_replicas
    # grow accumulation so the per-microbatch size stays what it was
    old_micro = max(1, global_batch // (old_replicas * grad_accum))
    new_accum = max(1, per_replica // old_micro)
    return per_replica, new_accum


def plan_recovery(
    health: HealthState,
    global_batch: int,
    old_mesh_shape: Tuple[int, ...],
    grad_accum: int = 1,
    model_parallel: int = 16,
) -> dict:
    """Full recovery plan: new mesh + batch plan + restore instructions."""
    new_shape, axes = shrink_mesh(health, model_parallel)
    old_replicas = 1
    for d, a in zip(old_mesh_shape, ("pod", "data", "model")[: len(old_mesh_shape)]):
        if a in ("pod", "data"):
            old_replicas *= d
    new_replicas = 1
    for d, a in zip(new_shape, axes):
        if a in ("pod", "data"):
            new_replicas *= d
    per_replica, accum = rescale_batch(
        global_batch, old_replicas, new_replicas, grad_accum
    )
    return {
        "mesh_shape": new_shape,
        "mesh_axes": axes,
        "per_replica_batch": per_replica,
        "grad_accum": accum,
        "action": "restore latest committed checkpoint onto the new mesh; "
        "the data pipeline replays from the checkpointed step",
    }
