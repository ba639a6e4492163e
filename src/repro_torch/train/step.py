"""Training step factory: loss -> grads -> sync policy -> AdamW.

Counterpart of ``repro/train/step.py``.  ``make_train_step`` builds the step
for a (model config, train config, mesh) triple.  The mesh is either

  * an ``{axis: size}`` dict: the step runs on the device that holds the
    parameters, one device, and returns the port's spec trees
    (``repro_torch.parallel.sharding.Spec``), the reference's placements,
    which one device does not apply; or
  * a ``DeviceMesh`` over a ``torch.distributed`` group (one process a
    device): the step is data-parallel over the data axes and tensor- and
    expert-parallel over ``model``, and returns the ``NamedSharding`` trees
    it applies.  Each process holds its blocks of the parameters over
    ``model`` (``param_shardings``: heads, MLP hidden units, experts,
    vocabulary rows; ``init_lm(..., shardings=)`` draws them) and takes its
    rows of the global batch.  The forward and its backward split as the
    specs say (``lm_loss(..., shards=Shards.of(...))``, the collectives over
    ``model`` of ``parallel/sharding.py``), so that every gradient is this
    process's block of the whole one, and a MoE layer dispatches the global
    batch as the reference's one program does.  The gradients are shaped by
    the sync policy's collectives over the data axes (``scu``: a
    reduce-scatter onto the ZeRO blocks of the optimizer state); AdamW
    updates this process's blocks; the new parameters are gathered back
    over the data axes and stay split over ``model``; the loss is the mean
    over the global batch.  A leaf whole over ``model`` (the norms, the
    router, a kv projection whole under split q heads) is held and updated
    by every model process alike, and nothing broadcasts it: its copies stay
    equal because each process's gradient of it is the same bits (the
    collective over ``model`` hands every process the same sum, and each
    then runs the same operations on the same inputs).  The CPU tests and
    ``chip_smoke.py``'s mtrain phase compare the copies bit for bit.

One known difference from the reference over a ``DeviceMesh``: the
parameters are held whole over the data axes (``param_specs(...,
fsdp=False)``), where the reference's default FSDP rule also splits each
weight over them and lets XLA gather it in the forward; the optimizer state
takes the policy's placement (``repro_torch.sync.policies.step_opt_state_specs``).
And another: the residual stream stays whole over ``model`` between the
blocks (``TrainConfig.sequence_parallel``, and the reference's residual,
embedding-gradient and logits specs, are placements that change no value:
hints, ``models/lm.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Tuple

import torch

from repro_torch.compat import torch_dtype
from repro_torch.configs.base import ModelConfig, validate_sync_policy
from repro_torch.models.lm import REMAT_POLICIES, init_lm, lm_loss
from repro_torch.parallel import dist as pdist
from repro_torch.parallel.sharding import (
    NamedSharding,
    Spec,
    axis_sizes,
    batch_spec,
    Shards,
    check_data_parallel,
    dp_axes,
    gather,
    is_spec,
    param_specs,
    tree_map_with_path,
)
from repro_torch.sync import SyncPolicy, get_policy
from repro_torch.sync.policies import step_opt_state_specs
from repro_torch.train.optimizer import OptConfig, adamw_update, compress_decompress, tree_leaves, tree_map

__all__ = ["TrainConfig", "abstract_params", "make_train_step", "train_state_specs", "value_and_grad"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    sync_strategy: str = "scu"  # any registered repro_torch.sync policy name
    remat_policy: str = "full"
    param_dtype: str = "bfloat16"
    sequence_parallel: bool = True  # shard the residual carry over "model" (a hint on one device)
    grad_accum: int = 1  # microbatches per step (activation-memory knob)

    def __post_init__(self):
        # canonicalize + fail fast on unknown policies (the error names the
        # registered ones) instead of erroring deep inside a step
        object.__setattr__(self, "sync_strategy", validate_sync_policy(self.sync_strategy))
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat policy {self.remat_policy!r}; choose from {sorted(REMAT_POLICIES)}")

    @property
    def sync_policy(self) -> SyncPolicy:
        return get_policy(self.sync_strategy)


def abstract_params(cfg: ModelConfig, dtype=torch.bfloat16) -> Any:
    """The parameter tree as tensors on the ``meta`` device: shapes and types, no storage."""
    return init_lm(torch.Generator(), cfg, dtype, device="meta")


def train_state_specs(cfg: ModelConfig, tcfg: TrainConfig, mesh) -> Dict[str, Any]:
    """Spec trees for (params, opt_state, step)."""
    params_sds = abstract_params(cfg, torch_dtype(tcfg.param_dtype))
    pspecs = param_specs(params_sds, mesh, cfg=cfg)
    ospecs = tcfg.sync_policy.opt_state_specs(params_sds, mesh, cfg=cfg)
    return {"params": pspecs, "opt": ospecs, "step": Spec()}


def value_and_grad(loss_fn, params: Any, *args) -> Tuple[torch.Tensor, Any]:
    """``(loss_fn(params, *args), its gradient tree)``, as ``jax.value_and_grad``.

    The parameters are taken as leaves of a new graph (``detach``: no copy);
    a leaf the loss does not reach gets zeros, as in JAX.  The stacked block
    groups (``params["blocks"]``, a group an entry of the leading axis) are
    taken as one leaf a group (``unbind``: views) and their gradients stacked
    again: the backward of indexing the stacked tensor would fill and add a
    gradient the size of the whole stack once for every group.
    """

    def leaf(p):
        return p.detach().requires_grad_(True)

    leaves = {k: tree_map(lambda p: [leaf(t) for t in p.unbind(0)], v) if k == "blocks" else tree_map(leaf, v)
              for k, v in params.items()}  # fmt: skip
    flat = [t for x in tree_leaves(leaves) for t in (x if isinstance(x, list) else [x])]
    with torch.enable_grad():
        loss = loss_fn(leaves, *args)
        grads = torch.autograd.grad(loss, flat, allow_unused=True, materialize_grads=True)
    by_id = {id(t): g for t, g in zip(flat, grads)}
    grad_tree = tree_map(lambda x: torch.stack([by_id[id(t)] for t in x]) if isinstance(x, list) else by_id[id(x)],
                         leaves)  # fmt: skip
    return loss.detach(), grad_tree


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh):
    """Returns (step_fn, (in_shardings, batch_shardings), out_shardings, abstract_params).

    ``step_fn(params, opt_state, step, batch) -> (params, opt_state, step,
    metrics)``: ``step`` a 0-d integer tensor, ``batch`` a dict of tensors on
    the parameters' device (over a ``DeviceMesh``: this process's rows),
    ``metrics`` 0-d tensors ``loss``, ``grad_norm`` and ``lr``.  The gradient
    path is shaped by the configured ``repro_torch.sync`` policy.  The opt
    state is updated in place (the reference's jitted step donates it).
    ``in_shardings = (params, opt, step, None)``; ``batch_shardings`` maps a
    batch to its placements.  On a dict mesh these are spec trees, and the
    JAX function's sharding hints to the loss (sequence-parallel residual,
    embedding-gradient and logits specs) are left out: one device has nothing
    to place; over a ``DeviceMesh`` they are the ``NamedSharding`` trees the
    step applies (see the module note).
    """
    policy = tcfg.sync_policy
    param_dtype = torch_dtype(tcfg.param_dtype)
    params_sds = abstract_params(cfg, param_dtype)
    use_int8 = tcfg.opt.compression == "int8"
    accum = max(1, tcfg.grad_accum)
    placed = not isinstance(mesh, Mapping)
    sizes = axis_sizes(mesh)

    if placed:
        check_data_parallel(mesh)
        dp = dp_axes(sizes)
        n_dp = math.prod(sizes[a] for a in dp)

        def to_shardings(specs):
            return tree_map_with_path(lambda path, s: NamedSharding(mesh, s), specs, is_leaf=is_spec)

        params_sh = to_shardings(param_specs(params_sds, sizes, fsdp=False, cfg=cfg))
        opt_sh = {k: to_shardings(v) for k, v in step_opt_state_specs(policy, params_sds, sizes, cfg).items()}
        step_sh = NamedSharding(mesh, Spec())
        in_sh = (params_sh, opt_sh, step_sh, None)
    else:
        specs = train_state_specs(cfg, tcfg, mesh)
        in_sh = (specs["params"], specs["opt"], specs["step"], None)

    def batch_shardings(batch: Dict[str, Any]) -> Dict[str, Any]:
        out = {k: batch_spec(sizes, extra_dims=2 if v.dim() == 3 else 1) for k, v in batch.items()}
        return {k: NamedSharding(mesh, s) for k, s in out.items()} if placed else out

    shards = Shards.of(params_sh) if placed else None

    def loss_fn(p, b):
        return lm_loss(p, cfg, b, remat_policy=tcfg.remat_policy, shards=shards)

    def step_fn(params, opt_state, step, batch):
        if accum == 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
            grads = policy.shape_gradients(grads, params_sds, mesh, cfg=cfg)
        else:
            # gradient accumulation over microbatches into float32 accumulators
            micro = {k: v.reshape((accum, v.shape[0] // accum) + tuple(v.shape[1:])) for k, v in batch.items()}
            gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
            gsum = policy.shape_gradients(gsum, params_sds, mesh, cfg=cfg)
            lsum = torch.zeros((), dtype=torch.float32, device=step.device)
            for i in range(accum):
                loss, g = value_and_grad(loss_fn, params, {k: v[i] for k, v in micro.items()})
                g = policy.shape_gradients(g, params_sds, mesh, cfg=cfg)
                gsum = tree_map(lambda a, b_: a.add_(b_.float()), gsum, g)
                lsum = lsum + loss
                del g
            grads = tree_map(lambda g: g / accum, gsum)
            loss = lsum / accum
        if placed:  # the mean over the global batch: every process's rows are as many
            loss = pdist.all_reduce(loss.clone(), mesh, dp).div_(n_dp)

        master_sh = opt_sh["master"] if placed else None
        if use_int8:
            if placed:
                grads = tree_map(lambda g, s: compress_decompress(g, None, s)[0], grads, master_sh)
            else:
                grads = tree_map(lambda g: compress_decompress(g, None)[0], grads)

        new_params, new_opt, metrics = adamw_update(tcfg.opt, grads, opt_state, step, param_dtype, master_sh)
        if placed:  # params return whole over the data axes (an all-gather of the ZeRO blocks), split over model
            new_params = tree_map(lambda p, s: gather(p, s, dp), new_params, master_sh)
        metrics = dict(metrics, loss=loss)
        return new_params, new_opt, step + 1, metrics

    return step_fn, (in_sh, batch_shardings), in_sh, params_sds
