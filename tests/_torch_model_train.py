"""Training over ``{"data": 2, "model": 2}``: the port's group against JAX.

Shared by ``tests/test_torch_dist_model_train.py``,
``tests/test_torch_dist_model_train_moe.py`` and
``tests/test_torch_dist_model_train_ssd.py``, each with its own archs and its
own 4-process group (``tests/_torch_dist.py``, job ``model_train``), so that
each file's JAX compiles and group fit its time in one xdist worker.
``start`` writes one float32 step-0 checkpoint an arch with JAX (both
packages restore it) and spawns the group; ``finish`` runs, in the test
process meanwhile, JAX's ``train`` on ``make_host_mesh(data=2, model=2)``
from the same checkpoint on the same ``SyntheticLM`` batches, and the
port's one-process gradient of the step-0 global batch, then joins the
group.  The checks are functions of those results, each test file's tests
calling them by arch.

Tolerances: losses and grad norms at the reference's resume tolerance
(rtol 1e-5, atol 1e-6); a gradient leaf within 1e-5 of its largest entry (a
missed partial sum over ``model`` is off by about half of it); parameters
after the run within 1e-5 of the leaf's largest entry and 2e-2 of its
largest update over the run (``check_parameter_blocks``: AdamW's division by
each entry's running RMS lifts float32 noise where a gradient is near zero);
the copies of a leaf that more than one process holds, bit for bit
(``check_copies_agree``: nothing broadcasts them, so only equal gradients
keep them equal).
"""

from __future__ import annotations

import dataclasses
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.launch import mesh as jmesh
from repro.models import lm as jlm
from repro.train import checkpoint as jckpt
from repro.train import data as jdata
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch.models.lm import lm_loss
from repro_torch.parallel.sharding import NamedSharding, param_specs
from repro_torch.train.checkpoint import restore_checkpoint
from repro_torch.train.data import SyntheticLM, make_batch_fn
from repro_torch.train.step import abstract_params, value_and_grad
from tests._torch_dist import float32_smoke, leaves_with_path, start_group

GRID = {"data": 2, "model": 2}
STEPS, BATCH, SEQ, LR, WARMUP, RESUME_AT = 3, 4, 16, 1e-2, 2, 2
RTOL, ATOL = 1e-5, 1e-6
GRAD_TOL = PARAM_TOL = 1e-5
UPDATE_TOL = 2e-2


def start(root: Path, runs: tuple, resume_arch=None, launch: tuple = ()):
    """The step-0 checkpoints of ``runs``' archs, written by JAX, and the group started on them."""
    for arch in dict.fromkeys(arch for arch, _, _ in runs):
        jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32")
        jparams = jlm.init_lm(jax.random.PRNGKey(0), jcfg, jnp.float32)
        jckpt.save_checkpoint(str(root / f"step0_{arch}"), 0, {"params": jparams, "opt": jopt.init_opt_state(jparams),
                                                               "step": jnp.asarray(0, jnp.int32)})  # fmt: skip
    return start_group("model_train", 4, root, runs=runs, steps=STEPS, batch=BATCH, seq=SEQ, lr=LR, warmup=WARMUP,
                       resume_at=RESUME_AT, resume_arch=resume_arch, launch=launch)  # fmt: skip


def _jax_train(root: Path, arch: str) -> dict:
    """JAX's ``train`` under ``scu`` on the 2 x 2 host mesh: losses, grad
    norms, the final parameters whole (the reference's policies change the
    schedule, not the math: one run stands for each)."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32")
    shutil.copytree(root / f"step0_{arch}", root / f"jax_{arch}")
    tcfg = jstep.TrainConfig(sync_strategy="scu", remat_policy="none", param_dtype="float32",
                             opt=jopt.OptConfig(lr=LR, warmup_steps=WARMUP))  # fmt: skip
    trainer = jloop.TrainerConfig(steps=STEPS, ckpt_every=1000, ckpt_dir=str(root / f"jax_{arch}"), log_every=1000)
    source = jdata.SyntheticLM(vocab_size=jcfg.vocab_size, seq_len=SEQ, seed=0)
    params, _, hist = jloop.train(jcfg, tcfg, trainer, jmesh.make_host_mesh(data=2, model=2),
                                  lambda i: source.batch(i, batch_size=BATCH))  # fmt: skip
    return {"loss": [h["loss"] for h in hist], "grad_norm": [h["grad_norm"] for h in hist],
            "params": {tuple(k.key for k in path): np.asarray(leaf)
                       for path, leaf in jax.tree_util.tree_leaves_with_path(params)}}  # fmt: skip


def _one_process_grads(root: Path, arch: str) -> tuple:
    """The port's gradient of the step-0 global batch in one process, and
    the step-0 parameters, whole."""
    cfg = float32_smoke(arch)
    params = restore_checkpoint(str(root / f"step0_{arch}"), 0, {"params": abstract_params(cfg, torch.float32)},
                                device="cpu")["params"]  # fmt: skip
    batch = make_batch_fn(SyntheticLM(vocab_size=cfg.vocab_size, seq_len=SEQ, seed=0), BATCH)(0)
    batch = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    _, grads = value_and_grad(lambda p, b: lm_loss(p, cfg, b, remat_policy="none"), params, batch)
    return ({path: g.numpy() for path, g in leaves_with_path(grads)},
            {path: t.numpy() for path, t in leaves_with_path(params)})


def finish(root: Path, group, runs: tuple) -> dict:
    archs = tuple(dict.fromkeys(arch for arch, _, _ in runs))
    jax_side = {arch: _jax_train(root, arch) for arch in archs}
    one = {arch: _one_process_grads(root, arch) for arch in archs}
    return {"jax": jax_side, "one": {arch: g for arch, (g, _) in one.items()},
            "init": {arch: p for arch, (_, p) in one.items()}, "ranks": group.results(), "root": root}


def blocks(arch: str, whole: dict, rank_coords) -> dict:
    """Each leaf's block at ``rank_coords`` (data, model) by the parameter specs."""
    cfg = float32_smoke(arch)
    specs = dict(leaves_with_path(param_specs(abstract_params(cfg, torch.float32), GRID, fsdp=False, cfg=cfg)))
    coords = dict(zip(GRID, rank_coords))
    return {path: leaf[NamedSharding(GRID, specs[path]).index(leaf.shape, coords)] for path, leaf in whole.items()}


def check_losses(got: dict, arch: str, policy: str) -> None:
    want = got["jax"][arch]
    for rank, result in enumerate(got["ranks"]):
        run = result[(arch, policy)]
        assert result["coords"] == divmod(rank, 2)
        np.testing.assert_allclose(run["loss"], want["loss"], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(run["grad_norm"], want["grad_norm"], rtol=RTOL)
    assert got["ranks"][0][(arch, policy)]["loss"][-1] < got["ranks"][0][(arch, policy)]["loss"][0]


def check_gradient_blocks(got: dict, arch: str) -> None:
    """Each rank's step-0 gradient of every leaf (the mean over the data
    processes) is its block of the one-process gradient: a whole leaf whole,
    a split one its block, each within ``GRAD_TOL`` of the leaf's largest entry."""
    for rank, result in enumerate(got["ranks"]):
        want = blocks(arch, got["one"][arch], result["coords"])
        grads = result[(arch, "scu")]["grads"]
        assert sorted(grads) == sorted(want)
        for path, block in want.items():
            assert grads[path].shape == block.shape, (rank, path)
            scale = max(float(np.abs(block).max()), 1e-30)
            np.testing.assert_allclose(grads[path], block, rtol=0, atol=GRAD_TOL * scale, err_msg=f"{rank} {path}")


def check_parameter_blocks(got: dict, arch: str, policy: str = "scu") -> None:
    """Each rank's parameters after the run are its blocks of JAX's, within
    ``PARAM_TOL`` of the leaf's largest entry plus ``UPDATE_TOL`` of its
    largest update over the run: AdamW divides each gradient entry by its own
    running RMS, so where an entry's gradient is near zero the float32 sums
    of another order move its update by a share of a learning rate."""
    for rank, result in enumerate(got["ranks"]):
        want = blocks(arch, got["jax"][arch]["params"], result["coords"])
        start = blocks(arch, got["init"][arch], result["coords"])
        params = result[(arch, policy)]["params"]
        assert sorted(params) == sorted(want)
        for path, block in want.items():
            atol = PARAM_TOL * float(np.abs(block).max()) + UPDATE_TOL * float(np.abs(block - start[path]).max())
            np.testing.assert_allclose(params[path], block, rtol=0, atol=atol, err_msg=f"{rank} {path}")


def check_copies_agree(got: dict, arch: str, policy: str = "scu") -> None:
    """After the run every process that holds a block holds the same bits:
    the data processes of one model coordinate all of their leaves (gathered
    back over data), and all processes a leaf whole over ``model`` (norms,
    the router, a kv projection whole under split q heads), which each
    updates alone."""
    cfg = float32_smoke(arch)
    specs = dict(leaves_with_path(param_specs(abstract_params(cfg, torch.float32), GRID, fsdp=False, cfg=cfg)))
    ranks = got["ranks"]
    whole_over_model = [path for path, spec in specs.items()
                        if "model" not in NamedSharding(GRID, spec).sharded_axes()]  # fmt: skip
    assert whole_over_model, arch
    for result in ranks[1:]:
        same_model = result["coords"][1] == ranks[0]["coords"][1]
        for path in specs if same_model else whole_over_model:
            mine, first = result[(arch, policy)]["params"][path], ranks[0][(arch, policy)]["params"][path]
            np.testing.assert_array_equal(mine.view(np.uint32), first.view(np.uint32), err_msg=f"{result['coords']} {path}")
