"""Data-parallel training and serving of the port over processes against
the JAX package's ``train`` on a (data=2, model=1) host mesh.

Port side: one group of 2 processes (``tests/_torch_dist.py``) on
``{"data": 2, "model": 1}``, spawned once for this file: the port's ``train``
under ``scu``, ``tas`` and ``sw``, and ``tree`` and ``fifo`` beside them (the
sync policies' gradient collectives, ``scu``'s with its ZeRO optimizer
state), a run resumed in the group, and int8 compression on a ZeRO block.  JAX side, meanwhile, in the test process: ``train``
under ``scu`` on the 2 host devices (the reference's three policies change
the schedule, not the math: ``tests/test_train.py::test_sync_strategies_numerically_identical``;
their losses on this run are bit for bit the same, so one compile stands
for the three).  Both start from one float32 step-0 checkpoint that JAX
wrote, and take the same ``SyntheticLM`` global batches.  Losses at the
reference's resume tolerance (rtol 1e-5, atol 1e-6,
``tests/test_train.py::test_checkpoint_resume_is_exact``).
"""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.launch import mesh as jmesh
from repro.models import lm as jlm
from repro.train import checkpoint as jckpt
from repro.train import data as jdata
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch.sync import get_policy
from repro_torch.train import data as tdata
from repro_torch.train import loop as tloop
from repro_torch.train.step import abstract_params
from tests._torch_dist import float32_smoke, leaves_with_path, start_group, train_config

ARCH = "stablelm-3b"
POLICIES = ("scu", "tas", "sw", "tree", "fifo")  # the paper's three, a tournament, the staged hand-off
ZERO = ("scu", "tree", "fifo")  # the policies whose optimizer state is ZeRO-split
STEPS, BATCH, SEQ, LR, WARMUP, RESUME_AT = 6, 4, 16, 1e-2, 5, 3


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's ``scu`` losses, the group's results by rank, the work directory)."""
    root = tmp_path_factory.mktemp("dist_train")
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), dtype="float32")
    jparams = jlm.init_lm(jax.random.PRNGKey(0), jcfg, jnp.float32)
    jckpt.save_checkpoint(str(root / "step0"), 0, {"params": jparams, "opt": jopt.init_opt_state(jparams),
                                                   "step": jnp.asarray(0, jnp.int32)})  # fmt: skip
    group = start_group("data_parallel", 2, root, arch=ARCH, policies=POLICIES, steps=STEPS, batch=BATCH, seq=SEQ,
                        lr=LR, warmup=WARMUP, resume_at=RESUME_AT)  # fmt: skip
    mesh = jmesh.make_host_mesh(data=2, model=1)
    source = jdata.SyntheticLM(vocab_size=jcfg.vocab_size, seq_len=SEQ, seed=0)
    shutil.copytree(root / "step0", root / "jax_scu")
    tcfg = jstep.TrainConfig(sync_strategy="scu", remat_policy="none", param_dtype="float32",
                             opt=jopt.OptConfig(lr=LR, warmup_steps=WARMUP))  # fmt: skip
    trainer = jloop.TrainerConfig(steps=STEPS, ckpt_every=1000, ckpt_dir=str(root / "jax_scu"), log_every=1000)
    _, _, hist = jloop.train(jcfg, tcfg, trainer, mesh, lambda i: source.batch(i, batch_size=BATCH))
    return {key: [h[key] for h in hist] for key in ("loss", "grad_norm")}, group.results(), root


@pytest.mark.parametrize("policy", POLICIES)
def test_data_parallel_losses_equal_the_jax_train(runs, policy):
    jax_run, results, _ = runs
    for rank, result in enumerate(results):
        assert len(result[policy]["loss"]) == STEPS, rank
        np.testing.assert_allclose(result[policy]["loss"], jax_run["loss"], rtol=1e-5, atol=1e-6)
        # the global norm: ZeRO blocks' squares summed over the data processes, whole leaves once
        np.testing.assert_allclose(result[policy]["grad_norm"], jax_run["grad_norm"], rtol=1e-5)
    assert results[0][policy]["loss"] == results[1][policy]["loss"]  # the loss is the global batch's mean
    assert results[0][policy]["loss"][-1] < results[0][policy]["loss"][0]


@pytest.mark.parametrize("policy", POLICIES)
def test_zero_state_is_half_a_rank_under_scu_and_whole_under_the_baselines(runs, policy):
    """Under ``scu`` (and ``tree``, ``fifo``) every leaf with a dimension the
    2 data ranks divide holds half of its master, m and v on each rank (the
    rest whole); under ``tas`` and ``sw`` every rank holds the whole state."""
    _, results, _ = runs
    cfg = float32_smoke(ARCH)
    whole = {path: tuple(t.shape) for path, t in leaves_with_path(abstract_params(cfg, torch.float32))}
    split = 0
    for result in results:
        for key in ("master", "m", "v"):
            shapes = result[policy]["opt_shapes"][key]
            assert sorted(shapes) == sorted(whole)
            for path, shape in whole.items():
                divisible = any(d % 2 == 0 for d in shape)
                want = np.prod(shape) // 2 if policy in ZERO and divisible else np.prod(shape)
                assert np.prod(shapes[path]) == want, (policy, key, path, shapes[path], shape)
                split += np.prod(shapes[path]) < np.prod(shape)
    assert (split > 0) == (policy in ZERO)
    specs = get_policy(policy).opt_state_specs(abstract_params(cfg, torch.float32), {"data": 2, "model": 1}, cfg)
    assert set(specs) == {"master", "m", "v"}


def test_a_run_resumed_in_the_group_equals_the_uninterrupted_run(runs):
    _, results, _ = runs
    for result in results:
        np.testing.assert_allclose(result["resumed"], result["scu"]["loss"][RESUME_AT:], rtol=1e-5, atol=1e-6)


def test_a_checkpoint_of_the_group_resumes_in_one_process(runs, tmp_path):
    """The 2-rank run's step-3 checkpoint (one slot a rank, ZeRO halves under
    ``scu``) resumed by one process on one device: the group's losses."""
    _, results, root = runs
    ckpt_dir = tmp_path / "one"
    shutil.copytree(root / "resume", ckpt_dir)
    for step_dir in ckpt_dir.iterdir():
        if int(step_dir.name.split("_")[1]) > RESUME_AT:
            shutil.rmtree(step_dir)
    cfg = float32_smoke(ARCH)
    source = tdata.SyntheticLM(vocab_size=cfg.vocab_size, seq_len=SEQ, seed=0)
    trainer = tloop.TrainerConfig(steps=STEPS, ckpt_every=1000, ckpt_dir=str(ckpt_dir), log_every=1000)
    _, _, hist = tloop.train(cfg, train_config("scu", LR, WARMUP), trainer, {"data": 1, "model": 1},
                             lambda i: source.batch(i, batch_size=BATCH), device="cpu")  # fmt: skip
    np.testing.assert_allclose([h["loss"] for h in hist], results[0]["scu"]["loss"][RESUME_AT:], rtol=1e-5, atol=1e-6)


def test_int8_compression_of_a_zero_block_scales_by_the_whole_tensor(runs):
    _, results, _ = runs
    for result in results:
        np.testing.assert_array_equal(result["int8_block"], result["int8_whole"])
    assert not np.array_equal(results[0]["int8_block"], results[1]["int8_block"])
