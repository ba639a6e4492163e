"""Training over the ``model`` axis across processes, against the JAX
package's ``train`` on the same 2 x 2 mesh: tensor-parallel attention with a
whole kv projection under split q heads (phi4) and with every head split
(stablelm), the vocab-parallel cross-entropy, the optimizer state on its
model x data blocks, a checkpoint of the group, and the launcher.

Port side: one group of 4 processes on ``{"data": 2, "model": 2}``
(``tests/_torch_dist.py``, job ``model_train``), spawned once for this file:
``train`` under ``scu`` (phi4 also under ``tas``; stablelm under remat
"dots", whose recompute issues the collectives again beside the cached
``mm`` outputs) from one float32 step-0 checkpoint that JAX wrote, 3 steps at batch 4 and sequence 16 of
``SyntheticLM``; each rank's step-0 gradient; a run saved at step 2 and
resumed; int8 compression of a block split over ``model``; the launcher's
``main`` in the group.  JAX side and the port's one-process gradient,
meanwhile, in the test process (``tests/_torch_model_train.py``, with the
tolerances).  Beside them, the launcher under ``torchrun`` with 4 processes.
MLA and the MoE layer are in ``tests/test_torch_dist_model_train_moe.py``,
the SSD mixer in ``tests/test_torch_dist_model_train_ssd.py``, each with a
group of its own.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.parallel.sharding import NamedSharding, param_specs
from repro_torch.sync import get_policy
from repro_torch.sync.policies import step_opt_state_specs
from repro_torch.train.checkpoint import restore_checkpoint
from repro_torch.train.data import SyntheticLM, make_batch_fn
from repro_torch.train.loop import TrainerConfig, train
from repro_torch.train.optimizer import init_opt_state
from repro_torch.train.step import abstract_params
from tests import _torch_model_train as mt
from tests._torch_dist import bits, float32_smoke, leaves_with_path, train_config

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ("phi4-mini-3.8b", "stablelm-3b")
RUNS = (("phi4-mini-3.8b", "scu", "none"), ("phi4-mini-3.8b", "tas", "none"), ("stablelm-3b", "scu", "dots"))
RESUME_ARCH = "phi4-mini-3.8b"
LAUNCH = ["--arch", "phi4-mini-3.8b", "--smoke", "--device", "cpu", "--mesh", "host", "--steps", "2", "--batch", "4",
          "--seq", "16", "--ckpt-every", "2"]  # fmt: skip


@pytest.fixture(scope="module")
def got(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_model_train")
    group = mt.start(root, RUNS, RESUME_ARCH, tuple(LAUNCH))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    launched = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
         "-m", "repro_torch.launch.train", *LAUNCH, "--ckpt-dir", str(root / "torchrun")],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)  # fmt: skip
    try:
        out = mt.finish(root, group, RUNS)
        out["torchrun"] = launched.communicate(timeout=120) + (launched.returncode,)
    finally:
        if launched.poll() is None:
            launched.kill()
            launched.communicate()
    return out


@pytest.mark.parametrize("arch,policy", [(arch, policy) for arch, policy, _ in RUNS])
def test_losses_and_grad_norms_equal_the_jax_train_on_2x2(got, arch, policy):
    mt.check_losses(got, arch, policy)


@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_gradient_is_its_block_of_the_one_process_gradient(got, arch):
    mt.check_gradient_blocks(got, arch)


@pytest.mark.parametrize("arch,policy", [(arch, policy) for arch, policy, _ in RUNS])
def test_parameter_blocks_after_three_steps_equal_jax(got, arch, policy):
    mt.check_parameter_blocks(got, arch, policy)


@pytest.mark.parametrize("arch,policy", [(arch, policy) for arch, policy, _ in RUNS])
def test_every_copy_of_a_block_holds_the_same_bits(got, arch, policy):
    mt.check_copies_agree(got, arch, policy)


@pytest.mark.parametrize("policy", ["scu", "tas"])
def test_each_rank_holds_its_model_block_of_the_optimizer_state(got, policy):
    """Under ``scu`` each rank holds its model x data block of master, m and
    v (the ZeRO split over data on the model blocks); under ``tas`` its
    model block, whole over data."""
    cfg = float32_smoke(RESUME_ARCH)
    sds = abstract_params(cfg, torch.float32)
    specs = step_opt_state_specs(get_policy(policy), sds, mt.GRID, cfg)
    model_blocks = dict(leaves_with_path(param_specs(sds, mt.GRID, fsdp=False, cfg=cfg)))
    whole = dict(leaves_with_path(sds))
    axes_seen = set()
    for result in got["ranks"]:
        for key in ("master", "m", "v"):
            shapes = result[(RESUME_ARCH, policy)]["opt_shapes"][key]
            spec = dict(leaves_with_path(specs[key]))
            assert sorted(shapes) == sorted(whole)
            for path, leaf in whole.items():
                sharding = NamedSharding(mt.GRID, spec[path])
                assert shapes[path] == sharding.shard_shape(leaf.shape), (policy, key, path)
                model = NamedSharding(mt.GRID, model_blocks[path])
                assert ("model" in sharding.sharded_axes()) == ("model" in model.sharded_axes()), path
                axes_seen |= set(sharding.sharded_axes())
    assert axes_seen == ({"data", "model"} if policy == "scu" else {"model"})


def test_a_group_checkpoint_restores_in_one_process_bit_for_bit(got):
    """The step-2 checkpoint the group saved (one slot a rank) restored
    whole in one process: each rank's blocks, bit for bit."""
    cfg = float32_smoke(RESUME_ARCH)
    sds = abstract_params(cfg, torch.float32)
    target = {"params": sds, "opt": init_opt_state(sds), "step": torch.zeros((), dtype=torch.int32, device="meta")}
    whole = restore_checkpoint(str(got["root"] / "resume"), mt.RESUME_AT, target, device="cpu")
    assert int(whole["step"]) == mt.RESUME_AT
    tcfg = train_config("scu", mt.LR, mt.WARMUP)
    specs = {"params": param_specs(sds, mt.GRID, fsdp=False, cfg=cfg),
             **step_opt_state_specs(tcfg.sync_policy, sds, mt.GRID, cfg)}  # fmt: skip
    index = json.loads((got["root"] / "resume" / f"step_{mt.RESUME_AT:09d}" / "index.json").read_text())
    assert {len(a["shards"]) for a in index["arrays"].values()} == {4}
    for result in got["ranks"]:
        coords = dict(zip(mt.GRID, result["coords"]))
        for key, tree in (("params", whole["params"]), *whole["opt"].items()):
            spec = dict(leaves_with_path(specs[key]))
            for path, leaf in leaves_with_path(tree):
                block = leaf[NamedSharding(mt.GRID, spec[path]).index(tuple(leaf.shape), coords)]
                np.testing.assert_array_equal(result["saved"][key][path], bits(block), err_msg=f"{key} {path}")


def test_a_group_checkpoint_resumes_in_the_group_to_the_uninterrupted_losses(got):
    for result in got["ranks"]:
        np.testing.assert_allclose(result["resumed"], result[(RESUME_ARCH, "scu")]["loss"][mt.RESUME_AT:],
                                   rtol=mt.RTOL, atol=mt.ATOL)  # fmt: skip


def test_a_group_checkpoint_resumes_in_one_process(got, tmp_path):
    """The group's step-2 checkpoint resumed by one process on one device:
    the group's step-2 loss (the model axis's sums in another order)."""
    import shutil

    shutil.copytree(got["root"] / "resume", tmp_path / "one")
    for step_dir in (tmp_path / "one").iterdir():
        if int(step_dir.name.split("_")[1]) > mt.RESUME_AT:
            shutil.rmtree(step_dir)
    cfg = float32_smoke(RESUME_ARCH)
    trainer = TrainerConfig(steps=mt.STEPS, ckpt_every=1000, ckpt_dir=str(tmp_path / "one"), log_every=1000)
    batch_fn = make_batch_fn(SyntheticLM(vocab_size=cfg.vocab_size, seq_len=mt.SEQ, seed=0), mt.BATCH)
    _, _, hist = train(cfg, train_config("scu", mt.LR, mt.WARMUP), trainer, {"data": 1, "model": 1}, batch_fn,
                       device="cpu")  # fmt: skip
    np.testing.assert_allclose([h["loss"] for h in hist], got["ranks"][0][(RESUME_ARCH, "scu")]["loss"][mt.RESUME_AT:],
                               rtol=mt.RTOL, atol=mt.ATOL)  # fmt: skip


@pytest.mark.parametrize("split", ["model", "both"])
def test_int8_compression_of_a_model_block_scales_by_the_whole_tensor(got, split):
    results = got["ranks"]
    for result in results:
        np.testing.assert_array_equal(result[("int8_block", split)], result[("int8_whole", split)])
    assert not np.array_equal(results[0][("int8_block", split)], results[1][("int8_block", split)])


def test_the_launcher_under_torchrun_trains_on_data2_model2(got):
    """``--mesh host`` over 4 processes is ``{"data": 2, "model": 2}``: its
    checkpoint holds 4 slots a leaf, split over both axes, and equals, bit
    for bit, the checkpoint of the launcher's ``main`` run in the group with
    the same arguments, whose step losses it printed."""
    stdout, stderr, code = got["torchrun"]
    assert code == 0, stderr[-3000:]
    ranks = got["ranks"]
    assert all(r["launched_mesh"] == mt.GRID for r in ranks)
    assert stdout.count("[train] step     0 loss") == 1
    assert f"loss {ranks[0]['launched_loss'][0]:.4f}" in stdout
    step = "step_000000002"
    ours = json.loads((got["root"] / "torchrun" / step / "index.json").read_text())
    theirs = json.loads((got["root"] / "launched" / step / "index.json").read_text())
    assert ours == theirs and {len(a["shards"]) for a in ours["arrays"].values()} == {4}
    table = ours["arrays"]["params/embed/table"]["shards"]
    assert len({json.dumps(s["index"]) for s in table}) == 2  # the vocabulary split over model
    a = np.load(got["root"] / "torchrun" / step / "host_0.npz")
    b = np.load(got["root"] / "launched" / step / "host_0.npz")
    assert sorted(a.files) == sorted(b.files)
    for key in a.files:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
