"""The training loop, the checkpoint, the data pipeline, the mesh and the
elastic plan of the port against the JAX package's.

The data copy and the checkpoints are held bit for bit: the same draws, and
files that either package reads.  The loop is held to the reference's resume
tolerance (``tests/test_train.py::test_checkpoint_resume_is_exact``) and, as
a whole, to JAX ``train`` resumed from one checkpoint that JAX wrote, at the
train step's tolerances (``tests/test_torch_train.py``).  Everything runs on
the CPU.
"""

import dataclasses
import json
import os
import subprocess
import sys
import weakref
from pathlib import Path

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
from repro.train import elastic as jelastic
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch import mesh as tmesh
from repro_torch.parallel.sharding import Spec
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import data as tdata
from repro_torch.train import elastic as telastic
from repro_torch.train import loop as tloop
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep

ROOT = Path(__file__).resolve().parent.parent
MESH = {"data": 1, "model": 1}
FAST_OPT = dict(lr=1e-2, warmup_steps=5)


def _bits(x):
    """A jax array or a tensor as a numpy array of its bits (bf16 as uint16)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    arr = np.asarray(x)
    return arr.view(np.uint16) if arr.dtype.name == "bfloat16" else arr


def _same_bits(a, b):
    a, b = _bits(a), _bits(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# The data pipeline: an own copy, the same draws
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,step,shard,n_shards", [(0, 0, 0, 1), (3, 7, 1, 2), (9, 5, 3, 4), (123, 1000, 0, 4)])
def test_synthetic_lm_is_the_reference_bit_for_bit(seed, step, shard, n_shards):
    mine = tdata.SyntheticLM(vocab_size=97, seq_len=12, seed=seed)
    ref = jdata.SyntheticLM(vocab_size=97, seq_len=12, seed=seed)
    got, want = mine.batch(step, 8, shard, n_shards), ref.batch(step, 8, shard, n_shards)
    assert set(got) == set(want) == {"tokens", "labels"}
    for key in want:
        _same_bits(torch.from_numpy(got[key]), want[key])
    fn_got, fn_want = tdata.make_batch_fn(mine, 8)(step), jdata.make_batch_fn(ref, 8)(step)
    for key in fn_want:
        np.testing.assert_array_equal(fn_got[key], fn_want[key])


def test_memmap_tokens_is_the_reference_bit_for_bit(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 50_000, size=4001, dtype=np.uint16).tofile(path)
    mine = tdata.MemmapTokens(str(path), vocab_size=50_000, seq_len=16, seed=2)
    ref = jdata.MemmapTokens(str(path), vocab_size=50_000, seq_len=16, seed=2)
    for step, shard, n_shards in [(0, 0, 1), (4, 1, 2), (11, 3, 4)]:
        got, want = mine.batch(step, 8, shard, n_shards), ref.batch(step, 8, shard, n_shards)
        for key in ("tokens", "labels"):
            assert got[key].dtype == want[key].dtype == np.int32
            np.testing.assert_array_equal(got[key], want[key])


def test_data_pipeline_deterministic_and_sharded():
    """Twin of ``tests/test_train.py::test_data_pipeline_deterministic_and_sharded``."""
    d = tdata.SyntheticLM(vocab_size=64, seq_len=8, seed=9)
    b1 = d.batch(step=5, batch_size=8)
    b2 = d.batch(step=5, batch_size=8)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    b3 = d.batch(step=6, batch_size=8)
    assert not np.array_equal(b1["tokens"], b3["tokens"])
    # labels are next tokens
    np.testing.assert_array_equal(b1["labels"][:, :-1], b1["tokens"][:, 1:])


# ---------------------------------------------------------------------------
# The checkpoint
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip_one_device(tmp_path):
    """Twin of ``tests/test_train.py::test_checkpoint_roundtrip_sharded`` on
    one device: f32, bf16 and int32 scalar leaves come back bit for bit, and
    the spec trees given as ``shardings`` are applied to nothing."""
    x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    tree = {"a": x, "b": torch.tensor(3.5), "c": {"w": (x / 7).to(torch.bfloat16)}, "step": torch.tensor(4, dtype=torch.int32)}
    tckpt.save_checkpoint(str(tmp_path), 7, tree)
    meta = topt.tree_map(lambda t: t.to("meta"), tree)
    specs = {"a": Spec("data", "model"), "b": Spec(), "c": {"w": Spec(None, "model")}, "step": Spec()}
    restored = tckpt.restore_checkpoint(str(tmp_path), 7, meta, specs, device="cpu")
    _same_bits(restored["a"], x)
    assert float(restored["b"]) == 3.5 and restored["b"].shape == ()
    _same_bits(restored["c"]["w"], tree["c"]["w"])
    assert restored["step"].dtype == torch.int32 and int(restored["step"]) == 4
    assert tckpt.latest_step(str(tmp_path)) == 7
    assert tckpt.latest_step(str(tmp_path / "none")) is None


def _cross_trees():
    """The same nested tree (bf16, f32, a 0-d int32 step) for both packages."""
    rng = np.random.default_rng(11)
    w = jnp.asarray(rng.standard_normal((3, 5), dtype=np.float32), jnp.bfloat16)
    scale = jnp.asarray(rng.standard_normal(5, dtype=np.float32))
    jtree = {"params": {"w": w, "norm": {"scale": scale}}, "opt": {"m": {"w": jnp.zeros((3, 5), jnp.float32)}},
             "step": jnp.asarray(0, jnp.int32)}  # fmt: skip
    w_bits = np.asarray(w).view(np.uint16).view(np.int16)
    ttree = {"params": {"w": torch.from_numpy(w_bits.copy()).view(torch.bfloat16),
                        "norm": {"scale": torch.from_numpy(np.asarray(scale).copy())}},
             "opt": {"m": {"w": torch.zeros(3, 5)}}, "step": torch.tensor(0, dtype=torch.int32)}  # fmt: skip
    return jtree, ttree


def test_checkpoint_crosses_packages_bit_for_bit(tmp_path):
    """JAX ``save_checkpoint`` -> the port's ``restore_checkpoint``, and the
    port's save -> JAX ``restore_checkpoint``: every leaf bit for bit; both
    ``index.json`` files equal, and ``host_0.npz`` the same arrays."""
    jtree, ttree = _cross_trees()
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jckpt.save_checkpoint(str(jdir), 3, jtree)
    tckpt.save_checkpoint(str(tdir), 3, ttree)

    from_jax = tckpt.restore_checkpoint(str(jdir), 3, ttree, device="cpu")
    assert len(topt.tree_leaves(from_jax)) == len(jax.tree.leaves(jtree)) == 4
    for got, want in zip(topt.tree_leaves(from_jax), jax.tree.leaves(jtree)):
        _same_bits(got, want)
    assert from_jax["params"]["w"].dtype == torch.bfloat16
    from_torch = jckpt.restore_checkpoint(str(tdir), 3, jtree)
    assert jax.tree.structure(from_torch) == jax.tree.structure(jtree)
    for got, want in zip(jax.tree.leaves(from_torch), jax.tree.leaves(jtree)):
        assert got.dtype == want.dtype
        _same_bits(got, want)

    j_index = (jdir / "step_000000003" / "index.json").read_text()
    assert (tdir / "step_000000003" / "index.json").read_text() == j_index
    assert json.loads(j_index)["arrays"]["params/w"]["dtype"] == "bfloat16"
    with np.load(jdir / "step_000000003" / "host_0.npz") as a, np.load(tdir / "step_000000003" / "host_0.npz") as b:
        assert list(a.keys()) == list(b.keys())
        for key in a.keys():
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


def test_async_snapshot_is_a_copy(tmp_path):
    """The tree is changed in place right after ``save`` returns (as the next
    step's AdamW changes the optimizer state) and before the write ends: the
    checkpoint holds the values of the moment of ``save``."""
    rng = np.random.default_rng(2)
    tree = {"opt": {k: torch.from_numpy(rng.standard_normal((256, 1024), dtype=np.float32)) for k in "abcdefgh"},
            "params": {"w": torch.ones(64, 64, dtype=torch.bfloat16)}, "step": torch.tensor(5, dtype=torch.int32)}  # fmt: skip
    before = topt.tree_map(lambda t: t.clone(), tree)
    mgr = tckpt.CheckpointManager(str(tmp_path))
    mgr.save(5, tree)
    for t in topt.tree_leaves(tree):
        t.add_(1)
    mgr.wait()
    restored = tckpt.restore_checkpoint(str(tmp_path), 5, tree, device="cpu")
    for got, want in zip(topt.tree_leaves(restored), topt.tree_leaves(before)):
        _same_bits(got, want)
    assert mgr.snapshot_s is not None and mgr.write_s is not None


def test_manager_keeps_the_last_k_and_raises_what_the_write_raised(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path), keep=2)
    for step in range(1, 5):
        mgr.save(step, {"x": torch.full((3,), float(step))})
    mgr.wait()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_000000003", "step_000000004"]
    (tmp_path / "blocked").write_text("a file where the directory would go")
    bad = tckpt.CheckpointManager(str(tmp_path / "blocked"))
    bad.save(1, {"x": torch.zeros(2)})
    with pytest.raises(OSError):
        bad.wait()
    bad.wait()  # raised once


# ---------------------------------------------------------------------------
# The mesh and the elastic plan
# ---------------------------------------------------------------------------


def test_meshes_are_the_reference_shapes():
    assert tmesh.make_host_mesh(data=1, model=1, device="cpu") == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="need 4 devices, have 1"):
        tmesh.make_host_mesh(data=2, model=2, device="cpu")
    assert tmesh.make_production_mesh() == {"data": 16, "model": 16}
    assert tmesh.make_production_mesh(multi_pod=True) == {"pod": 2, "data": 16, "model": 16}
    assert tmesh.mesh_num_chips(tmesh.make_production_mesh(multi_pod=True)) == 512
    if jax.device_count() >= 4:
        jm = jmesh.make_host_mesh(data=2, model=2)
        assert dict(jm.shape) == {"data": 2, "model": 2} and jmesh.mesh_num_chips(jm) == 4
        assert tmesh.mesh_num_chips({"data": 2, "model": 2}) == 4


@pytest.mark.parametrize("model_parallel", [4, 8, 16])
def test_shrink_mesh_properties(model_parallel):
    """Twin of ``tests/test_train.py::test_shrink_mesh_properties`` over every
    failure count it draws from, each against the JAX function."""
    for failed in range(0, 201):
        h = telastic.HealthState(total_devices=512, failed_devices=list(range(failed)))
        jh = jelastic.HealthState(total_devices=512, failed_devices=list(range(failed)))
        if h.healthy < model_parallel:
            continue
        shape, axes = telastic.shrink_mesh(h, model_parallel=model_parallel)
        assert (shape, axes) == jelastic.shrink_mesh(jh, model_parallel=model_parallel)
        assert int(np.prod(shape)) <= h.healthy  # never uses dead devices
        assert shape[-1] == model_parallel  # model parallelism preserved
        assert len(shape) == len(axes)


@pytest.mark.parametrize("new_replicas", [1, 2, 4, 8, 16, 32])
def test_rescale_batch_preserves_global_batch(new_replicas):
    """Twin of ``tests/test_train.py::test_rescale_batch_preserves_global_batch``."""
    per, accum = telastic.rescale_batch(256, old_replicas=32, new_replicas=new_replicas, grad_accum=1)
    assert (per, accum) == jelastic.rescale_batch(256, old_replicas=32, new_replicas=new_replicas, grad_accum=1)
    assert per * new_replicas == 256
    assert accum >= 1


def test_plan_recovery_smoke():
    """Twin of ``tests/test_train.py::test_plan_recovery_smoke``."""
    for failed, old in [(48, (2, 16, 16)), (0, (16, 16)), (300, (2, 16, 16))]:
        h = telastic.HealthState(total_devices=512, failed_devices=list(range(failed)))
        plan = telastic.plan_recovery(h, global_batch=256, old_mesh_shape=old)
        jplan = jelastic.plan_recovery(jelastic.HealthState(512, list(range(failed))), 256, old)
        assert plan == jplan
        assert plan["mesh_shape"][-1] == 16
        assert plan["per_replica_batch"] >= 1


# ---------------------------------------------------------------------------
# The loop
# ---------------------------------------------------------------------------


def test_checkpoint_resume_is_exact(tmp_path):
    """Twin of ``tests/test_train.py::test_checkpoint_resume_is_exact``:
    train 6 steps; against train 3 + resume 3, at the reference's tolerance.
    (On the CPU the resumed losses are bit-equal to the uninterrupted ones.)"""
    cfg = get_smoke_config("codeqwen1.5-7b")
    data = tdata.SyntheticLM(vocab_size=cfg.vocab_size, seq_len=16, seed=4)
    tcfg = tstep.TrainConfig(remat_policy="none")

    def run(steps, ckpt_every, ckpt_dir=None):
        trainer = tloop.TrainerConfig(steps=steps, ckpt_every=ckpt_every, ckpt_dir=ckpt_dir, log_every=1000, seed=7)
        return tloop.train(cfg, tcfg, trainer, MESH, lambda i: data.batch(i, batch_size=4), device="cpu")[2]

    hist_full = run(6, 1000)
    ckpt_dir = str(tmp_path / "ck")
    run(3, 3, ckpt_dir)
    assert tckpt.latest_step(ckpt_dir) == 3
    hist_resumed = run(6, 100, ckpt_dir)
    assert len(hist_resumed) == 3
    np.testing.assert_allclose(
        [h["loss"] for h in hist_resumed], [h["loss"] for h in hist_full[3:]], rtol=1e-5, atol=1e-6
    )


def test_resume_keeps_no_reference_to_the_restored_params(tmp_path, monkeypatch):
    """After the first resumed step the restored params are gone: the state is
    held on the device once (the step returns new params; AdamW updates the
    restored optimizer state in place)."""
    cfg = get_smoke_config("mamba2-1.3b")
    data = tdata.SyntheticLM(vocab_size=cfg.vocab_size, seq_len=8, seed=1)
    tcfg = tstep.TrainConfig(remat_policy="none")
    ckpt_dir = str(tmp_path / "ck")

    def run(steps, on_metrics=None):
        trainer = tloop.TrainerConfig(steps=steps, ckpt_every=1, ckpt_dir=ckpt_dir, log_every=1000)
        tloop.train(cfg, tcfg, trainer, MESH, lambda i: data.batch(i, batch_size=2), on_metrics, device="cpu")

    run(1)
    refs = []

    def restore(*args, **kwargs):
        out = tckpt.restore_checkpoint(*args, **kwargs)
        refs.extend(weakref.ref(t) for t in topt.tree_leaves(out["params"]))
        return out

    alive = []
    monkeypatch.setattr(tloop, "restore_checkpoint", restore)
    run(3, lambda i, metrics: alive.append(sum(r() is not None for r in refs)))
    assert len(refs) > 10 and alive == [0, 0]


def test_train_matches_jax_train_from_one_jax_checkpoint(tmp_path):
    """The slice as a whole: a float32 step-0 checkpoint of stablelm smoke,
    written by JAX ``save_checkpoint``; JAX ``train`` and the port's resume
    from it for 5 steps of the same ``SyntheticLM`` batches.  Step 0's loss
    and gradient norm 1e-5; the path 1e-4 (``test_train_step_loss_path_matches_jax``'s
    tolerances: Adam turns float32 noise in a near-zero gradient into a
    step of about lr)."""
    arch = "stablelm-3b"
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    jparams = jlm.init_lm(jax.random.PRNGKey(0), jcfg, jnp.float32)
    ckpt_dir = str(tmp_path / "ck")
    jckpt.save_checkpoint(ckpt_dir, 0, {"params": jparams, "opt": jopt.init_opt_state(jparams),
                                        "step": jnp.asarray(0, jnp.int32)})  # fmt: skip
    trainer = dict(steps=5, ckpt_every=1000, ckpt_dir=ckpt_dir, log_every=1000)

    jdata_src = jdata.SyntheticLM(vocab_size=jcfg.vocab_size, seq_len=16, seed=0)
    jt = jstep.TrainConfig(remat_policy="none", param_dtype="float32", opt=jopt.OptConfig(**FAST_OPT))
    _, _, jhist = jloop.train(jcfg, jt, jloop.TrainerConfig(**trainer), jmesh.make_host_mesh(data=1, model=1),
                              lambda i: jdata_src.batch(i, batch_size=4))  # fmt: skip

    tdata_src = tdata.SyntheticLM(vocab_size=tcfg.vocab_size, seq_len=16, seed=0)
    tt = tstep.TrainConfig(remat_policy="none", param_dtype="float32", opt=topt.OptConfig(**FAST_OPT))
    tparams, _, thist = tloop.train(tcfg, tt, tloop.TrainerConfig(**trainer), MESH,
                                    lambda i: tdata_src.batch(i, batch_size=4), device="cpu")  # fmt: skip
    assert len(thist) == len(jhist) == 5
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(thist[0][key], jhist[0][key], rtol=1e-5)
        np.testing.assert_allclose([h[key] for h in thist], [h[key] for h in jhist], rtol=1e-4)
    assert thist[-1]["loss"] < thist[0]["loss"]
    assert all(t.dtype == torch.float32 for t in topt.tree_leaves(tparams))


def test_launcher_trains_saves_and_resumes_on_the_cpu(tmp_path):
    """``python -m repro_torch.launch.train --smoke --device cpu`` with a
    checkpoint directory, then again with more steps: the second run resumes."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    ckpt_dir = tmp_path / "ck"
    args = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "mamba2-1.3b", "--smoke", "--device", "cpu",
            "--batch", "2", "--seq", "16", "--ckpt-dir", str(ckpt_dir), "--ckpt-every", "2"]  # fmt: skip
    first = subprocess.run(args + ["--steps", "2"], env=env, capture_output=True, text=True, timeout=120)
    assert first.returncode == 0, first.stderr[-2000:]
    assert "[train] step     0 loss" in first.stdout and "resuming" not in first.stdout
    assert tckpt.latest_step(str(ckpt_dir)) == 2
    second = subprocess.run(args + ["--steps", "4"], env=env, capture_output=True, text=True, timeout=120)
    assert second.returncode == 0, second.stderr[-2000:]
    assert "[train] resuming from step 2" in second.stdout
    assert sorted(p.name for p in ckpt_dir.iterdir()) == ["step_000000002", "step_000000004"]
