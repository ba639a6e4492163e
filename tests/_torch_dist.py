"""Process groups for the tests of the port's distributed path.

``start_group(job, world, workdir, **kwargs)`` spawns ``world`` processes
(the ``spawn`` start method), each joining one ``gloo`` group through a
``file://`` rendezvous under ``workdir`` and running ``JOBS[job](rank, world,
workdir, **kwargs)``; ``.results()`` joins them with a timeout, ends any
that outlived it, asserts every exit code, and returns each rank's result
(a dict of numpy arrays and Python values, pickled to ``workdir`` by the
worker itself, never sent over a pipe).

A spawned process imports this module again, so it imports ``torch`` and
``repro_torch`` and never ``jax`` or ``repro``: the test modules that call it
hold the port against JAX in the test process.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import time
import traceback
from pathlib import Path

import numpy as np
import torch

JOIN_TIMEOUT_S = 150.0
GROUP_TIMEOUT_S = 90.0


def bits(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array of its bits (bf16 as uint16)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).copy()
    return t.numpy().copy()


def leaves_with_path(tree, path=()):
    """``(path of keys, leaf)`` of a nested dict, keys sorted at every level."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in leaves_with_path(tree[k], path + (k,))]
    return [(path, tree)]


class Group:
    """A running group of worker processes; see the module note."""

    def __init__(self, job: str, world: int, workdir: Path, kwargs: dict):
        self.job, self.world, self.workdir = job, world, Path(workdir)
        self.workdir.mkdir(parents=True, exist_ok=True)
        ctx = multiprocessing.get_context("spawn")
        rendezvous = self.workdir / f"rendezvous_{job}_{world}"
        self.procs = [ctx.Process(target=_entry, args=(job, rank, world, str(rendezvous), str(self.workdir), kwargs),
                                  daemon=True)
                      for rank in range(world)]  # fmt: skip
        for proc in self.procs:
            proc.start()
        self.started = time.monotonic()

    def _file(self, rank: int, suffix: str) -> Path:
        return self.workdir / f"{self.job}_{self.world}_rank{rank}.{suffix}"

    def results(self, timeout: float = JOIN_TIMEOUT_S) -> list:
        deadline = self.started + timeout
        for proc in self.procs:
            proc.join(max(0.0, deadline - time.monotonic()))
        hung = [rank for rank, proc in enumerate(self.procs) if proc.is_alive()]
        for proc in self.procs:
            if proc.is_alive():
                proc.terminate()
                proc.join(10)
                if proc.is_alive():
                    proc.kill()
                    proc.join(10)
        errors = {rank: self._file(rank, "err").read_text() for rank in range(self.world)
                  if self._file(rank, "err").exists()}  # fmt: skip
        codes = [proc.exitcode for proc in self.procs]
        assert not hung and all(code == 0 for code in codes), (
            f"{self.job} over {self.world} ranks: exit codes {codes}, still running after {timeout} s: {hung}; "
            f"errors: {errors}")
        out = []
        for rank in range(self.world):
            with open(self._file(rank, "pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def start_group(job: str, world: int, workdir: Path, **kwargs) -> Group:
    return Group(job, world, workdir, kwargs)


def _entry(job: str, rank: int, world: int, rendezvous: str, workdir: str, kwargs: dict) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist

    from repro_torch.parallel.dist import init_distributed

    stem = Path(workdir) / f"{job}_{world}_rank{rank}"
    try:
        init_distributed("cpu", rank=rank, world=world, init_method=f"file://{rendezvous}",
                         timeout=GROUP_TIMEOUT_S)  # fmt: skip
        result = JOBS[job](rank, world, Path(workdir), **kwargs)
        dist.barrier()
        tmp = stem.with_suffix(".tmp")
        with open(tmp, "wb") as f:
            pickle.dump(result, f)
        os.replace(tmp, stem.with_suffix(".pkl"))
    except BaseException:
        stem.with_suffix(".err").write_text(traceback.format_exc())
        os._exit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Jobs
# ---------------------------------------------------------------------------

BARRIERS = ("scu", "tas", "sw", "tree", "tree4", "tree_ew", "fifo")


def perms(n: int) -> dict:
    """The permutations the collectives are held on: rings both ways, a
    butterfly, one with a party that nobody sends to and that sends to
    nobody, one of only self-pairs, one mixing both."""
    out = {"ring": [(i, (i + 1) % n) for i in range(n)], "back": [(i, (i - 1) % n) for i in range(n)],
           "xor1": [(i, i ^ 1) for i in range(n)], "partial": [(i, i + 1) for i in range(n - 1)],
           "self": [(i, i) for i in range(n)], "mixed": [(0, 0)] + [(i, (i % (n - 1)) + 1) for i in range(1, n)]}
    return out


def collectives(rank: int, world: int, workdir: Path, words: dict) -> dict:
    """Over a one-axis mesh ``{"x": world}``: ``psum``, every ``perms``
    ``ppermute``, ``axis_index``, ``axis_size`` and the seven chip barriers
    on this rank's row of each word array; over ``{"data": 2, "model": 2}``
    (four ranks) the same collectives on each axis."""
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.sync import get_policy
    from repro_torch.sync.axis import MeshAxis, axis_index, axis_size, ppermute, psum

    out = {}
    axes = {"x": MeshAxis(device_mesh({"x": world}, "cpu"), "x")}
    if world == 4:
        grid = device_mesh({"data": 2, "model": 2}, "cpu")
        axes.update(data=MeshAxis(grid, "data"), model=MeshAxis(grid, "model"))
    for name, axis in axes.items():
        n = axis.size
        for key, arr in words.items():
            x = torch.from_numpy(np.array(arr[rank]))
            out[(name, key, "psum")] = psum(x, axis).numpy()
            out[(name, key, "index")] = int(axis_index(x, axis))
            out[(name, key, "size")] = axis_size(x, axis)
            for pname, perm in perms(n).items():
                out[(name, key, "ppermute", pname)] = ppermute(x, axis, perm).numpy()
            if name == "x":
                for policy in BARRIERS:
                    out[(name, key, policy)] = get_policy(policy).chip_barrier(x, axis).numpy()
    return out


def placements(rank: int, world: int, workdir: Path, archs: tuple) -> dict:
    """On ``{"data": 2, "model": 2}``, for each arch's smoke params (read from
    a JAX checkpoint ``jax_params_<arch>``, unsharded): this rank's block of
    every leaf by ``param_shardings`` and its index, whether ``gather`` gives
    the whole leaf back, ``tree_size_bytes`` from the blocks and from the
    whole tree; a checkpoint of the blocks saved by the group into
    ``group_<arch>``; the blocks restored from the JAX run's sharded
    checkpoint ``jax_sharded_<arch>``.  Then a train step and a serve call on
    the mesh, each expected to refuse ``model = 2``."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.launch.serve import make_inputs, serve
    from repro_torch.parallel.sharding import gather, param_shardings, shard_local, tree_map_with_path, tree_size_bytes
    from repro_torch.serve.decode import CausalLM
    from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.train.step import TrainConfig, abstract_params, make_train_step

    mesh = device_mesh({"data": 2, "model": 2}, "cpu")
    out = {"coords": tuple(mesh.get_coordinate())}
    for arch in archs:
        cfg = get_smoke_config(arch)
        target = {"params": abstract_params(cfg, torch.bfloat16)}
        params = restore_checkpoint(str(workdir / f"jax_params_{arch}"), 0, target, device="cpu")["params"]
        shardings = param_shardings(params, mesh, cfg)
        local = tree_map_with_path(lambda path, p, s: shard_local(p, s), params, shardings)
        got = {"local": {}, "index": {}, "gathered": {}}
        for (path, block), (_, sh), (_, whole) in zip(leaves_with_path(local), leaves_with_path(shardings),
                                                      leaves_with_path(params)):  # fmt: skip
            got["local"][path] = bits(block)
            got["index"][path] = [(sl.start, sl.stop) for sl in sh.index(tuple(whole.shape))]
            got["gathered"][path] = torch.equal(gather(block, sh), whole)
        got["bytes_from_blocks"] = tree_size_bytes(local, shardings)
        got["bytes_whole"] = tree_size_bytes(params)
        save_checkpoint(str(workdir / f"group_{arch}"), 0, {"params": local}, {"params": shardings})
        restored = restore_checkpoint(str(workdir / f"jax_sharded_{arch}"), 0, target, {"params": shardings},
                                      device="cpu")["params"]  # fmt: skip
        got["restored"] = {path: bits(t) for path, t in leaves_with_path(restored)}
        out[arch] = got

    try:  # the last arch's config and params
        make_train_step(cfg, TrainConfig(), mesh)
    except NotImplementedError as err:
        out["train_refusal"] = str(err)
    model = CausalLM(cfg, params)
    try:
        serve(model, make_inputs(cfg, 4, 8, torch.Generator().manual_seed(1)), 2, log=lambda *a: None, mesh=mesh)
    except NotImplementedError as err:
        out["serve_refusal"] = str(err)
    return out


def float32_smoke(arch: str):
    import dataclasses

    from repro_torch.configs.registry import get_smoke_config

    return dataclasses.replace(get_smoke_config(arch), dtype="float32")


def train_config(policy: str, lr: float, warmup: int):
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.step import TrainConfig

    return TrainConfig(sync_strategy=policy, remat_policy="none", param_dtype="float32",
                       opt=OptConfig(lr=lr, warmup_steps=warmup))  # fmt: skip


def data_parallel(rank: int, world: int, workdir: Path, arch: str, policies: tuple, steps: int, batch: int,
                  seq: int, lr: float, warmup: int, resume_at: int) -> dict:
    """On ``{"data": world, "model": 1}``: ``train`` under each policy from the
    float32 step-0 checkpoint ``step0`` (copied into ``run_<policy>``) for
    ``steps`` steps of ``SyntheticLM(seed 0)``'s global batches, with each
    rank's optimizer-state block shapes; the ``scu`` run again, saved at
    ``resume_at`` into ``resume`` and resumed there."""
    import shutil

    import torch.distributed as dist

    from repro_torch.launch.mesh import device_mesh
    from repro_torch.train.data import SyntheticLM, make_batch_fn
    from repro_torch.train.loop import TrainerConfig, train

    mesh = device_mesh({"data": world, "model": 1}, "cpu")
    cfg = float32_smoke(arch)
    batch_fn = make_batch_fn(SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq, seed=0), batch)

    def run(policy, ckpt_dir, until, ckpt_every=1000):
        trainer = TrainerConfig(steps=until, ckpt_every=ckpt_every, ckpt_dir=str(ckpt_dir), log_every=1000)
        return train(cfg, train_config(policy, lr, warmup), trainer, mesh, batch_fn, device="cpu")

    def fresh(name):
        if rank == 0:
            shutil.copytree(workdir / "step0", workdir / name)
        dist.barrier()
        return workdir / name

    out = {}
    for policy in policies:
        _, opt_state, history = run(policy, fresh(f"run_{policy}"), steps)
        out[policy] = {"loss": [h["loss"] for h in history], "grad_norm": [h["grad_norm"] for h in history],
                       "opt_shapes": {key: {path: tuple(t.shape) for path, t in leaves_with_path(tree)}
                                      for key, tree in opt_state.items()}}  # fmt: skip
    resume_dir = fresh("resume")
    run("scu", resume_dir, resume_at, ckpt_every=resume_at)
    out["resumed"] = [h["loss"] for h in run("scu", resume_dir, steps)[2]]

    # int8 compression on a ZeRO block: the scale is the whole tensor's max
    from repro_torch.parallel.sharding import NamedSharding, Spec, shard_local
    from repro_torch.train.optimizer import compress_decompress

    whole = torch.randn(8, 6, generator=torch.Generator().manual_seed(5))
    placed = NamedSharding(mesh, Spec("data", None))
    out["int8_block"] = compress_decompress(shard_local(whole, placed), None, placed)[0].numpy()
    out["int8_whole"] = shard_local(compress_decompress(whole, None)[0], placed).numpy()
    return out


def serving(rank: int, world: int, workdir: Path, archs: tuple) -> dict:
    """On ``{"data": world, "model": 1}``: each arch served data-parallel
    (float32 smoke params from seed 0, 4 prompts of 8 from seed 1, 4 new
    tokens), its gathered tokens and this rank's cache block shapes."""
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.launch.serve import make_inputs, serve
    from repro_torch.models.lm import init_lm
    from repro_torch.serve.decode import CausalLM, init_cache

    mesh = device_mesh({"data": world, "model": 1}, "cpu")
    out = {}
    for arch in archs:
        cfg = float32_smoke(arch)
        model = CausalLM(cfg, init_lm(torch.Generator().manual_seed(0), cfg, torch.float32))
        inputs = make_inputs(cfg, 4, 8, torch.Generator().manual_seed(1))
        out[("tokens", arch)] = serve(model, inputs, 4, log=lambda *a: None, mesh=mesh)["tokens"].numpy()
        out[("cache", arch)] = {path: tuple(t.shape) for path, t in leaves_with_path(init_cache(cfg, 4, 12, "cpu", mesh))}
    return out


JOBS = {"collectives": collectives, "placements": placements, "data_parallel": data_parallel, "serving": serving}
