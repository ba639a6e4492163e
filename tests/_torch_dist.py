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

import dataclasses
import multiprocessing
import os
import pickle
import time
import traceback
from pathlib import Path
from typing import Optional

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
    checkpoint ``jax_sharded_<arch>``.  Then a train step built on the mesh
    (``check_data_parallel`` passes ``model = 2``) and a serve call there,
    whose decode graph is expected to refuse the ``gloo`` group."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.launch.serve import make_inputs, place_model, serve
    from repro_torch.parallel.sharding import (Shards, gather, param_shardings, shard_local, tree_map_with_path,
                                               tree_size_bytes)
    from repro_torch.serve.decode import CausalLM, cache_shards, capture_serve_step, init_cache
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

    # the last arch's config and params
    out["train_built"] = callable(make_train_step(cfg, TrainConfig(), mesh)[0])
    model = place_model(CausalLM(cfg, params), mesh)
    try:
        capture_serve_step(cfg, model.params, init_cache(cfg, 4, 12, "cpu", mesh), 2, model.shardings,
                           cache_shards(cfg, Shards.of(model.shardings), 2, 12))  # fmt: skip
    except ValueError as err:
        out["serve_refusal"] = str(err)
    out["served"] = serve(model, make_inputs(cfg, 4, 8, torch.Generator().manual_seed(1)), 2, log=lambda *a: None,
                          mesh=mesh)["tokens"].numpy()  # fmt: skip
    return out


def float32_smoke(arch: str):
    import dataclasses

    from repro_torch.configs.registry import get_smoke_config

    return dataclasses.replace(get_smoke_config(arch), dtype="float32")


def train_config(policy: str, lr: float, warmup: int, remat: str = "none"):
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.step import TrainConfig

    return TrainConfig(sync_strategy=policy, remat_policy=remat, param_dtype="float32",
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


def model_axis(rank: int, world: int, workdir: Path, archs: tuple, batch: int, prompt: int, gen: int,
               odd_vocab: int) -> dict:
    """On ``{"data": 2, "model": 2}``: each arch's float32 smoke params
    restored at their ``param_shardings`` placements from the checkpoint
    ``params_<arch>`` and served (``tokens_<arch>.npy`` the prompts): the
    prefill logits of this rank's rows, the gathered tokens, the last step's
    logits, and the shapes of this rank's parameter and cache blocks.  Then
    whether ``check_data_parallel`` passes a train step at ``model = 2`` and
    ``make_train_step`` builds it, the refusals of a decode step of the last
    arch's placed model without its cache's placement, and
    phi4's smoke config at a vocabulary of ``odd_vocab`` rows (no split over
    ``model``) served from the port's own seed-0 params."""
    import dataclasses

    from repro_torch.launch.mesh import device_mesh
    from repro_torch.launch.serve import make_inputs, serve
    from repro_torch.models.lm import init_lm
    from repro_torch.parallel.sharding import check_data_parallel, param_shardings, param_specs
    from repro_torch.serve.decode import CausalLM, EagerServeStep, init_cache
    from repro_torch.train.checkpoint import restore_checkpoint
    from repro_torch.train.step import TrainConfig, abstract_params, make_train_step

    mesh = device_mesh({"data": 2, "model": 2}, "cpu")
    out = {"coords": tuple(mesh.get_coordinate())}
    quiet = dict(log=lambda *a: None, mesh=mesh)
    for arch in archs:
        cfg = float32_smoke(arch)
        shardings = param_shardings(abstract_params(cfg, torch.float32), mesh, cfg)
        params = restore_checkpoint(str(workdir / f"params_{arch}"), 0, {"params": abstract_params(cfg, torch.float32)},
                                    {"params": shardings}, device="cpu")["params"]  # fmt: skip
        tokens = torch.from_numpy(np.load(workdir / f"tokens_{arch}.npy"))
        got = serve(CausalLM(cfg, params, shardings), {"tokens": tokens}, gen, **quiet)
        out[arch] = {"prefill_logits": got["prefill_logits"].numpy(), "tokens": got["tokens"].numpy(),
                     "last_logits": got["last_logits"].numpy(),
                     "params": {path: tuple(t.shape) for path, t in leaves_with_path(params)},
                     "cache": {path: tuple(t.shape)
                               for path, t in leaves_with_path(init_cache(cfg, batch, prompt + gen, "cpu", mesh))}}
    check_data_parallel(mesh, "train")
    step_fn, (in_sh, _), _, _ = make_train_step(cfg, TrainConfig(), mesh)
    out["train_built"] = callable(step_fn) and in_sh[0]["embed"]["table"].spec == param_specs(
        abstract_params(cfg, torch.float32), {"data": 2, "model": 2}, fsdp=False, cfg=cfg)["embed"]["table"]
    model, cache = CausalLM(cfg, params, shardings), init_cache(cfg, batch, prompt + gen, "cpu", mesh)
    out["step_refusals"] = []
    for step in (lambda: model.decode_step(cache, tokens[: batch // 2, :1], torch.zeros(batch // 2, dtype=torch.int32)),
                 lambda: EagerServeStep(cfg, params, cache, batch // 2, shardings)):  # fmt: skip
        try:
            step()
        except ValueError as err:
            out["step_refusals"].append(str(err))
    cfg = dataclasses.replace(float32_smoke("phi4-mini-3.8b"), vocab_size=odd_vocab)
    model = CausalLM(cfg, init_lm(torch.Generator().manual_seed(0), cfg, torch.float32))
    got = serve(model, make_inputs(cfg, batch, prompt, torch.Generator().manual_seed(1)), gen, **quiet)
    out["odd_vocab"] = {"tokens": got["tokens"].numpy(), "prefill_logits": got["prefill_logits"].numpy(),
                        "table": tuple(param_shardings(model.params, mesh, cfg)["embed"]["table"].spec)}
    return out


def moe_data(rank: int, world: int, workdir: Path, arch: str, batch: int, prompt: int, gen: int, seq: int,
             steps: int, lr: float) -> dict:
    """On ``{"data": world, "model": 1}``: ``arch``'s float32 smoke model (seed 0) at its
    own capacity factor served on 4 prompts (seed 1), this rank's rows of
    the prefill and last logits and the gathered tokens; then ``steps``
    train steps (scu) on this rank's rows of one global batch (seed 2),
    their losses and gradient norms."""
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.launch.serve import make_inputs, serve
    from repro_torch.models.lm import init_lm
    from repro_torch.serve.decode import CausalLM
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.step import make_train_step

    mesh = device_mesh({"data": world, "model": 1}, "cpu")
    cfg = float32_smoke(arch)
    got = serve(CausalLM(cfg, init_lm(torch.Generator().manual_seed(0), cfg, torch.float32)),
                make_inputs(cfg, batch, prompt, torch.Generator().manual_seed(1)), gen, log=lambda *a: None,
                mesh=mesh)  # fmt: skip
    out = {"tokens": got["tokens"].numpy(), "prefill_logits": got["prefill_logits"].numpy(),
           "last_logits": got["last_logits"].numpy()}
    params = init_lm(torch.Generator().manual_seed(0), cfg, torch.float32)
    step_fn, (in_sh, _), _, _ = make_train_step(cfg, train_config("scu", lr, 1), mesh)
    opt_state = init_opt_state(params, in_sh)
    rows = slice(rank * batch // world, (rank + 1) * batch // world)
    whole = torch.randint(0, cfg.vocab_size, (batch, seq + 1), generator=torch.Generator().manual_seed(2))
    data = {"tokens": whole[rows, :-1], "labels": whole[rows, 1:]}
    step = torch.zeros((), dtype=torch.int32)
    out["loss"], out["grad_norm"] = [], []
    for _ in range(steps):
        params, opt_state, step, metrics = step_fn(params, opt_state, step, data)
        out["loss"].append(metrics["loss"].item())
        out["grad_norm"].append(metrics["grad_norm"].item())
    return out


def model_train(rank: int, world: int, workdir: Path, runs: tuple, steps: int, batch: int, seq: int, lr: float,
                warmup: int, resume_at: int, resume_arch: Optional[str] = None, launch: tuple = ()) -> dict:
    """On ``{"data": 2, "model": 2}``, for each ``(arch, policy, remat)`` of
    ``runs``, from the float32 step-0 checkpoint ``step0_<arch>`` (copied into
    ``run_<arch>_<policy>``): the step-0 gradient of every leaf (this rank's
    block, the mean over the data processes: the ``tas`` hook's), then
    ``train`` for ``steps`` steps of ``SyntheticLM(seed 0)``'s global batches,
    its losses, grad norms, final parameter blocks and optimizer-state block
    shapes.  With ``resume_arch``, its ``scu`` run again, saved at
    ``resume_at`` into ``resume`` (its blocks there kept) and resumed in the
    group, and int8 compression of a block split over ``model``; with
    ``launch``, the training launcher's mesh and ``main`` on those arguments
    in the group, its checkpoints in ``launched``."""
    import shutil

    import torch.distributed as dist

    from repro_torch.launch.mesh import device_mesh
    from repro_torch.models.lm import lm_loss
    from repro_torch.parallel.sharding import NamedSharding, Shards, Spec, shard_local
    from repro_torch.sync import get_policy
    from repro_torch.train.checkpoint import restore_checkpoint
    from repro_torch.train.data import SyntheticLM, make_batch_fn
    from repro_torch.train.loop import TrainerConfig, _device_batch, train
    from repro_torch.train.optimizer import compress_decompress
    from repro_torch.train.step import abstract_params, make_train_step, value_and_grad

    mesh = device_mesh({"data": 2, "model": 2}, "cpu")
    out = {"coords": tuple(mesh.get_coordinate())}

    def fresh(src, name):
        if rank == 0:
            shutil.copytree(workdir / src, workdir / name)
        dist.barrier()
        return workdir / name

    for arch, policy, remat in runs:
        cfg = float32_smoke(arch)
        tcfg = train_config(policy, lr, warmup, remat)
        batch_fn = make_batch_fn(SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq, seed=0), batch)

        def run(ckpt_dir, until, ckpt_every=1000):
            trainer = TrainerConfig(steps=until, ckpt_every=ckpt_every, ckpt_dir=str(ckpt_dir), log_every=1000)
            return train(cfg, tcfg, trainer, mesh, batch_fn, device="cpu")

        _, (in_sh, batch_sh), _, params_sds = make_train_step(cfg, tcfg, mesh)
        params = restore_checkpoint(str(workdir / f"step0_{arch}"), 0, {"params": params_sds}, {"params": in_sh[0]},
                                    device="cpu")["params"]  # fmt: skip
        shards = Shards.of(in_sh[0])
        loss, grads = value_and_grad(lambda p, b: lm_loss(p, cfg, b, remat_policy=remat, shards=shards), params,
                                     _device_batch(batch_fn(0), torch.device("cpu"), batch_sh))  # fmt: skip
        grads = get_policy("tas").shape_gradients(grads, params_sds, mesh, cfg=cfg)
        params, opt_state, history = run(fresh(f"step0_{arch}", f"run_{arch}_{policy}"), steps)
        out[(arch, policy)] = {
            "grads": {path: g.numpy() for path, g in leaves_with_path(grads)},
            "loss": [h["loss"] for h in history], "grad_norm": [h["grad_norm"] for h in history],
            "params": {path: t.numpy() for path, t in leaves_with_path(params)},
            "opt_shapes": {key: {path: tuple(t.shape) for path, t in leaves_with_path(tree)}
                           for key, tree in opt_state.items()},
        }  # fmt: skip

    if resume_arch is None:
        return out
    cfg = float32_smoke(resume_arch)
    tcfg = train_config("scu", lr, warmup)
    batch_fn = make_batch_fn(SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq, seed=0), batch)
    resume_dir = fresh(f"step0_{resume_arch}", "resume")
    trainer = TrainerConfig(steps=resume_at, ckpt_every=resume_at, ckpt_dir=str(resume_dir), log_every=1000)
    params, opt_state, _ = train(cfg, tcfg, trainer, mesh, batch_fn, device="cpu")
    out["saved"] = {key: {path: bits(t) for path, t in leaves_with_path(tree)}
                    for key, tree in (("params", params), *opt_state.items())}  # fmt: skip
    trainer = dataclasses.replace(trainer, steps=steps)
    out["resumed"] = [h["loss"] for h in train(cfg, tcfg, trainer, mesh, batch_fn, device="cpu")[2]]

    # int8 compression of a block split over model (and data): the scale is the whole tensor's max
    whole = torch.randn(8, 6, generator=torch.Generator().manual_seed(5))
    for name, spec in (("model", Spec(None, "model")), ("both", Spec("data", "model"))):
        placed = NamedSharding(mesh, spec)
        out[("int8_block", name)] = compress_decompress(shard_local(whole, placed), None, placed)[0].numpy()
        out[("int8_whole", name)] = shard_local(compress_decompress(whole, None)[0], placed).numpy()

    if launch:
        from repro_torch.launch.train import build_run, main
        from repro_torch.parallel.sharding import axis_sizes

        argv = [*launch, "--ckpt-dir", str(workdir / "launched")]
        out["launched_mesh"] = axis_sizes(build_run(argv)[3])
        out["launched_loss"] = [h["loss"] for h in main(argv)[2]]
    return out


JOBS = {"collectives": collectives, "placements": placements, "data_parallel": data_parallel, "serving": serving,
        "model_axis": model_axis, "moe_data": moe_data, "model_train": model_train}
