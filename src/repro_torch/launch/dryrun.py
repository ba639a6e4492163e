"""Dry run: every (arch x shape x mesh) cell of the port's step, traced on
fake tensors, counted per device.  The twin of ``repro/launch/dryrun.py``.

Run as:   PYTHONPATH=src python -m repro_torch.launch.dryrun --all
          PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-1.3b \\
              --shape train_4k --mesh multi

For every cell this builds the port's own step (``train.step.make_train_step``,
``serve.decode.make_prefill`` or the eager ``make_serve_step``) for the
production mesh (``launch.mesh.make_production_mesh``: 16 x 16, or 2 x 16 x
16) and runs it once on fake tensors (``FakeTensorMode``): fake parameters in
this process's blocks of them (``param_shardings``), fake optimizer state, a
fake batch of this process's rows of ``configs.base.input_specs``.  Nothing
is allocated and no kernel is launched: the kernels are custom ops whose
fake versions check the shapes and allocate what the launch would
(``kernels/*/kernel.py``).  ``launch.dispatch_analysis`` counts the FLOPs
(bf16 and float32 apart), the bytes, the transcendentals, the collectives
and the memory of the one process it plays, and the record goes to
``artifacts/dryrun_torch/<mesh>/<arch>__<shape>[__tag].json`` for the
roofline (``launch/roofline.py``).

The process is rank 0 of a ``torch.distributed`` group on the ``"fake"``
backend (``FakeStore`` of ``torch.testing._internal.distributed.fake_pg``,
PyTorch's testing API, as ``torch._C._cuda_getCurrentRawStream`` is private
API elsewhere in the port) of the mesh's size: its collectives are seen and
counted and move nothing.  The dry run refuses to start while a group is up,
so that it never borrows a real one, and destroys its own when the cell is
done.  A mesh of one place (``{"data": 1, "model": 1}``) takes no group, as
the one-card step does.

On a build of PyTorch with CUDA the fake tensors are CUDA tensors.  On one
without, a fake CUDA tensor cannot enter autograd (its metadata asks the
CUDA device guard, and the process aborts), so there the fake tensors lie on
the CPU and ``compat.card_stand_in()`` routes them to the kernels' fake ops
as if they were the card's: the same ops are dispatched either way.

Two known differences from the reference's records: the port's training
step holds the parameters whole over the data axes (the reference's FSDP
rule splits them; ROADMAP Queue 3), so a training cell's argument bytes are
larger; and eager loops unroll, so there are no while-loop trip counts.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.compat import card_stand_in
from repro_torch.configs.base import SHAPES, ShapeConfig, input_specs, shape_applicable, sync_policy_choices
from repro_torch.configs.registry import get_config, get_smoke_config, list_archs
from repro_torch.launch.mesh import make_production_mesh, mesh_num_chips

__all__ = ["apply_variant", "build_cell", "fake_device", "mesh_name", "run_cell", "main"]


def apply_variant(cfg, variant: str):
    """The reference's hill-climb variants: (cfg transform, train-config overrides)."""
    tkw = {}
    if not variant:
        return cfg, tkw
    for v in variant.split("+"):
        if v.startswith("ssdchunk"):
            cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, chunk=int(v[len("ssdchunk"):])))
        elif v == "moehints":
            cfg = dataclasses.replace(cfg, moe_shard_hints=True)
        elif v == "nosp":
            tkw["sequence_parallel"] = False
        elif v.startswith("accum"):
            tkw["grad_accum"] = int(v[len("accum"):])
        elif v:
            raise ValueError(f"unknown variant {v!r}")
    return cfg, tkw


def fake_device() -> torch.device:
    """The device of the fake tensors: CUDA where this PyTorch is built with
    it, else the CPU (module note)."""
    return torch.device("cuda", 0) if torch.backends.cuda.is_built() else torch.device("cpu")


def mesh_name(mesh: Union[str, Mapping[str, int]]) -> str:
    if isinstance(mesh, str):
        return mesh
    return "_".join(f"{axis}{size}" for axis, size in mesh.items())


# a mesh of one place: the one-card step, no process group
ONE = {"data": 1, "model": 1}


def _mesh_sizes(mesh: Union[str, Mapping[str, int]]) -> Dict[str, int]:
    if mesh == "one":
        return dict(ONE)
    if isinstance(mesh, str):
        return make_production_mesh(multi_pod=(mesh == "multi"))
    return dict(mesh)


@contextlib.contextmanager
def fake_group(world: int):
    """Rank 0 of a ``"fake"`` process group of ``world``; destroyed on the way out."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already up: the dry run makes its own fake one and never "
                           "borrows a real one")  # fmt: skip
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local_rows(global_batch: int, n_dp: int) -> int:
    """This process's rows: a batch that does not split over the data axes is
    served whole by every data process (the reference replicates it)."""
    return global_batch // n_dp if global_batch % n_dp == 0 else global_batch


def build_cell(arch: str, shape: ShapeConfig, mesh, device: torch.device, *, sync_strategy: str = "scu",
               remat_policy: str = "full", variant: str = "", compression: str = "none", smoke: bool = False,
               layers: Optional[int] = None) -> Tuple[Any, Tuple[Any, ...]]:
    """``(fn, args)`` of one cell: the step and its fake arguments.  Call
    inside a ``FakeTensorMode``.  ``mesh`` is an ``{axis: size}`` mapping of
    one place or a ``DeviceMesh`` over the fake group; ``smoke`` takes the
    arch's reduced config, ``layers`` cuts its depth."""
    from repro_torch.parallel.sharding import Shards, axis_sizes, dp_axes, param_shardings
    from repro_torch.serve.decode import _alloc, cache_shapes, cache_specs, make_prefill, make_serve_step

    cfg, tkw = apply_variant(_config(arch, smoke, layers), variant)
    specs = input_specs(cfg, shape)
    placed = not isinstance(mesh, Mapping)
    sizes = axis_sizes(mesh)
    n_dp = math.prod(sizes[a] for a in dp_axes(sizes)) if placed else 1
    rows = _local_rows(shape.global_batch, n_dp)

    def local(spec):
        return torch.empty((rows,) + tuple(spec.shape[1:]), dtype=spec.dtype, device=device)

    def blocks(params_sds, shardings):  # this process's blocks of the parameters, fake
        return _alloc(params_sds, device, torch.empty, None if shardings is None else Shards.of(shardings).specs, mesh)

    if shape.kind == "train":
        from repro_torch.train.optimizer import OptConfig, init_opt_state
        from repro_torch.train.step import TrainConfig, make_train_step

        # the activation-memory knob for the very large archs, as the reference's
        n = cfg.n_params()
        accum = 8 if n > 90e9 else (4 if n > 20e9 else 1)
        tcfg = TrainConfig(sync_strategy=sync_strategy, remat_policy=remat_policy,
                           grad_accum=tkw.get("grad_accum", accum),
                           sequence_parallel=tkw.get("sequence_parallel", True),
                           opt=OptConfig(compression=compression))  # fmt: skip
        step_fn, (in_sh, _), _, params_sds = make_train_step(cfg, tcfg, mesh)
        params = blocks(params_sds, in_sh[0] if placed else None)
        opt = init_opt_state(params, in_sh) if placed else init_opt_state(params)
        batch = {k: local(v) for k, v in specs.items()}
        return step_fn, (params, opt, torch.zeros((), dtype=torch.int32, device=device), batch)

    from repro_torch.train.step import abstract_params

    params_sds = abstract_params(cfg, torch.bfloat16)
    shardings = param_shardings(params_sds, mesh, cfg) if placed else None
    params = blocks(params_sds, shardings)
    if shape.kind == "prefill":
        fn = make_prefill(cfg, device, rows, shape.seq_len, shardings)
        return fn, (params, {k: local(v) for k, v in specs.items() if k != "labels"})

    fn = make_serve_step(cfg, device, rows, shape.seq_len, shardings)
    # the cache of the data processes' rows, this process's block of it
    cache = _alloc(cache_shapes(cfg, rows * n_dp, shape.seq_len), device, torch.empty,
                   cache_specs(cfg, mesh, rows * n_dp, shape.seq_len) if placed else None, mesh)  # fmt: skip
    return fn, (params, cache, local(specs["tokens"]), local(specs["position"]))


def _config(arch: str, smoke: bool, layers: Optional[int]):
    cfg = (get_smoke_config if smoke else get_config)(arch)
    return cfg if layers is None else dataclasses.replace(cfg, n_layers=layers)


def run_cell(arch: str, shape: Union[str, ShapeConfig], mesh: Union[str, Mapping[str, int]], out_dir: Path,
             sync_strategy: str = "scu", remat_policy: str = "full", tag: str = "", variant: str = "",
             compression: str = "none", smoke: bool = False, layers: Optional[int] = None) -> dict:
    """Trace one cell and write its record; returns the record.  ``shape`` is
    a name of ``SHAPES`` or a ``ShapeConfig``; ``mesh`` ``"single"``,
    ``"multi"``, ``"one"`` (``{"data": 1, "model": 1}``) or an ``{axis:
    size}`` mapping; ``smoke`` takes the arch's reduced config (its record's
    file name ends ``__smoke``), ``layers`` cuts its depth (``__L<n>``)."""
    from repro_torch.launch.dispatch_analysis import analyze
    from repro_torch.launch.mesh import device_mesh

    shape = SHAPES[shape] if isinstance(shape, str) else shape
    cfg = _config(arch, smoke, layers)
    ok, why = shape_applicable(cfg, shape)
    name = mesh_name(mesh)
    rec = {"arch": arch, "shape": shape.name, "mesh": name, "sync_strategy": sync_strategy,
           "remat_policy": remat_policy, "applicable": ok}  # fmt: skip
    suffix = ("__smoke" if smoke else "") + (f"__L{layers}" if layers else "") + (f"__{tag}" if tag else "")
    out_path = Path(out_dir) / name / f"{arch}__{shape.name}{suffix}.json"
    out_path.parent.mkdir(parents=True, exist_ok=True)
    if not ok:
        rec["skip_reason"] = why
        out_path.write_text(json.dumps(rec, indent=2))
        print(f"[skip] {arch} x {shape.name} ({name}): {why}")
        return rec

    from torch._subclasses.fake_tensor import FakeTensorMode

    sizes = _mesh_sizes(mesh)
    chips = mesh_num_chips(sizes)
    device = fake_device()
    t0 = time.time()
    try:
        with fake_group(chips) if chips > 1 else contextlib.nullcontext():
            step_mesh = device_mesh(sizes, device.type) if chips > 1 else sizes
            with FakeTensorMode(), card_stand_in() if device.type == "cpu" else contextlib.nullcontext():
                fn, args = build_cell(arch, shape, step_mesh, device, sync_strategy=sync_strategy,
                                      remat_policy=remat_policy, variant=variant, compression=compression,
                                      smoke=smoke, layers=layers)  # fmt: skip
                _, counted = analyze(fn, *args)
        rec.update(
            status="ok",
            chips=chips,
            traced_on=device.type,
            trace_s=round(time.time() - t0, 2),
            memory=counted["memory"],
            cost={
                "flops_per_device": counted["dispatch_analysis"]["flops_per_device"],
                "bytes_accessed_per_device": counted["dispatch_analysis"]["bytes_accessed_per_device"],
                "transcendentals": counted["dispatch_analysis"]["transcendental_elems"],
            },
            collectives={k: {key: v[key] for key in ("count", "result_bytes", "wire_bytes")}
                         for k, v in counted["dispatch_analysis"]["collectives"].items()},
            dispatch_analysis=counted["dispatch_analysis"],
            model={"n_params": cfg.n_params(), "n_active_params": cfg.n_active_params(), "seq_len": shape.seq_len,
                   "global_batch": shape.global_batch, "kind": shape.kind, "n_layers": cfg.n_layers},
        )
        print(f"[ok]   {arch} x {shape.name} ({name}/{sync_strategy}): traced in {rec['trace_s']:.1f}s, "
              f"flops/dev {rec['cost']['flops_per_device']:.3e}, "
              f"peak {counted['memory']['peak_bytes'] / 2**30:.2f} GiB, temp {counted['memory']['temp_bytes'] / 2**30:.2f} GiB")
    except Exception as e:  # noqa: BLE001 - record and continue, as the reference's
        rec.update(status="error", error=f"{type(e).__name__}: {e}", traceback=traceback.format_exc()[-4000:])
        print(f"[FAIL] {arch} x {shape.name} ({name}): {type(e).__name__}: {e}")
    out_path.write_text(json.dumps(rec, indent=2))
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both", "one"],
                    help="one: {data: 1, model: 1}, the one-card step")
    ap.add_argument("--all", action="store_true", help="all archs x shapes")
    ap.add_argument("--sync", default="scu", choices=list(sync_policy_choices()))
    ap.add_argument("--remat", default="full")
    ap.add_argument("--tag", default="")
    ap.add_argument("--variant", default="", help="e.g. ssdchunk128, moehints, nosp, accum2")
    ap.add_argument("--compression", default="none", choices=["none", "int8"])
    ap.add_argument("--save-hlo", action="store_true", help="refused: the port compiles no HLO")
    ap.add_argument("--smoke", action="store_true", help="the archs' reduced configs")
    ap.add_argument("--kind", choices=["train", "prefill", "decode"], default=None,
                    help="a cell of its own instead of --shape: with --batch and --seq (a decode's cache length)")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--layers", type=int, default=None, help="cut each arch to this many layers")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    args = ap.parse_args(argv)
    if args.save_hlo:
        ap.error("--save-hlo: the port runs eagerly and compiles no HLO to save; the record's "
                 "dispatch_analysis is what the step dispatched")

    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    if args.kind is not None:
        if args.batch is None or args.seq is None or args.shape is not None:
            ap.error("--kind takes --batch and --seq, and no --shape")
        shapes = [ShapeConfig(f"{args.kind}_{args.batch}x{args.seq}", args.seq, args.batch, args.kind)]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    n_fail = 0
    for mesh in meshes:
        for arch in archs:
            for shape in shapes:
                rec = run_cell(arch, shape, mesh, Path(args.out), sync_strategy=args.sync, remat_policy=args.remat,
                               tag=args.tag, variant=args.variant, compression=args.compression,
                               smoke=args.smoke, layers=args.layers)  # fmt: skip
                if rec.get("status") == "error":
                    n_fail += 1
    if n_fail:
        raise SystemExit(f"{n_fail} cells failed")


if __name__ == "__main__":
    main()
