"""The dry run (``repro_torch.launch.dryrun``) on the CPU: the smoke train,
prefill and decode cells of three archs over a fake ``{"data": 2, "model":
2}`` mesh (a ``"fake"`` process group of 4, rank 0), run once in a spawned
process, so that no group is ever left in a test worker; the command line
on a full-size cell; the refusals.  Nothing is launched and nothing is
allocated: the kernels' fake ops check and allocate on fake tensors."""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs.registry import get_smoke_config
from repro_torch.parallel.sharding import param_shardings
from repro_torch.train.step import abstract_params

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ("phi4-mini-3.8b", "mamba2-1.3b", "deepseek-v2-lite-16b")
KINDS = ("train", "prefill", "decode")
MESH = {"data": 2, "model": 2}
BATCH, SEQ = 4, 64

_CELLS = """
import json, sys
from pathlib import Path
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.kernels.flash_attention import kernel as k1
from repro_torch.kernels.ssd_scan import kernel as k2
import torch.distributed as dist
out = Path(sys.argv[1])
records = {}
for arch in %(archs)r:
    for kind in %(kinds)r:
        shape = ShapeConfig(f"{kind}_smoke", %(seq)d, %(batch)d, kind)
        records[f"{arch} {kind}"] = dryrun.run_cell(arch, shape, %(mesh)r, out, smoke=True)
records["launches"] = [k1.flash_attention_fwd.launches, k1.flash_attention_bwd.launches, k2.ssd_scan_fwd.launches]
records["group_left"] = dist.is_initialized()
(out / "records.json").write_text(json.dumps(records))
""" % dict(archs=ARCHS, kinds=KINDS, seq=SEQ, batch=BATCH, mesh=MESH)


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    proc = subprocess.run([sys.executable, "-c", _CELLS, str(out)], env=_env(), cwd=out, capture_output=True,
                          text=True, timeout=600)  # fmt: skip
    assert proc.returncode == 0, proc.stderr[-3000:]
    recs = json.loads((out / "records.json").read_text())
    recs["_dir"] = str(out)
    return recs


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_cell_is_ok_over_a_fake_mesh(records, arch, kind):
    rec = records[f"{arch} {kind}"]
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["chips"] == 4 and rec["mesh"] == "data2_model2"
    d = rec["dispatch_analysis"]
    assert d["flops_per_device"] > 0 and d["bytes_accessed_per_device"] > 0
    assert d["flops_per_device"] == d["bf16_flops_per_device"] + d["f32_flops_per_device"]
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"] > 0
    assert set(rec) >= {"arch", "shape", "mesh", "sync_strategy", "remat_policy", "applicable", "status", "chips",
                        "memory", "cost", "collectives", "dispatch_analysis", "model"}
    path = Path(records["_dir"]) / "data2_model2" / f"{arch}__{kind}_smoke__smoke.json"
    assert json.loads(path.read_text())["status"] == "ok"


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_cell_collectives_span_groups_of_two(records, arch, kind):
    """Every collective of a {"data": 2, "model": 2} step runs over one axis:
    a group of 2.  Training all-reduces at least (the model axis's partial
    sums and the loss over data)."""
    coll = records[f"{arch} {kind}"]["dispatch_analysis"]["collectives"]
    seen = [c for c in coll.values() if c["count"]]
    assert seen
    for c in seen:
        assert c["group_sizes"] == [2] and c["wire_bytes"] > 0
    if kind == "train":
        assert coll["all-reduce"]["count"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_cell_arguments_are_the_ranks_parameter_blocks(records, arch):
    """A prefill's arguments are this rank's parameter blocks (``param_shardings``
    over the mesh, reckoned here from the specs alone) and its rows of the
    prompts."""
    cfg = get_smoke_config(arch)
    params = abstract_params(cfg, torch.bfloat16)
    shardings = param_shardings(params, MESH, cfg)
    blocks = []

    def walk(tree, sh):
        if isinstance(tree, dict):
            for key in tree:
                walk(tree[key], sh[key])
        else:
            blocks.append(math.prod(sh.shard_shape(tree.shape)) * tree.element_size())

    walk(params, shardings)
    rows = BATCH // MESH["data"]
    inputs = rows * SEQ * (cfg.d_model * 2 if cfg.frontend else 4)
    assert records[f"{arch} prefill"]["memory"]["argument_bytes"] == sum(blocks) + inputs


def test_nothing_launched_and_no_group_left(records):
    assert records["launches"] == [0, 0, 0]
    assert records["group_left"] is False


def test_command_line_writes_a_full_size_record_and_nothing_under_the_reference_folder(tmp_path):
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "phi4-mini-3.8b",
                           "--shape", "decode_32k", "--out", str(tmp_path / "dryrun_torch")], env=_env(),
                          cwd=tmp_path, capture_output=True, text=True, timeout=300)  # fmt: skip
    assert proc.returncode == 0, proc.stderr[-3000:]
    rec = json.loads((tmp_path / "dryrun_torch" / "single" / "phi4-mini-3.8b__decode_32k.json").read_text())
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["cost"]["flops_per_device"] > 0 and rec["memory"]["peak_bytes"] > 0
    assert not (tmp_path / "artifacts" / "dryrun").exists()


def test_save_hlo_is_refused_by_name(tmp_path):
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "phi4-mini-3.8b",
                           "--shape", "train_4k", "--save-hlo", "--out", str(tmp_path)], env=_env(), cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)  # fmt: skip
    assert proc.returncode != 0 and "--save-hlo" in proc.stderr
    assert not any(tmp_path.iterdir())


def test_shape_applicable_skips_long_context_for_full_attention(tmp_path):
    from repro_torch.launch.dryrun import run_cell

    rec = run_cell("phi4-mini-3.8b", "long_500k", "single", tmp_path)
    assert rec["applicable"] is False and "sub-quadratic" in rec["skip_reason"]
