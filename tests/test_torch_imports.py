"""The port stands alone: it imports ``torch``, never ``jax``, ``repro`` or ``ml_dtypes``."""

import os
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent

_PROBE = """
import sys
import repro_torch
from repro_torch.launch import serve
serve.main(["--arch", "phi4-mini-3.8b", "--smoke", "--device", "cpu",
            "--batch", "2", "--prompt-len", "8", "--gen", "3"])
serve.main(["--arch", "mamba2-1.3b", "--smoke", "--device", "cpu",
            "--batch", "2", "--prompt-len", "12", "--gen", "3"])
for arch in ("deepseek-v2-lite-16b", "qwen3-moe-30b-a3b", "jamba-v0.1-52b"):
    serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                "--batch", "2", "--prompt-len", "12", "--gen", "3"])
import repro_torch.convert, repro_torch.compat
import repro_torch.kernels.flash_attention.ops
import repro_torch.kernels.ssd_scan.ops, repro_torch.kernels.ssd_scan.kernel
import repro_torch.models.layers.ssm, repro_torch.models.layers.moe
import repro_torch.models.layers.attention, repro_torch.kernels.flash_attention.kernel
import repro_torch.sync, repro_torch.sync.axis, repro_torch.sync.api
import repro_torch.core.scu.engine, repro_torch.core.scu.primitives
import repro_torch.kernels.scu_barrier.ops, repro_torch.kernels.scu_barrier.kernel
import repro_torch.parallel.sharding, repro_torch.configs.base
from repro_torch.launch import barriers
barriers.main(["--parties", "3", "--device", "cpu"])
import torch
import repro_torch.train.optimizer, repro_torch.train.step
from repro_torch.configs.registry import get_smoke_config
from repro_torch.models.lm import init_lm
cfg = get_smoke_config("mamba2-1.3b")
tcfg = repro_torch.train.step.TrainConfig(remat_policy="full")
step_fn, _, _, _ = repro_torch.train.step.make_train_step(cfg, tcfg, {"data": 1, "model": 1})
params = init_lm(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
tokens = torch.randint(0, cfg.vocab_size, (2, 9), generator=torch.Generator().manual_seed(1))
state = (params, repro_torch.train.optimizer.init_opt_state(params), torch.tensor(0, dtype=torch.int32))
_, _, step, metrics = step_fn(*state, {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]})
assert int(step) == 1 and bool(torch.isfinite(metrics["loss"]))
assert repro_torch.configs.base.sync_policy_choices() == repro_torch.sync.available_policies()
import tempfile
import repro_torch.train.data, repro_torch.train.checkpoint, repro_torch.train.elastic, repro_torch.launch.mesh
from repro_torch.launch import train as launch_train
with tempfile.TemporaryDirectory() as ckpt_dir:
    args = ["--arch", "mamba2-1.3b", "--smoke", "--device", "cpu", "--batch", "2", "--seq", "8",
            "--ckpt-dir", ckpt_dir, "--ckpt-every", "2"]
    launch_train.main(args + ["--steps", "2"])
    _, _, history = launch_train.main(args + ["--steps", "3"])  # resumes at step 2
    assert len(history) == 1 and repro_torch.train.checkpoint.latest_step(ckpt_dir) == 2
import repro_torch.serve.batching
from repro_torch.serve.decode import CausalLM
cfg = get_smoke_config("phi4-mini-3.8b")
model = CausalLM(cfg, init_lm(torch.Generator().manual_seed(0), cfg, torch.bfloat16))
reqs = [repro_torch.serve.batching.Request(rid=i, prompt=[1, 2, 3][: i + 1], max_new_tokens=2) for i in range(3)]
out = serve.serve_stream(model, reqs, 2, 16)
assert sorted(out["tokens"]) == [0, 1, 2] and out["generated"] == 6
import repro_torch.core.scu.trace, repro_torch.core.scu.programs, repro_torch.core.scu.trace_exec
traced = repro_torch.core.scu.trace_exec.run_traces_torch(
    repro_torch.core.scu.programs.trace_barrier_programs("sw", 4, 8, 2), n_banks=8, device="cpu")
assert traced["cycles"] > 16 and (traced["finished_at"] >= 0).all()
chained = repro_torch.core.scu.trace_exec.run_traces_torch(
    repro_torch.core.scu.programs.trace_chain_programs("tree", 4, 5, 3), n_banks=8, device="cpu")
assert chained["cycles"] > 6 * 5 and (chained["finished_at"] >= 0).all()
import repro_torch.parallel.dist, repro_torch.sync.axis
import tests._torch_dist
from repro_torch.launch.mesh import device_mesh
with tempfile.TemporaryDirectory() as rendezvous:
    repro_torch.parallel.dist.init_distributed("cpu", rank=0, world=1, init_method=f"file://{rendezvous}/pg")
    mesh = device_mesh({"data": 1, "model": 1}, "cpu")
    axis = repro_torch.sync.axis.MeshAxis(mesh, "data")
    for name in repro_torch.sync.available_policies():
        assert float(repro_torch.sync.get_policy(name).chip_barrier(torch.tensor(3.0), axis)) == 3.0
    step_fn, _, _, _ = repro_torch.train.step.make_train_step(cfg, tcfg, mesh)
    params = init_lm(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab_size, (2, 9), generator=torch.Generator().manual_seed(1))
    state = (params, repro_torch.train.optimizer.init_opt_state(params), torch.tensor(0, dtype=torch.int32))
    _, _, step, metrics = step_fn(*state, {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]})
    assert int(step) == 1 and bool(torch.isfinite(metrics["loss"]))
    torch.distributed.destroy_process_group()
import repro_torch.launch.dryrun, repro_torch.launch.dispatch_analysis, repro_torch.launch.roofline
import repro_torch.kernels.costs, repro_torch.hardware
from repro_torch.configs.base import ShapeConfig
with tempfile.TemporaryDirectory() as out:
    rec = repro_torch.launch.dryrun.run_cell("phi4-mini-3.8b", ShapeConfig("p", 16, 2, "prefill"),
                                             {"data": 1, "model": 1}, out, smoke=True)
    assert rec["status"] == "ok" and repro_torch.launch.roofline.analyze_record(rec)["bound_s"] > 0
import repro_torch.core.scu.faults, repro_torch.core.scu.extensions, repro_torch.core.scu.scu_unit
import repro_torch.core.scu.checkpoint, repro_torch.core.scu.energy, repro_torch.core.scu.apps
import repro_torch.serve.arrivals, repro_torch.serve.energy, repro_torch.serve.fleet_service, repro_torch.serve.fleet_pool
from repro_torch.core.scu import APPS, prep_barrier_bench, run_app
assert run_app(APPS["fft"], "scu").cycles == 6023
svc = repro_torch.serve.fleet_service.FleetService(n_slots=1, slot_cores=8)
job = svc.submit(prep_barrier_bench("scu", 8, sfr=10, iters=3, compiled=True).config)
svc.run_until_drained()
assert job.state == "done" and job.stats.cycles > 0
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes"))
assert not bad, bad
print("PROBE-OK")
"""


def test_port_and_smoke_launcher_import_no_jax_and_no_repro():
    # one intra-op thread: the suite's workers hold the cores, and a probe spinning a
    # thread a core of its own beside them runs many times slower than alone
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], env=env, cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "PROBE-OK" in proc.stdout
    assert proc.stdout.count("[serve] decoded 3 tokens x 2 seqs") == 5
    assert "== Chip-level barrier disciplines (3 parties on cpu) ==" in proc.stdout
    assert proc.stdout.count("[train] step     0 loss") == 1 and "[train] resuming from step 2" in proc.stdout
    assert "[serve] stream of 3 requests over 2 slots: 4 steps, 6 tokens" in proc.stdout


def test_no_import_statement_names_jax_or_repro():
    pattern = re.compile(r"^\s*(import|from) (jax|repro|ml_dtypes)(\.|\s|$)", re.M)
    files = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + sorted((ROOT / "examples").glob("*_torch.py"))
             + [ROOT / "chip_smoke.py", ROOT / "tests" / "_torch_dist.py"])
    assert {"dryrun.py", "dispatch_analysis.py", "roofline.py", "costs.py", "hardware.py", "quickstart_torch.py",
            "engine.py", "apps.py", "checkpoint.py", "fleet_service.py", "fleet_pool.py"} <= {f.name for f in files}
    assert len(files) > 15
    for path in files:
        assert not pattern.search(path.read_text()), path


def test_port_never_calls_a_library_attention():
    for path in sorted((ROOT / "src" / "repro_torch").rglob("*.py")):
        text = path.read_text()
        assert "scaled_dot_product_attention" not in text, path
        assert "torch.compile" not in text, path


def test_launcher_refuses_to_run_without_a_card_unless_asked_for_the_cpu():
    from repro_torch.compat import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        try:
            resolve_device("cuda")
        except RuntimeError as err:
            assert "--device cpu" in str(err)
        else:
            raise AssertionError("resolve_device('cuda') must raise without a card")


def test_flash_attention_on_a_cpu_tensor_takes_the_plain_version():
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref

    assert flash_attention_fwd.launches == 0 or torch.cuda.is_available()
    before = flash_attention_fwd.launches
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(1, 40, 4, 16, generator=gen)
    k = torch.randn(1, 40, 2, 16, generator=gen)
    v = torch.randn(1, 40, 2, 16, generator=gen)
    out = flash_attention(q, k, v, causal=True)
    ref = attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=True)
    assert torch.equal(out, ref.transpose(1, 2))
    assert flash_attention_fwd.launches == before
