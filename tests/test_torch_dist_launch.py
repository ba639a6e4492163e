"""The training launcher over two CPU processes under ``torchrun``
(``python -m torch.distributed.run --standalone --nproc-per-node 2``): each
process joins the group through ``env://``, ``--mesh host`` is ``{"data": 2,
"model": 1}``, and only rank 0 prints or writes a checkpoint.  The serving
launcher's twin is in ``tests/test_torch_dist_serve.py``."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _run(args, timeout=120):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run(args, env=env, cwd=ROOT, capture_output=True, text=True, timeout=timeout)


def _torchrun(module, *args):
    return _run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
                 "-m", module, *args])  # fmt: skip


def test_train_launcher_trains_saves_and_resumes_over_two_processes(tmp_path):
    ckpt_dir = tmp_path / "ck"
    args = ["--arch", "mamba2-1.3b", "--smoke", "--device", "cpu", "--batch", "4", "--seq", "8",
            "--ckpt-dir", str(ckpt_dir), "--ckpt-every", "2"]  # fmt: skip
    first = _torchrun("repro_torch.launch.train", *args, "--steps", "2")
    assert first.returncode == 0, first.stderr[-3000:]
    assert first.stdout.count("[train] step     0 loss") == 1 and "resuming" not in first.stdout
    index = json.loads((ckpt_dir / "step_000000002" / "index.json").read_text())
    # one slot a rank, as a sharded run writes; the scu policy's ZeRO blocks split a leaf in halves
    assert {len(a["shards"]) for a in index["arrays"].values()} == {2}
    assert any(a["shards"][0]["index"] != a["shards"][1]["index"] for a in index["arrays"].values())
    second = _torchrun("repro_torch.launch.train", *args, "--steps", "4")
    assert second.returncode == 0, second.stderr[-3000:]
    assert second.stdout.count("[train] resuming from step 2") == 1
    assert sorted(p.name for p in ckpt_dir.iterdir()) == ["step_000000002", "step_000000004"]
