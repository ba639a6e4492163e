"""The three examples of the port (``examples/*_torch.py``) on the CPU with
``--device cpu`` at a smoke size: the quickstart (the MoE smoke config, a
forward pass and two training steps), ``train_100m_torch.py --smoke`` (four
steps, a checkpoint at the second, resumed from it) and the batched serve
(phi4's smoke config through the launcher).  On the card ``chip_smoke.py``'s
``[examples]`` phase runs them at their own sizes."""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import math

ROOT = Path(__file__).resolve().parent.parent


def _load(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_quickstart_on_the_cpu(capsys):
    got = _load("quickstart_torch").main(["--device", "cpu", "--steps", "2"])
    out = capsys.readouterr().out
    assert got["hidden_shape"] == (2, 32, 64) and len(got["losses"]) == 2
    assert all(math.isfinite(x) for x in got["losses"])
    assert "mesh: {'data': 1, 'model': 1}" in out and "over 2 steps" in out


def test_train_100m_resumes_from_its_checkpoint_on_the_cpu(tmp_path, capsys):
    got = _load("train_100m_torch").main(["--device", "cpu", "--smoke", "--steps", "4", "--ckpt", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert len(got["first"]) == 2 and len(got["resumed"]) == 2
    assert "[train] resuming from step 2" in out and "final loss" in out
    assert all(math.isfinite(x) for x in got["first"] + got["resumed"])


def test_serve_batch_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / "serve_batch_torch.py"), "--device", "cpu"], env=env,
                          cwd=ROOT, capture_output=True, text=True, timeout=300)  # fmt: skip
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "[serve] decoded 16 tokens x 4 seqs" in proc.stdout and "sample continuation" in proc.stdout
