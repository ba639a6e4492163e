"""The port stands alone: it imports ``torch``, never ``jax`` or ``repro``."""

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
import repro_torch.convert, repro_torch.compat
import repro_torch.kernels.flash_attention.ops
import repro_torch.kernels.ssd_scan.ops, repro_torch.kernels.ssd_scan.kernel
import repro_torch.models.layers.ssm
import repro_torch.sync, repro_torch.sync.axis, repro_torch.sync.api
import repro_torch.core.scu.engine, repro_torch.core.scu.primitives
import repro_torch.kernels.scu_barrier.ops, repro_torch.kernels.scu_barrier.kernel
import repro_torch.parallel.sharding, repro_torch.configs.base
from repro_torch.launch import barriers
barriers.main(["--parties", "3", "--device", "cpu"])
assert repro_torch.configs.base.sync_policy_choices() == repro_torch.sync.available_policies()
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print("PROBE-OK")
"""


def test_port_and_smoke_launcher_import_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], env=env, cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "PROBE-OK" in proc.stdout
    assert proc.stdout.count("[serve] decoded 3 tokens x 2 seqs") == 2
    assert "== Chip-level barrier disciplines (3 parties on cpu) ==" in proc.stdout


def test_no_import_statement_names_jax_or_repro():
    pattern = re.compile(r"^\s*(import|from) (jax|repro)(\.|\s|$)", re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
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
