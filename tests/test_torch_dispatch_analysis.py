"""``repro_torch.launch.dispatch_analysis`` and ``launch.roofline`` on the
CPU: the reference analyzer's three properties (``tests/test_infra.py``:
a loop of 8 counts 8x, a matmul is 2 m n k, a collective is seen with its
group's size), the dtype split, the memory count, and the roofline's terms
for a hand-made record."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.launch.dispatch_analysis import analyze, wire_bytes
from repro_torch.launch.roofline import HBM_BW, LINK_BW, PEAK_FLOPS, analyze_record, bound_ms

ROOT = Path(__file__).resolve().parent.parent


def _body(x, w):
    return (x @ w).tanh() @ w.t()


def _loop(n):
    def fn(x, w):
        for _ in range(n):
            x = _body(x, w)
        return x

    return fn


def test_a_loop_of_eight_counts_eight_times():
    with FakeTensorMode():
        x, w = torch.empty(32, 64, dtype=torch.bfloat16), torch.empty(64, 128, dtype=torch.bfloat16)
        _, one = analyze(_loop(1), x, w)
        _, eight = analyze(_loop(8), x, w)
    a, b = one["dispatch_analysis"], eight["dispatch_analysis"]
    for key in ("flops_per_device", "bf16_flops_per_device", "transcendental_elems"):
        assert b[key] == 8 * a[key] > 0, key
    # the operand bytes of each iteration's ops are the same; the transposes are views
    assert b["bytes_accessed_per_device"] == 8 * a["bytes_accessed_per_device"]


@pytest.mark.parametrize("dtype,bucket", [(torch.bfloat16, "bf16_flops_per_device"), (torch.float32, "f32_flops_per_device")])
@pytest.mark.parametrize("m,n,k", [(128, 256, 64), (7, 33, 129)])
def test_a_matmul_is_two_m_n_k(dtype, bucket, m, n, k):
    with FakeTensorMode():
        a, b = torch.empty(m, k, dtype=dtype), torch.empty(k, n, dtype=dtype)
        _, rec = analyze(torch.matmul, a, b)
    d = rec["dispatch_analysis"]
    assert abs(d["flops_per_device"] / (2 * m * n * k) - 1) < 0.01
    assert d[bucket] == d["flops_per_device"]
    assert d["bytes_accessed_per_device"] == (m * k + k * n + m * n) * a.element_size()


def test_matmul_under_inference_mode_is_counted_as_its_product():
    with FakeTensorMode():
        a, b = torch.empty(16, 32, dtype=torch.bfloat16), torch.empty(32, 8, dtype=torch.bfloat16)
        with torch.inference_mode():
            _, rec = analyze(torch.matmul, a, b)
    assert rec["dispatch_analysis"]["bf16_flops_per_device"] == 2 * 16 * 32 * 8


def test_the_count_is_flop_counter_modes_over_aten_ops_and_the_kernels():
    """One counter, the same formulas as ``FlopCounterMode``: over bf16 and
    float32 products, a composite op and K1's custom op on a fake card."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.compat import card_stand_in
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd

    def fn(q, w):
        out, _ = flash_attention_fwd(q, q, q, causal=True)
        return torch.matmul(out.float().flatten(0, 2), w).tanh() @ w.t()

    with FakeTensorMode(), card_stand_in():
        q, w = torch.empty(2, 4, 64, 32, dtype=torch.bfloat16), torch.empty(32, 48)
        _, rec = analyze(fn, q, w)
        with FlopCounterMode(display=False) as counter:
            fn(q, w)
    d = rec["dispatch_analysis"]
    assert d["flops_per_device"] == counter.get_total_flops() > 0
    assert d["bf16_flops_per_device"] > 0 and d["f32_flops_per_device"] == 2 * 2 * (2 * 4 * 64 * 32 * 48)


def test_memory_counts_arguments_outputs_and_the_peak():
    """Two 4 MB temporaries live at once on top of a 4 MB argument, one freed
    before the 4 MB output: peak 12 MB, temp 8 MB."""
    def fn(x):
        a = x * 2
        b = a + 1
        del a
        return b * 3

    with FakeTensorMode():
        x = torch.empty(1024, 1024)
        _, rec = analyze(fn, x)
    mb = 4 * 2**20
    assert rec["memory"] == {"argument_bytes": mb, "output_bytes": mb, "peak_bytes": 3 * mb, "temp_bytes": 2 * mb}


def test_a_broadcast_operand_is_read_once():
    with FakeTensorMode():
        x, row = torch.empty(256, 64), torch.empty(1, 64)
        _, rec = analyze(lambda a, r: a + r.expand(256, 64), x, row)
    assert rec["dispatch_analysis"]["bytes_accessed_per_device"] == (256 * 64 * 2 + 64) * 4


@pytest.mark.parametrize("kind,group,want", [("all-reduce", 4, 2 * 100 * 3 / 4), ("all-gather", 4, 100 * 3 / 4),
                                             ("reduce-scatter", 2, 100), ("all-to-all", 8, 100 * 7 / 8),
                                             ("broadcast", 4, 100), ("all-reduce", 1, 0)])
def test_wire_bytes_by_the_ring_formulas(kind, group, want):
    assert wire_bytes(kind, 100, group) == pytest.approx(want)


_GROUP = """
import json
import torch, torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.launch import dryrun
from repro_torch.launch.dispatch_analysis import analyze
with dryrun.fake_group(4):
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    def step(x):
        dist.all_reduce(x)
        out = torch.empty(2 * x.numel(), dtype=x.dtype)
        dist.all_gather_into_tensor(out, x, group=mesh.get_group("model"))
        part = torch.empty(x.numel() // 2, dtype=x.dtype)
        dist.reduce_scatter_tensor(part, x, group=mesh.get_group("data"))
        return out
    with FakeTensorMode():
        _, rec = analyze(step, torch.empty(1024))
print(json.dumps({"coll": rec["dispatch_analysis"]["collectives"], "up": dist.is_initialized()}))
"""


def test_a_collective_over_a_fake_group_of_four_is_seen_with_its_group_size(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _GROUP], env=env, cwd=tmp_path, capture_output=True, text=True,
                          timeout=120)  # fmt: skip
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    coll = got["coll"]
    assert coll["all-reduce"] == {"count": 1, "result_bytes": 4096, "wire_bytes": 2 * 4096 * 3 / 4, "group_sizes": [4]}
    assert coll["all-gather"] == {"count": 1, "result_bytes": 8192, "wire_bytes": 8192 / 2, "group_sizes": [2]}
    assert coll["reduce-scatter"] == {"count": 1, "result_bytes": 2048, "wire_bytes": 2048.0, "group_sizes": [2]}
    assert got["up"] is False


def _record(bf16, f32, nbytes, wire, kind="train", chips=4):
    return {"status": "ok", "arch": "a", "shape": "s", "mesh": "m", "chips": chips,
            "model": {"n_params": 10**9, "n_active_params": 10**9, "seq_len": 1000, "global_batch": 8, "kind": kind},
            "memory": {"argument_bytes": 2**30, "output_bytes": 0, "peak_bytes": 3 * 2**30, "temp_bytes": 2 * 2**30},
            "dispatch_analysis": {"flops_per_device": bf16 + f32, "bf16_flops_per_device": bf16,
                                  "f32_flops_per_device": f32, "bytes_accessed_per_device": nbytes,
                                  "wire_bytes_per_device": wire}}  # fmt: skip


def test_the_roofline_terms_of_a_hand_made_record():
    rec = _record(bf16=989e12, f32=67e12, nbytes=3.35e12, wire=450e9 * 4)
    row = analyze_record(rec)
    assert row["compute_s"] == pytest.approx(2.0) and row["memory_s"] == pytest.approx(1.0)
    assert row["collective_s"] == pytest.approx(4.0) and row["dominant"] == "collective"
    assert row["bound_s"] == pytest.approx(4.0) and bound_ms(rec) == pytest.approx(4000.0)
    assert row["roofline_fraction"] == pytest.approx(0.5)
    assert row["model_flops"] == 6 * 10**9 * 8 * 1000
    assert row["useful_ratio"] == pytest.approx(6 * 10**9 * 8000 / (4 * (989e12 + 67e12)))
    assert row["temp_gib"] == pytest.approx(2.0) and row["peak_gib"] == pytest.approx(3.0)
    decode = analyze_record(_record(1e12, 0, 1e9, 0, kind="decode", chips=1))
    assert decode["model_flops"] == 2 * 10**9 * 8 and decode["dominant"] == "compute"
    assert analyze_record({"status": "error"}) is None


def test_the_h100_constants_are_the_data_sheets():
    assert PEAK_FLOPS == {"bfloat16": 989e12, "float32": 67e12}
    assert HBM_BW == 3.35e12 and LINK_BW == 450e9


def test_the_roofline_table_reads_the_records(tmp_path, capsys):
    from repro_torch.launch.roofline import run

    (tmp_path / "single").mkdir()
    (tmp_path / "single" / "a__s.json").write_text(json.dumps(_record(989e12, 0, 1e9, 0)))
    (tmp_path / "single" / "b__s.json").write_text(json.dumps({"arch": "b", "shape": "s", "applicable": False,
                                                               "skip_reason": "why"}))
    out = run(str(tmp_path))
    assert [r.get("skip") for r in out["single"]] == [None, "why"]
    assert "Roofline on one H100 (single mesh)" in capsys.readouterr().out
