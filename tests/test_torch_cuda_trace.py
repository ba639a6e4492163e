"""The trace executor on the card: the captured CUDA graph against the CPU run.

``run_traces_torch`` on the card must equal the same call with
``device="cpu"`` bit for bit, on every field, for the parity programs of
``chip_smoke.py``'s trace phase and the 8-core mutexes (the CPU run is held
to the engine by ``tests/test_torch_trace.py``); the host syncs once a
replay, ``ceil(cycles / K)`` times or once more.  These tests need an NVIDIA
GPU; without a card they skip.  Run them on a machine with one:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_trace.py
"""

import math

import pytest
import torch

from chip_smoke import relocate_cluster, same_trace_result, trace_parity_programs
from repro_torch.core.scu.programs import trace_barrier_programs, trace_mutex_programs
from repro_torch.core.scu.trace_exec import run_traces_torch

pytestmark = pytest.mark.cuda

CASES = dict(trace_parity_programs())
for _v in ("tree", "tree4", "tree_ew"):
    CASES[f"{_v} mutex x8"] = (lambda v=_v: trace_mutex_programs(v, 8, t_crit=3, iters=3), 16)
CASES["three relocated sw barrier clusters"] = (
    lambda: [p for c, sfr in enumerate((0, 32, 5))
             for p in relocate_cluster(trace_barrier_programs("sw", 8, sfr=sfr, iters=3), c, 3, 16)],
    48,
)  # fmt: skip


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("name", list(CASES))
def test_card_equals_cpu(card, name):
    make, n_banks = CASES[name]
    cpu = run_traces_torch(make(), n_banks=n_banks, device="cpu")
    stats = {}
    got = run_traces_torch(make(), n_banks=n_banks, device=card, stats=stats)
    assert same_trace_result(got, cpu)
    least = math.ceil(cpu["cycles"] / stats["block_cycles"])
    assert stats["replays"] in (least, least + 1)


@pytest.mark.parametrize("block_cycles", [1, 7, 64])
def test_card_results_do_not_depend_on_the_block(card, block_cycles):
    make, n_banks = CASES["sw mutex x8"]
    cpu = run_traces_torch(make(), n_banks=n_banks, device="cpu")
    stats = {}
    got = run_traces_torch(make(), n_banks=n_banks, device=card, block_cycles=block_cycles, stats=stats)
    assert same_trace_result(got, cpu)
    least = math.ceil(cpu["cycles"] / block_cycles)
    assert stats["replays"] in (least, least + 1)


def test_max_cycles_raises_on_the_card(card):
    with pytest.raises(RuntimeError, match="within 50 cycles"):
        run_traces_torch(trace_barrier_programs("sw", 8, 7, 3), n_banks=16, device=card, max_cycles=50)
