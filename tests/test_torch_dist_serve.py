"""Data-parallel serving over processes: ``serve(..., mesh=...)`` on
``{"data": 2, "model": 1}`` splits the batch, each process prefills and
decodes its rows into its block of the cache (placed by ``cache_specs``),
and the gathered tokens are those of one process serving the whole batch.

Port side: one group of 2 processes (``tests/_torch_dist.py``), spawned once
for this file, against ``serve`` in the test process; then the serving
launcher under ``torchrun`` against the launcher in one process.  The cache
blocks are held to ``cache_specs``, which ``tests/test_torch_dist_sharding.py``
holds to the JAX package's.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch.serve import make_inputs, serve
from repro_torch.models.lm import init_lm
from repro_torch.parallel.sharding import NamedSharding
from repro_torch.serve.decode import CausalLM, cache_shapes, cache_specs
from tests._torch_dist import float32_smoke, leaves_with_path, start_group

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ("phi4-mini-3.8b", "mamba2-1.3b")  # a KV cache, an SSD state


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    return start_group("serving", 2, tmp_path_factory.mktemp("dist_serve"), archs=ARCHS).results()


@pytest.mark.parametrize("arch", ARCHS)
def test_data_parallel_serving_gives_the_one_process_tokens(served, arch):
    cfg = float32_smoke(arch)
    model = CausalLM(cfg, init_lm(torch.Generator().manual_seed(0), cfg, torch.float32))
    want = serve(model, make_inputs(cfg, 4, 8, torch.Generator().manual_seed(1)), 4, log=lambda *a: None)["tokens"]
    for result in served:
        np.testing.assert_array_equal(result[("tokens", arch)], want.numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_each_process_holds_its_block_of_the_cache(served, arch):
    """Half the batch on each of the 2 data processes, the rest whole."""
    cfg = float32_smoke(arch)
    mesh = {"data": 2, "model": 1}
    specs = dict(leaves_with_path(cache_specs(cfg, mesh, 4, 12)))
    for result in served:
        blocks = result[("cache", arch)]
        assert sorted(blocks) == sorted(specs)
        for path, whole in leaves_with_path(cache_shapes(cfg, 4, 12)):
            assert blocks[path] == NamedSharding(mesh, specs[path]).shard_shape(whole.shape), path
            batch_axis = 1 if path[0] == "blocks" else 0
            assert blocks[path][batch_axis] == 2 and whole.shape[batch_axis] == 4, path


def test_serve_launcher_serves_data_parallel_over_two_processes():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    args = ["-m", "repro_torch.launch.serve", "--arch", "phi4-mini-3.8b", "--smoke", "--device", "cpu",
            "--batch", "4", "--prompt-len", "8", "--gen", "3"]  # fmt: skip
    run = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2"]
    two = subprocess.run(run + args, env=env, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert two.returncode == 0, two.stderr[-3000:]
    assert two.stdout.count("[serve] decoded 3 tokens x 2 seqs") == 1 and "on each data process" in two.stdout
    one = subprocess.run([sys.executable] + args, env=env, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert one.returncode == 0, one.stderr[-3000:]
    sample = [line for line in one.stdout.splitlines() if line.startswith("[serve] sample continuation")]
    assert len(sample) == 1 and two.stdout.count(sample[0]) == 1
