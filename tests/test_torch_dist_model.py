"""Serving over the ``model`` axis across processes, against the JAX
package's GSPMD program on the same mesh; and the MoE dispatch made global
over the data axes.

Port side: one group of 4 processes on ``{"data": 2, "model": 2}``
(``tests/_torch_dist.py``, job ``model_axis``), spawned once for this file:
each rank restores the float32 smoke params (drawn once from seed 0 and
saved in the checkpoint format both packages read) at their
``param_shardings`` placements (its blocks only) and serves 4 prompts of 8
tokens for 4 new ones -- tensor-parallel prefill, sequence-parallel decode,
experts over ``model``.  JAX side, meanwhile, in the test process, on the
same params: the reference's ``make_prefill`` and ``make_serve_step`` on the
2 x 2 host mesh, jitted as one program for each arch (one compile) with the params
and prompts at their shardings, the prefill cache staged into the decode
cache as the port's launcher stages it and constrained to the step's cache
shardings.  Beside both, the port's one-process ``serve`` of the whole
batch.

Tolerance: float32, rtol = atol = 1e-5 on the logits -- the same products
summed in another order (the partial sums of a row-split projection, the
softmax combined across sequence blocks, an expert's slots added per
process); the greedy tokens identical.

A second group of 2 processes on ``{"data": 2}`` (job ``moe_data``) holds
the MoE repair: deepseek's smoke model at its own capacity factor (1.25),
where an expert overflows, serves and trains as one process on the whole
batch does (rtol 1e-5, PR 28's tolerance).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.launch import mesh as jmesh
from repro.serve import decode as jdec
from repro_torch.launch.serve import make_inputs, serve
from repro_torch.models.layers import moe as tmoe
from repro_torch.models.lm import init_lm
from repro_torch.parallel.sharding import NamedSharding, param_specs
from repro_torch.serve.decode import SEQ_AXIS, CausalLM, cache_shapes, cache_specs
from repro_torch.train.checkpoint import save_checkpoint
from repro_torch.train.optimizer import init_opt_state
from repro_torch.train.step import abstract_params, make_train_step
from tests._torch_dist import float32_smoke, leaves_with_path, start_group, train_config

ROOT = Path(__file__).resolve().parent.parent
# GQA with every head split, q split / kv whole, MLA + MoE (+ a dense layer and
# shared experts), SSD, and the hybrid group (SSD, attention, MoE)
ARCHS = ("stablelm-3b", "phi4-mini-3.8b", "deepseek-v2-lite-16b", "mamba2-1.3b", "jamba-v0.1-52b")
GRID = {"data": 2, "model": 2}
BATCH, PROMPT, GEN = 4, 8, 4
ODD_VOCAB = 127  # does not split over model = 2
TOL = 1e-5
MOE_ARCH, MOE_SEQ, MOE_STEPS, MOE_LR = "deepseek-v2-lite-16b", 8, 2, 1e-2


def _prompts(arch):
    return np.random.default_rng(7).integers(0, jax_smoke_config(arch).vocab_size, (BATCH, PROMPT), dtype=np.int32)


def _jax_serve(arch, params, tokens):
    """JAX's prefill and GEN decode steps on the 2 x 2 host mesh, one jitted
    program: (prefill logits, tokens (b, GEN + 1), the last step's logits)."""
    cfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32")
    mesh = jmesh.make_host_mesh(data=2, model=2)
    prefill_fn, p_in, _, _ = jdec.make_prefill(cfg, mesh, BATCH, PROMPT)
    serve_fn, s_in, _, _ = jdec.make_serve_step(cfg, mesh, BATCH, PROMPT + GEN)

    def stage(path, big, part):  # the prompt's positions of an attention leaf, an SSD leaf whole
        name = path[-1].key
        if name not in SEQ_AXIS:
            return part
        index = [slice(None)] * big.ndim
        index[big.ndim + SEQ_AXIS[name]] = slice(0, PROMPT)
        return big.at[tuple(index)].set(part)

    def run(params, inputs):
        logits, small = prefill_fn(params, inputs)
        cache = jax.tree_util.tree_map_with_path(stage, jdec.init_cache(cfg, BATCH, PROMPT + GEN), small)
        cache = jax.lax.with_sharding_constraint(cache, s_in[1])
        tok = jnp.argmax(logits, -1).astype(jnp.int32)

        def step(i, carry):
            cache, tok, out, _ = carry
            tok, step_logits, cache = serve_fn(params, cache, tok[:, None], jnp.full((BATCH,), PROMPT + i, jnp.int32))
            return cache, tok, out.at[:, i + 1].set(tok), step_logits

        out = jnp.zeros((BATCH, GEN + 1), jnp.int32).at[:, 0].set(tok)
        _, _, out, step_logits = jax.lax.fori_loop(0, GEN, step, (cache, tok, out, logits))
        return logits, out, step_logits

    with mesh:
        placed = jax.device_put(params, p_in[0])
        got = jax.jit(run, in_shardings=p_in)(placed, {"tokens": tokens})
    return tuple(np.asarray(x) for x in got)


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Both groups, started together (the params drawn and saved first: the
    model axis group restores them), and the params by arch."""
    root = tmp_path_factory.mktemp("dist_model")
    params = {}
    for arch in ARCHS:
        params[arch] = init_lm(torch.Generator().manual_seed(0), float32_smoke(arch), torch.float32)
        save_checkpoint(str(root / f"params_{arch}"), 0, {"params": params[arch]})
        np.save(root / f"tokens_{arch}.npy", _prompts(arch))
    model = start_group("model_axis", 4, root, archs=ARCHS, batch=BATCH, prompt=PROMPT, gen=GEN, odd_vocab=ODD_VOCAB)
    moe = start_group("moe_data", 2, root / "moe", arch=MOE_ARCH, batch=BATCH, prompt=PROMPT, gen=GEN, seq=MOE_SEQ,
                      steps=MOE_STEPS, lr=MOE_LR)  # fmt: skip
    return {"model_axis": model, "moe_data": moe, "params": params}


@pytest.fixture(scope="module")
def model_axis(groups):
    """(JAX's results by arch, the port's one-process results by arch, the
    group's results by rank)."""
    params = groups["params"]
    jax_side, one = {}, {}
    for arch in ARCHS:
        tokens = _prompts(arch)
        jax_params = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params[arch])
        jax_side[arch] = _jax_serve(arch, jax_params, jnp.asarray(tokens))
        model = CausalLM(float32_smoke(arch), params[arch])
        one[arch] = serve(model, {"tokens": torch.from_numpy(tokens).long()}, GEN, log=lambda *a: None)
    return jax_side, one, groups["model_axis"].results()


def _rows(rank):
    """The batch rows of ``rank`` (data coordinate ``rank // 2``)."""
    d = rank // 2
    return slice(d * BATCH // 2, (d + 1) * BATCH // 2)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_equal_jax_on_the_2x2_mesh(model_axis, arch):
    jax_side, _, results = model_axis
    for rank, result in enumerate(results):
        assert result["coords"] == divmod(rank, 2)
        np.testing.assert_allclose(result[arch]["prefill_logits"], jax_side[arch][0][_rows(rank)], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_tokens_and_logits_equal_jax_on_the_2x2_mesh(model_axis, arch):
    jax_side, _, results = model_axis
    _, tokens, last = jax_side[arch]
    for rank, result in enumerate(results):
        np.testing.assert_array_equal(result[arch]["tokens"], tokens)
        np.testing.assert_allclose(result[arch]["last_logits"], last[_rows(rank)], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_axis_serving_equals_the_one_process_serve(model_axis, arch):
    _, one, results = model_axis
    for rank, result in enumerate(results):
        np.testing.assert_array_equal(result[arch]["tokens"], one[arch]["tokens"].numpy())
        for key in ("prefill_logits", "last_logits"):
            np.testing.assert_allclose(result[arch][key], one[arch][key][_rows(rank)].numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_holds_only_its_parameter_and_cache_blocks(model_axis, arch):
    """Every parameter leaf at its ``param_shardings`` block (model and data
    splits both), every cache leaf at its ``cache_specs`` block at 2 x 2."""
    results = model_axis[2]
    cfg = float32_smoke(arch)
    whole = dict(leaves_with_path(abstract_params(cfg, torch.float32)))
    specs = dict(leaves_with_path(param_specs(abstract_params(cfg, torch.float32), GRID, cfg=cfg)))
    cspecs = dict(leaves_with_path(cache_specs(cfg, GRID, BATCH, PROMPT + GEN)))
    split = 0
    for result in results:
        assert sorted(result[arch]["params"]) == sorted(whole)
        for path, leaf in whole.items():
            block = NamedSharding(GRID, specs[path]).shard_shape(leaf.shape)
            assert result[arch]["params"][path] == block, path
            split += block != tuple(leaf.shape)
        assert sorted(result[arch]["cache"]) == sorted(cspecs)
        for path, leaf in leaves_with_path(cache_shapes(cfg, BATCH, PROMPT + GEN)):
            assert result[arch]["cache"][path] == NamedSharding(GRID, cspecs[path]).shard_shape(leaf.shape), path
    assert split > 0


def test_a_train_step_over_model_builds_on_the_same_group(model_axis):
    """``check_data_parallel(mesh, "train")`` passes ``model = 2`` and
    ``make_train_step`` builds, its parameters placed over ``model`` (the
    training itself: ``tests/test_torch_dist_model_train*.py``)."""
    for result in model_axis[2]:
        assert result["train_built"] is True


def test_a_vocab_that_does_not_split_serves_replicated(model_axis):
    cfg = dataclasses.replace(float32_smoke("phi4-mini-3.8b"), vocab_size=ODD_VOCAB)
    model = CausalLM(cfg, init_lm(torch.Generator().manual_seed(0), cfg, torch.float32))
    want = serve(model, make_inputs(cfg, BATCH, PROMPT, torch.Generator().manual_seed(1)), GEN, log=lambda *a: None)
    for rank, result in enumerate(model_axis[2]):
        got = result["odd_vocab"]
        assert "model" not in got["table"] and got["prefill_logits"].shape == (BATCH // 2, ODD_VOCAB)
        np.testing.assert_array_equal(got["tokens"], want["tokens"].numpy())
        np.testing.assert_allclose(got["prefill_logits"], want["prefill_logits"][_rows(rank)].numpy(), rtol=TOL,
                                   atol=TOL)  # fmt: skip


def test_a_placed_model_steps_only_with_its_cache_placement(model_axis):
    """``CausalLM.decode_step`` and an ``EagerServeStep`` without ``cshards``
    refuse a placed model: a block of a cache does not tell its whole length."""
    for result in model_axis[2]:
        decode_step, eager = result["step_refusals"]
        assert "one process" in decode_step and "cshards" in decode_step
        assert "cache's placement" in eager and "cache_shards" in eager


def test_serve_launcher_over_four_processes_takes_model_2():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    args = ["-m", "repro_torch.launch.serve", "--arch", "phi4-mini-3.8b", "--smoke", "--device", "cpu",
            "--batch", "4", "--prompt-len", "8", "--gen", "3"]  # fmt: skip
    run = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4"]
    # the four processes and the one beside them at once
    procs = [subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for cmd in (run + args, [sys.executable] + args)]  # fmt: skip
    (four, four_err), (one, one_err) = [proc.communicate(timeout=120) for proc in procs]
    assert procs[0].returncode == 0, four_err[-3000:]
    assert four.count("[serve] decoded 3 tokens x 2 seqs") == 1 and "on each data process" in four
    assert procs[1].returncode == 0, one_err[-3000:]
    sample = [line for line in one.splitlines() if line.startswith("[serve] sample continuation")]
    assert len(sample) == 1 and four.count(sample[0]) == 1


# ---------------------------------------------------------------------------
# The MoE dispatch over the data axes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def moe_data(groups):
    """(the group's results by rank, the one-process serve, the one-process
    train losses and gradient norms, the dropped slots of the one-process
    serve and of the train steps' forwards)."""
    cfg = float32_smoke(MOE_ARCH)
    dropped = []
    kept = tmoe.dispatch_indices

    def counted(idx, n_experts, capacity):
        dest, token, order = kept(idx, n_experts, capacity)
        dropped.append(int((dest == n_experts * capacity).sum()))
        return dest, token, order

    tmoe.dispatch_indices = counted
    try:
        model = CausalLM(cfg, init_lm(torch.Generator().manual_seed(0), cfg, torch.float32))
        served = serve(model, make_inputs(cfg, BATCH, PROMPT, torch.Generator().manual_seed(1)), GEN,
                       log=lambda *a: None)  # fmt: skip
        prefill_dropped = sum(dropped)  # a decode step of 4 tokens drops none: its capacity is 8
        params = init_lm(torch.Generator().manual_seed(0), cfg, torch.float32)
        step_fn, _, _, _ = make_train_step(cfg, train_config("scu", MOE_LR, 1), {"data": 1, "model": 1})
        opt_state = init_opt_state(params)
        whole = torch.randint(0, cfg.vocab_size, (BATCH, MOE_SEQ + 1), generator=torch.Generator().manual_seed(2))
        data = {"tokens": whole[:, :-1], "labels": whole[:, 1:]}
        step = torch.zeros((), dtype=torch.int32)
        losses, norms = [], []
        dropped.clear()
        for _ in range(MOE_STEPS):
            params, opt_state, step, metrics = step_fn(params, opt_state, step, data)
            losses.append(metrics["loss"].item())
            norms.append(metrics["grad_norm"].item())
        train_dropped = sum(dropped)
    finally:
        tmoe.dispatch_indices = kept
    return groups["moe_data"].results(), served, losses, norms, prefill_dropped, train_dropped


def test_the_moe_runs_overflow_an_expert(moe_data):
    """At capacity factor 1.25 the prefill and the train forward drop slots:
    the case in which a per-process dispatch would drop others."""
    *_, prefill_dropped, train_dropped = moe_data
    assert float32_smoke(MOE_ARCH).moe.capacity_factor == 1.25
    assert prefill_dropped > 0 and train_dropped > 0


def test_moe_serving_over_data_equals_one_process(moe_data):
    results, served = moe_data[:2]
    for rank, result in enumerate(results):
        rows = slice(rank * BATCH // 2, (rank + 1) * BATCH // 2)
        np.testing.assert_array_equal(result["tokens"], served["tokens"].numpy())
        for key in ("prefill_logits", "last_logits"):
            np.testing.assert_allclose(result[key], served[key][rows].numpy(), rtol=1e-5, atol=1e-6)


def test_moe_training_over_data_equals_one_process(moe_data):
    results, _, losses, norms = moe_data[:4]
    for result in results:
        np.testing.assert_allclose(result["loss"], losses, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(result["grad_norm"], norms, rtol=1e-5, atol=1e-6)
