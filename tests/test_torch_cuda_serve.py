"""The decode step as one captured CUDA graph, on the card: the graph against
the eager step, and the launchers decoding through it and nothing else.

Smoke configs in bf16 of phi4-mini (GQA), mamba2 (the SSD state and conv
window, which a warm-up call replaces), deepseek-v2-lite (MLA latents at its
published head dims, and the MoE dispatch's sort and search under capture)
and jamba (SSD, attention and MoE layers).  These tests need an NVIDIA GPU and ``nvcc``; without a card
they skip.  Run them on a machine with one:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_serve.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.serve import make_inputs, serve, serve_stream, stage_prefill_cache
from repro_torch.models.lm import init_lm
from repro_torch.serve import decode as tdec
from repro_torch.serve.batching import Request
from repro_torch.train.optimizer import tree_map

pytestmark = pytest.mark.cuda

ARCHS = ["phi4-mini-3.8b", "mamba2-1.3b", "deepseek-v2-lite-16b", "jamba-v0.1-52b"]
B, S, STEPS = 3, 12, 8


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(arch, card):
    cfg = get_smoke_config(arch)
    if cfg.mla is not None:  # K1 is built for MLA's published (qk 192, v 128), not the smoke dims
        cfg = dataclasses.replace(cfg, head_dim=192, mla=dataclasses.replace(
            cfg.mla, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128))
    return tdec.CausalLM(cfg, init_lm(torch.Generator(device=card).manual_seed(0), cfg, torch.bfloat16))


def _staged(model, card, steps=STEPS):
    inputs = make_inputs(model.cfg, B, S, torch.Generator(device=card).manual_seed(1))
    logits, small = model.prefill(inputs)
    cache = stage_prefill_cache(small, model.init_cache(B, S + steps), S)
    return torch.argmax(logits, dim=-1).to(torch.int32)[:, None], cache


@pytest.mark.parametrize("arch", ARCHS)
def test_graph_matches_the_eager_step(card, arch):
    """``STEPS`` replays against ``STEPS`` eager steps on a copy of the same
    staged cache: the same tokens and logits at every step, and the same
    cache after them.  The capture itself leaves the cache as it found it,
    but for the last row of each attention leaf, which its warm-up wrote."""
    model = _model(arch, card)
    first, eager_cache = _staged(model, card)
    graph_cache = tree_map(torch.clone, eager_cache)
    before = tree_map(torch.clone, graph_cache)
    step = tdec.capture_serve_step(model.cfg, model.params, graph_cache, B)
    torch.cuda.synchronize()
    for (name, got), (_, want) in zip(tdec._flatten(graph_cache), tdec._flatten(before)):
        if name.split("__")[-1] in tdec.SEQ_AXIS:
            axis = tdec.SEQ_AXIS[name.split("__")[-1]]
            got, want = got.narrow(axis, 0, got.shape[axis] - 1), want.narrow(axis, 0, want.shape[axis] - 1)
        assert torch.equal(got, want), name

    start = torch.full((B,), S, dtype=torch.int32, device=card)
    step.feed(first, start)
    tok = first
    for i in range(STEPS):
        want_tok, want_logits, _ = model.decode_step(eager_cache, tok, start + i)
        got_tok, got_logits = step.replay()
        assert torch.equal(got_tok, want_tok), i
        tol = 5e-2 * max(1.0, want_logits.abs().max().item())  # chip_smoke.py's serving tolerance
        torch.testing.assert_close(got_logits, want_logits, rtol=0, atol=tol)
        tok = want_tok[:, None]
    assert step.replays == STEPS and step.position.tolist() == [S + STEPS] * B
    for (name, got), (_, want) in zip(tdec._flatten(graph_cache), tdec._flatten(eager_cache)):
        torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=5e-2, msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_keeps_every_token_of_the_graph(card, arch, monkeypatch):
    """The graph's outputs are overwritten by every replay: ``serve`` must clone
    what it keeps, or every kept token would read as the last one.  And it
    decodes through the one graph only."""
    model = _model(arch, card)
    inputs = make_inputs(model.cfg, B, S, torch.Generator(device=card).manual_seed(1))
    captured = []
    kept = launch_serve.capture_serve_step

    def counted(*args):
        captured.append(kept(*args))
        return captured[-1]

    def refused(*args):
        raise AssertionError("the eager step was made on the card")

    monkeypatch.setattr(launch_serve, "capture_serve_step", counted)
    monkeypatch.setattr(launch_serve, "EagerServeStep", refused)
    result = serve(model, inputs, STEPS, log=lambda line: None)
    assert [step.replays for step in captured] == [STEPS]
    first, cache = _staged(model, card)
    want, tok = [first[:, 0]], first
    for i in range(STEPS):
        next_tok, _, _ = model.decode_step(cache, tok, torch.full((B,), S + i, dtype=torch.int32, device=card))
        want.append(next_tok)
        tok = next_tok[:, None]
    assert torch.equal(result["tokens"], torch.stack(want, dim=1))


def test_stream_through_the_graph_matches_the_eager_stream(card, monkeypatch):
    model = _model("mamba2-1.3b", card)
    rng = np.random.default_rng(0)
    specs = [(rng.integers(0, model.cfg.vocab_size, int(rng.integers(1, 13))).tolist(), int(rng.integers(1, 7)))
             for _ in range(7)]  # fmt: skip

    def stream():
        return [Request(rid=i, prompt=p, max_new_tokens=m) for i, (p, m) in enumerate(specs)]

    graph = serve_stream(model, stream(), 3, 32, log=lambda line: None)
    monkeypatch.setattr(launch_serve, "capture_serve_step", tdec.EagerServeStep)
    eager = serve_stream(model, stream(), 3, 32, log=lambda line: None)
    assert graph["tokens"] == eager["tokens"] and graph["steps"] == eager["steps"]
    assert {rid: len(t) for rid, t in graph["tokens"].items()} == {i: m for i, (_, m) in enumerate(specs)}


def test_a_failed_capture_raises(card, monkeypatch):
    """A host sync in the step fails the capture, and the launcher raises:
    nothing decodes eagerly instead.  (Last in the file: the failed capture
    is the last thing its process does on the card.)"""
    model = _model("phi4-mini-3.8b", card)
    kept = tdec.unembed

    def syncing(p, x):
        float(x.sum())  # a host sync: refused under capture
        return kept(p, x)

    monkeypatch.setattr(tdec, "unembed", syncing)
    inputs = make_inputs(model.cfg, B, S, torch.Generator(device=card).manual_seed(1))
    with pytest.raises(RuntimeError):
        serve(model, inputs, 2, log=lambda line: None)
