"""The serving loop around the batcher, on the CPU: a batch-1 prefill staged
into one slot of the decode cache (``stage_prefill_slot``), ``serve_stream``,
and the decode step on static buffers (``EagerServeStep``, the interface of
the captured graph).

float32 smoke configs of the three cache kinds: GQA (phi4-mini), SSD state
(mamba2) and MLA latents with MoE (deepseek-v2-lite).  Staging slot by slot
is held to the batch path within 1e-5 (the same float32 arithmetic at
another batch size).  ``serve_stream`` with 3 slots must give every request
the tokens it gets alone in 1 slot: recycled slots included, so a finished
request's SSD state may not reach the next one.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.serve import serve, serve_stream, stage_prefill_cache, stage_prefill_slot
from repro_torch.models.lm import init_lm
from repro_torch.serve import decode as tdec
from repro_torch.serve.batching import Request

ARCHS = ["phi4-mini-3.8b", "mamba2-1.3b", "deepseek-v2-lite-16b"]
TOL = 1e-5
MAX_SEQ = 24


def _model(arch, ample=False):
    """A float32 smoke model.  ``ample`` gives a MoE arch the capacity factor
    ``n_experts / top_k``: a prefill of 3 prompts and 3 prefills of one route
    the same tokens through experts of other capacities, so only a capacity
    that drops nothing makes the two paths compute the same function."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    if ample and cfg.moe is not None:
        factor = cfg.moe.n_experts / cfg.moe.top_k
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=factor))
    return tdec.CausalLM(cfg, init_lm(torch.Generator().manual_seed(0), cfg, torch.float32))


def _stale(cache, seed):
    """Fill every leaf with random values: the state a recycled slot would hold."""
    gen = torch.Generator().manual_seed(seed)
    for name, leaf in tdec._flatten(cache):
        leaf.copy_(torch.randn(leaf.shape, generator=gen))
    return cache


@pytest.mark.parametrize("arch", ARCHS)
def test_slot_staging_matches_batch_staging(arch):
    model = _model(arch, ample=True)
    b, n = 3, 10
    tokens = torch.randint(0, model.cfg.vocab_size, (b, n), generator=torch.Generator().manual_seed(1))
    logits, small = model.prefill({"tokens": tokens})
    first = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    position = torch.full((b,), n, dtype=torch.int32)
    batched = stage_prefill_cache(small, model.init_cache(b, MAX_SEQ), n)
    _, want, _ = model.decode_step(batched, first, position)

    slotted = _stale(model.init_cache(b, MAX_SEQ), seed=2)
    for slot in (2, 0, 1):
        one_logits, one = model.prefill({"tokens": tokens[slot : slot + 1]})
        torch.testing.assert_close(one_logits, logits[slot : slot + 1], rtol=TOL, atol=TOL)
        stage_prefill_slot(one, slotted, slot, n)
    _, got, _ = model.decode_step(slotted, first, position)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


def test_slot_staging_writes_one_slot_only():
    """The other slots keep what they held; the slot's attention rows past the
    prompt keep theirs too (masked until a step writes them); its SSD state is
    replaced whole."""
    for arch, leaf, seq in (("phi4-mini-3.8b", "k", True), ("mamba2-1.3b", "ssm", False)):
        model = _model(arch)
        _, one = model.prefill({"tokens": torch.arange(5)[None]})
        cache = _stale(model.init_cache(3, MAX_SEQ), seed=3)
        before = cache["blocks"]["pos_0"][leaf].clone()
        stage_prefill_slot(one, cache, 1, 5)
        after, src = cache["blocks"]["pos_0"][leaf], one["blocks"]["pos_0"][leaf]
        assert torch.equal(after[:, 0], before[:, 0]) and torch.equal(after[:, 2], before[:, 2])
        if seq:
            assert torch.equal(after[:, 1, :5], src[:, 0]) and torch.equal(after[:, 1, 5:], before[:, 1, 5:])
        else:
            assert torch.equal(after[:, 1], src[:, 0])


def _stream(vocab, seed=4, n=7):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, vocab, int(rng.integers(1, 13))).tolist(),
                    max_new_tokens=int(rng.integers(1, 7))) for i in range(n)]  # fmt: skip


@pytest.mark.parametrize("arch", ARCHS)
def test_stream_over_three_slots_matches_one_slot(arch):
    model = _model(arch)
    requests = _stream(model.cfg.vocab_size)
    lines = []
    three = serve_stream(model, _stream(model.cfg.vocab_size), 3, MAX_SEQ, log=lines.append)
    one = serve_stream(model, _stream(model.cfg.vocab_size), 1, MAX_SEQ, log=lines.append)
    assert three["tokens"] == one["tokens"]
    assert {rid: len(toks) for rid, toks in three["tokens"].items()} == {r.rid: r.max_new_tokens for r in requests}
    # 3 slots recycle: fewer steps than the requests' tokens, more than the longest request's
    assert max(r.max_new_tokens for r in requests) < three["steps"] < one["steps"] == three["generated"]
    assert len(lines) == 2 and lines[0].startswith("[serve] stream of 7 requests over 3 slots")


def test_stream_feeds_the_last_prompt_token_again():
    """The batcher's quirk, kept: after the prefill of the whole prompt, the
    first step takes the prompt's last token at the prompt's length."""
    model = _model("phi4-mini-3.8b")
    prompt = [5, 9, 17, 3]
    got = serve_stream(model, [Request(rid=0, prompt=prompt, max_new_tokens=3)], 1, MAX_SEQ, log=lambda line: None)
    cache = stage_prefill_cache(model.prefill({"tokens": torch.tensor([prompt])})[1], model.init_cache(1, MAX_SEQ), 4)
    tok, want = torch.tensor([[prompt[-1]]], dtype=torch.int32), []
    for i in range(3):
        next_tok, _, _ = model.decode_step(cache, tok, torch.tensor([4 + i], dtype=torch.int32))
        want.append(int(next_tok[0]))
        tok = next_tok[:, None]
    assert got["tokens"] == {0: want}


def test_stream_refuses_a_frontend_arch_and_an_empty_prompt():
    model = tdec.CausalLM(get_smoke_config("musicgen-medium"),
                          init_lm(torch.Generator().manual_seed(0), get_smoke_config("musicgen-medium")))  # fmt: skip
    with pytest.raises(ValueError, match="frontend"):
        serve_stream(model, [Request(rid=0, prompt=[1])], 1, MAX_SEQ)
    with pytest.raises(ValueError, match="empty prompt"):
        serve_stream(_model("phi4-mini-3.8b"), [Request(rid=0, prompt=[])], 1, MAX_SEQ)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_decodes_as_the_eager_step_loop(arch):
    """``serve`` through the step on static buffers gives the tokens and last
    logits of ``decode_step`` called a step at a time."""
    model = _model(arch)
    tokens = torch.randint(0, model.cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(5))
    result = serve(model, {"tokens": tokens}, 5, log=lambda line: None)
    logits, small = model.prefill({"tokens": tokens})
    cache = stage_prefill_cache(small, model.init_cache(2, 13), 8)
    tok, want = torch.argmax(logits, dim=-1).to(torch.int32), []
    want.append(tok)
    for i in range(5):
        tok, step_logits, _ = model.decode_step(cache, tok[:, None], torch.full((2,), 8 + i, dtype=torch.int32))
        want.append(tok)
    assert torch.equal(result["tokens"], torch.stack(want, dim=1))
    assert torch.equal(result["last_logits"], step_logits)
    assert result["capture_s"] >= 0


def test_eager_step_advances_its_buffers():
    model = _model("mamba2-1.3b")
    cache = model.init_cache(2, MAX_SEQ)
    step = tdec.EagerServeStep(model.cfg, model.params, cache, 2)
    step.feed(np.array([[3], [4]], np.int32), np.array([6, 2], np.int32))
    next_tokens, logits = step.replay()
    assert torch.equal(step.tokens, next_tokens[:, None].to(torch.int32))
    assert step.position.tolist() == [7, 3] and step.replays == 1 and logits.shape == (2, model.cfg.vocab_size)
    assert launch_serve.decode_step_for(model, cache, 2).__class__ is tdec.EagerServeStep


def test_decode_step_makes_its_serve_fn_once(monkeypatch):
    model = _model("phi4-mini-3.8b")
    made = []
    kept = tdec.make_serve_step
    monkeypatch.setattr(tdec, "make_serve_step", lambda *args: made.append(args) or kept(*args))
    cache = model.init_cache(2, MAX_SEQ)
    tok = torch.zeros((2, 1), dtype=torch.int32)
    for i in range(3):
        model.decode_step(cache, tok, torch.full((2,), i, dtype=torch.int32))
    model.decode_step(model.init_cache(2, MAX_SEQ + 1), tok, torch.zeros(2, dtype=torch.int32))
    assert [args[2:] for args in made] == [(2, MAX_SEQ), (2, MAX_SEQ + 1)]


def test_capture_serve_step_raises_on_a_cpu_cache():
    model = _model("phi4-mini-3.8b")
    with pytest.raises(ValueError, match="CUDA graph"):
        tdec.capture_serve_step(model.cfg, model.params, model.init_cache(2, MAX_SEQ), 2)
