"""Serving launcher: prefill a batch of prompts, then greedy-decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4-mini-3.8b \
        --batch 4 --prompt-len 4096 --gen 32

runs on the card and raises if there is none; add ``--smoke --device cpu`` for
the reduced config on the CPU.  ``--arch mamba2-1.3b`` serves the SSD model
(its prefill scan runs the SSD kernel on the card); ``deepseek-v2-lite-16b``
(MLA + MoE), ``qwen3-moe-30b-a3b`` (MoE) and ``jamba-v0.1-52b`` (SSD,
attention and MoE layers) serve the same way; ``--layers`` cuts the depth of
a model that does not fit the card whole (jamba: ``--layers 8``, one group).

Counterpart of ``repro/launch/serve.py``, with one difference: the prefill
cache is staged into the decode cache, so the generated tokens attend to the
prompt.  On the card the decode step runs as one captured CUDA graph
(``serve.decode.capture_serve_step``, the reference's ``jax.jit(serve_fn)``),
and nowhere eagerly; on the CPU it runs eagerly.

Over N processes, one a device (``torchrun``, as ``launch/train.py``), the
launcher serves data-parallel: ``serve(..., mesh=...)`` splits the batch over
the data axes of a ``{"data": N, "model": 1}`` ``DeviceMesh``, each process
prefills and decodes its rows into its block of the cache (placed by
``serve/decode.py``'s ``cache_specs``), and the tokens are gathered back; only
rank 0 prints.

``serve_stream`` is the loop ``serve/batching.py``'s ``ContinuousBatcher``
was written for: requests are admitted into a fixed set of slots, each prompt
prefilled alone and staged into its slot, and the one graph decodes every
slot a step.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.compat import synchronize, torch_dtype
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.launch.mesh import device_mesh, make_host_mesh
from repro_torch.models.lm import init_lm
from repro_torch.parallel.dist import is_distributed, join_if_launched
from repro_torch.parallel.sharding import NamedSharding, axis_sizes, batch_spec, check_data_parallel, gather, shard_local
from repro_torch.serve.batching import ContinuousBatcher, Request
from repro_torch.serve.decode import SEQ_AXIS, CausalLM, EagerServeStep, capture_serve_step

__all__ = [
    "stage_prefill_cache",
    "stage_prefill_slot",
    "decode_step_for",
    "make_inputs",
    "serve",
    "serve_stream",
    "main",
]


def stage_prefill_cache(prefill_cache: Any, cache: Any, prompt_len: int) -> Any:
    """Copy a prefill cache into a decode cache, in place: an attention leaf
    (GQA keys and values, MLA latents; sequence axis ``prompt_len``) into the
    first ``prompt_len`` positions of the longer one, an SSD state leaf (no
    sequence axis) whole."""
    for key, value in cache.items():
        if isinstance(value, dict):
            stage_prefill_cache(prefill_cache[key], value, prompt_len)
        elif key in SEQ_AXIS:
            value.narrow(SEQ_AXIS[key], 0, prompt_len).copy_(prefill_cache[key])
        else:
            value.copy_(prefill_cache[key])  # (..., b, h, p, n) or (..., b, w, conv_dim)
    return cache


def stage_prefill_slot(prefill_cache: Any, cache: Any, slot: int, prompt_len: int) -> Any:
    """Copy a batch-1 prefill cache into one slot of a decode cache, in place:
    an attention leaf into that slot's first ``prompt_len`` positions, an SSD
    state leaf into that slot whole, so that a recycled slot keeps no state
    of its last request.  The batch axis is the first of a prelude leaf and
    the second of a stacked ``blocks`` leaf (after the group axis)."""

    def stage(src, dst, batch_axis):
        for key, value in dst.items():
            if isinstance(value, dict):
                stage(src[key], value, 1 if key == "blocks" else batch_axis)
                continue
            into = value.select(batch_axis, slot)
            if key in SEQ_AXIS:  # counted from the end: the batch axis comes before it
                into = into.narrow(SEQ_AXIS[key], 0, prompt_len)
            into.copy_(src[key].select(batch_axis, 0))

    stage(prefill_cache, cache, 0)
    return cache


def decode_step_for(model: CausalLM, cache: Any, batch: int):
    """The step ``serve`` and ``serve_stream`` decode with: on the card the
    step captured as one CUDA graph (a failed capture raises), on the CPU the
    eager step.  Both advance their own ``tokens`` and ``position``."""
    if model.device.type == "cuda":
        return capture_serve_step(model.cfg, model.params, cache, batch)
    return EagerServeStep(model.cfg, model.params, cache, batch)


def make_inputs(
    cfg: ModelConfig, batch: int, prompt_len: int, gen: torch.Generator
) -> Dict[str, torch.Tensor]:
    """Random prompts drawn on the generator's device: token ids, or frame /
    patch embeddings for the archs whose modality frontend is a stub."""
    if cfg.frontend:
        emb = torch.randn(
            (batch, prompt_len, cfg.d_model), generator=gen, dtype=torch.float32, device=gen.device
        )
        return {"embeddings": emb.to(torch_dtype(cfg.dtype))}
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen, device=gen.device)
    return {"tokens": tokens}


def serve(
    model: CausalLM, inputs: Dict[str, torch.Tensor], gen_len: int, log=print, mesh: Any = None
) -> Dict[str, Any]:
    """Prefill ``inputs``, stage the cache, greedy-decode ``gen_len`` tokens.

    Returns the prefill's last logits, the generated tokens ``(b, gen_len + 1)``
    (the first comes from the prefill), the last step's logits, both times
    and the capture's (0 on the CPU).  With a ``DeviceMesh`` ``mesh`` (one
    process a device, every process calling with the same ``inputs``), the
    batch is split over the mesh's data axes: each process serves its rows
    into its block of the cache, every process gets all the tokens (an
    all-gather over the data axes), and the logits are this process's rows.
    A mesh with ``model > 1`` raises ``NotImplementedError``.
    """
    device = model.device
    global_batch, prompt_len = next(iter(inputs.values())).shape[:2]
    max_seq = prompt_len + gen_len
    rows = None
    if mesh is not None:
        check_data_parallel(mesh)
        rows = NamedSharding(mesh, batch_spec(axis_sizes(mesh), extra_dims=1))
        inputs = {k: shard_local(v, NamedSharding(mesh, batch_spec(axis_sizes(mesh), extra_dims=v.dim() - 1)))
                  for k, v in inputs.items()}  # fmt: skip
    batch = next(iter(inputs.values())).shape[0]

    synchronize(device)
    t0 = time.perf_counter()
    logits, prefill_cache = model.prefill(inputs)
    next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    synchronize(device)
    prefill_s = time.perf_counter() - t0
    log(f"[serve] prefill({batch}x{prompt_len}) {prefill_s:.2f}s")

    # decode against a max_seq cache, the prefill cache staged into it
    cache = stage_prefill_cache(prefill_cache, model.init_cache(global_batch, max_seq, mesh), prompt_len)
    del prefill_cache
    t0 = time.perf_counter()
    step = decode_step_for(model, cache, batch)
    synchronize(device)
    capture_s = time.perf_counter() - t0
    if device.type == "cuda":
        log(f"[serve] decode step captured as one CUDA graph in {capture_s:.2f}s")
    step.feed(next_tok[:, None], torch.full((batch,), prompt_len, dtype=torch.int32, device=device))
    out: List[torch.Tensor] = [next_tok]
    step_logits = logits
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(gen_len):
        next_tok, step_logits = step.replay()
        out.append(next_tok.clone())  # a graph's outputs: the next replay overwrites them
    step_logits = step_logits.clone()
    synchronize(device)
    decode_s = time.perf_counter() - t0
    log(
        f"[serve] decoded {gen_len} tokens x {batch} seqs in {decode_s:.2f}s "
        f"({gen_len * batch / max(decode_s, 1e-9):.1f} tok/s)" + (" on each data process" if rows is not None else "")
    )
    tokens = torch.stack(out, dim=1)
    if rows is not None:
        tokens = gather(tokens, rows)
    log(f"[serve] sample continuation: {[int(t) for t in tokens[0, :10]]}")
    return {
        "prefill_logits": logits,
        "tokens": tokens,
        "last_logits": step_logits,
        "prefill_s": prefill_s,
        "decode_s": decode_s,
        "capture_s": capture_s,
    }


def serve_stream(
    model: CausalLM, requests: List[Request], slots: int, max_seq: int, log=print
) -> Dict[str, Any]:
    """Answer ``requests`` (token-id prompts) through a ``ContinuousBatcher``
    of ``slots`` slots over one decode cache of ``max_seq`` positions.

    A step: ``admit``; prefill each admitted prompt alone and stage it into
    its slot (``stage_prefill_slot``); write ``step_inputs`` into the decode
    step's buffers; one step (on the card one replay of the graph captured
    before the first step); ``observe``.  The batcher's quirk is kept: an
    admitted slot is fed its prompt's last token again, at the prompt's
    length.  Returns each request's generated tokens by rid, the step count
    and the times (host clock; prefill includes staging).
    """
    if model.cfg.frontend is not None:
        raise ValueError(f"{model.cfg.name} takes embeddings from its {model.cfg.frontend} frontend; "
                         "the batcher's prompts are token ids")  # fmt: skip
    device = model.device
    batcher = ContinuousBatcher(slots, max_seq)
    for req in requests:
        if not req.prompt:
            raise ValueError(f"request {req.rid} has an empty prompt: there is nothing to prefill")
        batcher.submit(req)
    cache = model.init_cache(slots, max_seq)
    t0 = time.perf_counter()
    step = decode_step_for(model, cache, slots)
    synchronize(device)
    capture_s = time.perf_counter() - t0

    prefill_s = decode_s = 0.0
    steps = 0
    t_start = time.perf_counter()
    while not batcher.drain_done():
        t0 = time.perf_counter()
        for slot in batcher.admit():
            prompt = batcher.slots[slot].prompt
            tokens = torch.tensor([prompt], dtype=torch.int64, device=device)
            stage_prefill_slot(model.prefill({"tokens": tokens})[1], cache, slot, len(prompt))
        synchronize(device)
        t1 = time.perf_counter()
        step.feed(*batcher.step_inputs())
        next_tokens, _ = step.replay()
        batcher.observe(next_tokens.cpu().numpy())
        decode_s += time.perf_counter() - t1
        prefill_s += t1 - t0
        steps += 1
    wall_s = time.perf_counter() - t_start
    generated = sum(len(req.generated) for req in batcher.finished.values())
    log(f"[serve] stream of {len(batcher.finished)} requests over {slots} slots: {steps} steps, "
        f"{generated} tokens in {wall_s:.2f}s (prefill {prefill_s:.2f}s, decode {decode_s:.2f}s)")
    return {
        "tokens": {rid: list(req.generated) for rid, req in batcher.finished.items()},
        "steps": steps,
        "generated": generated,
        "wall_s": wall_s,
        "prefill_s": prefill_s,
        "decode_s": decode_s,
        "capture_s": capture_s,
    }


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--layers", type=int, default=None, help="serve only this many layers (default: all)")
    args = ap.parse_args(argv)

    device, joined = join_if_launched(args.device)
    mesh = None
    if is_distributed():
        mesh = device_mesh(make_host_mesh(data=dist.get_world_size(), model=1, device=device), device)
    log = print if mesh is None or dist.get_rank() == 0 else (lambda *a, **k: None)
    try:
        cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
        if args.layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=args.layers)
        params = init_lm(torch.Generator(device=device).manual_seed(0), cfg, torch.bfloat16)
        model = CausalLM(cfg, params)
        n_params = sum(t.numel() for t in model.buffers())
        log(f"[serve] {cfg.name}: {cfg.n_layers} layers, {n_params / 1e9:.3f} B parameters in bf16 on {device}")
        inputs = make_inputs(
            cfg, args.batch, args.prompt_len, torch.Generator(device=device).manual_seed(1)
        )
        serve(model, inputs, args.gen, log=log, mesh=mesh)
    finally:
        if joined and is_distributed():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
