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
prompt.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch.compat import resolve_device, synchronize, torch_dtype
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.models.lm import init_lm
from repro_torch.serve.decode import SEQ_AXIS, CausalLM

__all__ = ["stage_prefill_cache", "make_inputs", "serve", "main"]


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
    model: CausalLM, inputs: Dict[str, torch.Tensor], gen_len: int, log=print
) -> Dict[str, Any]:
    """Prefill ``inputs``, stage the cache, greedy-decode ``gen_len`` tokens.

    Returns the prefill's last logits, the generated tokens ``(b, gen_len + 1)``
    (the first comes from the prefill), the last step's logits and both times.
    """
    device = model.device
    batch, prompt_len = next(iter(inputs.values())).shape[:2]
    max_seq = prompt_len + gen_len

    synchronize(device)
    t0 = time.perf_counter()
    logits, prefill_cache = model.prefill(inputs)
    next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    synchronize(device)
    prefill_s = time.perf_counter() - t0
    log(f"[serve] prefill({batch}x{prompt_len}) {prefill_s:.2f}s")

    # decode against a max_seq cache, the prefill cache staged into it
    cache = stage_prefill_cache(prefill_cache, model.init_cache(batch, max_seq), prompt_len)
    del prefill_cache
    position = torch.full((batch,), prompt_len, dtype=torch.int32, device=device)
    out: List[torch.Tensor] = [next_tok]
    step_logits = logits
    synchronize(device)
    t0 = time.perf_counter()
    for i in range(gen_len):
        next_tok, step_logits, cache = model.decode_step(cache, next_tok[:, None], position + i)
        out.append(next_tok)
    synchronize(device)
    decode_s = time.perf_counter() - t0
    log(
        f"[serve] decoded {gen_len} tokens x {batch} seqs in {decode_s:.2f}s "
        f"({gen_len * batch / max(decode_s, 1e-9):.1f} tok/s)"
    )
    tokens = torch.stack(out, dim=1)
    log(f"[serve] sample continuation: {[int(t) for t in tokens[0, :10]]}")
    return {
        "prefill_logits": logits,
        "tokens": tokens,
        "last_logits": step_logits,
        "prefill_s": prefill_s,
        "decode_s": decode_s,
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

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    params = init_lm(torch.Generator(device=device).manual_seed(0), cfg, torch.bfloat16)
    model = CausalLM(cfg, params)
    n_params = sum(t.numel() for t in model.buffers())
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, {n_params / 1e9:.3f} B parameters in bf16 on {device}")
    inputs = make_inputs(
        cfg, args.batch, args.prompt_len, torch.Generator(device=device).manual_seed(1)
    )
    serve(model, inputs, args.gen)


if __name__ == "__main__":
    main()
