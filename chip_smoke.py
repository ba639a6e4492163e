#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc``; without a device it exits non-zero and
prints no result.  It imports ``repro_torch`` from ``src/`` beside it and
nothing of the JAX package.  Phases, each of which ends the run with a
non-zero exit if it fails:

1. device:  the card's name and power limit; TF32 matmuls off.
2. build:   every CUDA kernel of the port, from the sources in the checkout.
3. kernels: each kernel against its plain PyTorch version on the card, at the
            test shapes and at the shape the serving path gives it; its time
            beside the plain version's, one library call's and its bound.
4. serve:   phi4-mini-3.8b at its published width (32 layers, d_model 3072,
            vocab 200064, bf16, random weights from a seed) through the
            launcher's functions: a batch of prompts is prefilled, then
            greedy-decoded.  Checks that the logits are finite, that prefill
            launched the attention kernel once per layer, that the kernel
            path agrees with the plain attention on the card, and that
            prefill + staged cache + one decode step equals a prefill of one
            more token.
5. result:  one ``{"kernels": [...]}`` line, the card line, and the last line
            ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# the request the serving phase answers: a batch of prompts, greedy-decoded
BATCH, PROMPT_LEN, GEN = 4, 4096, 32

# NVIDIA H100 SXM data sheet, dense rates
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12

# (b, h, kvh, s, d, causal): the four shapes of tests/test_kernels.py, one
# ragged length, the non-causal case, head dim 80 and the smoke configs' 16
KERNEL_SHAPES = [
    (1, 4, 4, 128, 64, True),
    (2, 8, 2, 256, 64, True),
    (1, 4, 1, 256, 128, True),
    (1, 2, 2, 512, 64, True),
    (2, 6, 2, 200, 128, True),
    (1, 2, 2, 128, 64, False),
    (1, 4, 4, 200, 80, True),
    (2, 4, 2, 130, 16, True),
]
# float32: the same f32 arithmetic in another order.  bfloat16: p and the
# output are rounded to 8 bits of mantissa at different places on each side.
KERNEL_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(b, h, kvh, sq, sk, d, causal, dtype_name):
    """Least time for one attention call: (ms, 'bytes' | 'operations').

    Bytes: q, k, v read once, out and lse written once.  Operations: two
    products of 2*d each for every (query, key) pair that the mask keeps.
    """
    size = 2 if dtype_name == "bfloat16" else 4
    nbytes = size * d * (2 * b * h * sq + 2 * b * kvh * sk) + 4 * b * h * sq
    pairs = sq * (sq + 1) // 2 if causal else sq * sk
    flops = 4 * d * b * h * pairs
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernels(prompt_len: int, cfg) -> dict:
    """Phase 3 for K1, the flash-attention forward.  Returns its entry of the kernels line."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref, attention_ref_lse

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)

    def draw(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    for b, h, kvh, s, d, causal in KERNEL_SHAPES:
        for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            q, k, v = draw(b, h, s, d, dtype=dtype), draw(b, kvh, s, d, dtype=dtype), draw(b, kvh, s, d, dtype=dtype)
            out, lse = flash_attention_fwd(q, k, v, causal=causal)
            torch.cuda.synchronize()
            ref = attention_ref(q, k, v, causal=causal)
            err = (out.float() - ref.float()).abs().max().item()
            lse_err = (lse - attention_ref_lse(q, k, causal=causal)).abs().max().item()
            tol = KERNEL_TOL[name]
            print(f"[kernels] flash_attention_fwd b={b} h={h} kvh={kvh} s={s} d={d} causal={causal} "
                  f"{name}: max_abs_err {err:.3e} (tol {tol:g}), lse err {lse_err:.3e}")
            if not torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol):
                raise SystemExit(f"flash_attention_fwd disagrees with attention_ref: {err}")
            if not lse_err <= 1e-4 * max(1.0, lse.abs().max().item()):
                raise SystemExit(f"flash_attention_fwd lse disagrees: {lse_err}")

    # the shape the serving path gives it, in the models' (b, s, h, d) layout
    b, h, kvh, d = BATCH, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    s = prompt_len
    q = draw(b, s, h, d, dtype=torch.bfloat16)
    k = draw(b, s, kvh, d, dtype=torch.bfloat16)
    v = draw(b, s, kvh, d, dtype=torch.bfloat16)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    out = flash_attention(q, k, v, causal=True)
    _, lse = flash_attention_fwd(qt, kt, vt, causal=True)
    torch.cuda.synchronize()
    ref = attention_ref(qt, kt, vt, causal=True).transpose(1, 2)
    err = (out.float() - ref.float()).abs().max().item()
    lse_err = (lse - attention_ref_lse(qt, kt, causal=True)).abs().max().item()
    tol = KERNEL_TOL["bfloat16"]
    if not torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol) or not lse_err <= 2e-3:
        raise SystemExit(f"flash_attention disagrees at the serving shape: {err}, lse {lse_err}")
    del ref

    ms = time_ms(lambda: flash_attention(q, k, v, causal=True), iters=20)
    plain_ms = time_ms(lambda: attention_ref(qt, kt, vt, causal=True), iters=3, warmup=1)
    # the yardstick: one library call for the same function; the port never calls it
    library_ms = time_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True),
        iters=20,
    )
    bound_ms, bound_by = attention_bound(b, h, kvh, s, s, d, True, "bfloat16")
    flops = 4 * d * b * h * (s * (s + 1) // 2)
    print(f"[kernels] flash_attention_fwd at the serving shape b={b} s={s} h={h} kvh={kvh} d={d} bf16 causal: "
          f"max_abs_err {err:.3e} (tol {tol:g}), lse err {lse_err:.3e}; kernel {ms:.3f} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s), "
          f"plain {plain_ms:.3f} ms, library (SDPA) {library_ms:.3f} ms, bound {bound_ms:.3f} ms by {bound_by}")
    return {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:126",
        "launches": 0,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }


def check_model_against_plain_attention(model, cfg, batch: int) -> None:
    """The kernel path against the plain attention, and prefill + decode
    against a longer prefill, on the card at a prompt the plain version fits."""
    import torch

    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.launch.serve import make_inputs, stage_prefill_cache
    from repro_torch.models.layers import attention as attention_mod
    from repro_torch.serve.decode import CausalLM

    s = 512
    gen = torch.Generator(device=model.device).manual_seed(3)
    tokens = make_inputs(cfg, batch, s + 1, gen)["tokens"]
    logits, cache = model.prefill({"tokens": tokens[:, :s]})

    def plain(q, k, v, *, causal=True):
        return attention_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=causal
        ).transpose(1, 2)

    def prefill_plain(m, inputs):
        kernel_path = attention_mod.flash_attention
        attention_mod.flash_attention = plain
        try:
            return m.prefill(inputs)
        finally:
            attention_mod.flash_attention = kernel_path

    plain_logits, plain_cache = prefill_plain(model, {"tokens": tokens[:, :s]})
    # the yardstick for both: the same weights in float32 with the plain attention
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = CausalLM(cfg32, model.params).to(torch.float32)
    true_logits, _ = prefill_plain(model32, {"tokens": tokens[:, :s]})
    del model32
    err = (logits - plain_logits).abs().max().item()
    err_kernel = (logits - true_logits).abs().max().item()
    err_plain = (plain_logits - true_logits).abs().max().item()
    scale = true_logits.abs().max().item()
    last_k = lambda c: c["blocks"]["pos_0"]["k"][-1].float()
    k_err = (last_k(cache) - last_k(plain_cache)).abs().max().item()
    print(f"[serve] prefill({batch}x{s}) last logits (largest {scale:.2f}): kernel path vs plain attention "
          f"{err:.3e}; against the float32 model: kernel path {err_kernel:.3e}, plain attention {err_plain:.3e}; "
          f"last layer's cached k, kernel vs plain: {k_err:.3e}")
    # 32 layers of bf16 activations: the two bf16 paths round at different
    # places, so each is held to the float32 model, and the kernel path may
    # not stray further from it than the plain bf16 path does (x1.5 for the
    # spread between two draws of rounding noise)
    if not (err_kernel <= 1.5 * err_plain + 1e-2 and err_kernel <= 5e-2 * max(1.0, scale)):
        raise SystemExit("the kernel path disagrees with the plain attention")

    # prefill s tokens, stage, decode token s + 1  ==  prefill of s + 1 tokens
    # (513 is no multiple of any tile: the ragged edge on the serving path)
    big = stage_prefill_cache(cache, model.init_cache(batch, s + 8), s)
    position = torch.full((batch,), s, dtype=torch.int32, device=model.device)
    _next, step_logits, _ = model.decode_step(big, tokens[:, s : s + 1], position)
    longer_logits, _ = model.prefill({"tokens": tokens})
    err = (step_logits - longer_logits).abs().max().item()
    print(f"[serve] prefill({s}) + staged cache + one decode step vs prefill({s + 1}): max_abs_err {err:.3e}")
    # two bf16 paths again (decode attention is plain PyTorch, prefill the kernel)
    if not err <= 5e-2 * max(1.0, longer_logits.abs().max().item()):
        raise SystemExit("decode against the staged prefill cache disagrees with a longer prefill")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.compat import card_name_and_power_limit
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.launch.serve import make_inputs, serve
    from repro_torch.models.lm import init_lm
    from repro_torch.serve.decode import CausalLM

    t_start = time.perf_counter()
    # ---- 1. device ----------------------------------------------------------
    card = card_name_and_power_limit()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"torch.backends.cuda.matmul.allow_tf32 = {torch.backends.cuda.matmul.allow_tf32}")
    dev = torch.device("cuda")

    # ---- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    flash_kernel.build()
    print(f"[build] flash_attention_fwd.cu with nvcc for sm_90a: {time.perf_counter() - t0:.1f} s (set-up)")

    # ---- 3. kernels ---------------------------------------------------------
    cfg = get_config("phi4-mini-3.8b")
    k1 = check_kernels(PROMPT_LEN, cfg)

    # ---- 4. serve -----------------------------------------------------------
    t0 = time.perf_counter()
    params = init_lm(torch.Generator(device=dev).manual_seed(0), cfg, torch.bfloat16)
    model = CausalLM(cfg, params)
    n_params = sum(t.numel() for t in model.buffers())
    torch.cuda.synchronize()
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, vocab {cfg.vocab_size}, "
          f"{n_params / 1e9:.2f} B parameters in bf16, drawn on the card in {time.perf_counter() - t0:.1f} s")
    check_model_against_plain_attention(model, cfg, BATCH)

    inputs = make_inputs(cfg, BATCH, PROMPT_LEN, torch.Generator(device=dev).manual_seed(1))
    torch.cuda.reset_peak_memory_stats()
    flash_kernel.flash_attention_fwd.launches = 0
    result = serve(model, inputs, GEN)
    k1["launches"] = flash_kernel.flash_attention_fwd.launches
    if k1["launches"] != cfg.n_layers:
        raise SystemExit(f"prefill launched the attention kernel {k1['launches']} times, not once per layer ({cfg.n_layers})")
    if result["prefill_logits"].shape != (BATCH, cfg.vocab_size) or result["tokens"].shape != (BATCH, GEN + 1):
        raise SystemExit("serve returned the wrong shapes")
    if not (torch.isfinite(result["prefill_logits"]).all() and torch.isfinite(result["last_logits"]).all()):
        raise SystemExit("serve produced logits that are not finite")
    if not ((result["tokens"] >= 0) & (result["tokens"] < cfg.vocab_size)).all():
        raise SystemExit("serve produced token ids outside the vocabulary")
    tokens_in = BATCH * PROMPT_LEN
    print(f"[serve] prefill {result['prefill_s'] * 1e3:.1f} ms ({tokens_in / result['prefill_s']:.0f} tok/s), "
          f"decode {result['decode_s'] / GEN * 1e3:.2f} ms/step "
          f"({GEN * BATCH / result['decode_s']:.1f} tok/s), "
          f"attention kernel launches {k1['launches']}, "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # ---- 5. result ----------------------------------------------------------
    print(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [k1]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
