#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc``; without a device it exits non-zero and
prints no result.  It imports ``repro_torch`` from ``src/`` beside it and
nothing of the JAX package.  Phases, each of which ends the run with a
non-zero exit if it fails:

1. device:  the card's name and power limit; TF32 matmuls off.
2. build:   every CUDA kernel of the port, from the sources in the checkout,
            one ``nvcc`` a source, all started together: flash attention
            (K1), the SSD scan (K2), and the SCU barrier, notifier and
            self-signal (K3-K5, one source).
3. kernels: each kernel against its plain PyTorch version on the card, at the
            test shapes and at the shape its path gives it; its time
            beside the plain version's, one library call's (where PyTorch
            has one) and its bound.  K3 at 1 to the largest resident number
            of parties and 10,000 back-to-back launches, K4 for every
            target, K5 at sizes 1 to 2^20 and on an unaligned view, all
            exact; beside K3's bound, its latency floor (hand-offs between
            two SMs plus one launch, measured in the same run).
4. serve:   each served model at its published width (random weights from a
            seed) through the launcher's functions: a batch of prompts is
            prefilled, then greedy-decoded.  phi4-mini-3.8b (32 layers,
            d_model 3072, vocab 200064) through the attention kernel, and
            mamba2-1.3b (48 layers, d_model 2048, vocab 50280) through the
            SSD-scan kernel.  Checks that the logits are finite and the tokens
            in the vocabulary, that prefill launched the model's kernel once
            per layer (every count set to 0 just before, read just after),
            that the kernel path strays from a float32 model no further than
            the plain bf16 path does, and that prefill + staged cache + one
            decode step equals a prefill of one more token.
5. sync:    the chip-level barrier sweep (``repro_torch.launch.barriers``,
            the paper's Fig. 5 at chip granularity) with 8 parties under all
            seven registered policies: microseconds per barrier and the
            overhead curve for each.  Checks that every party is released
            with the count 8, that the ``scu`` policy launched K3 once a
            barrier (16 a region a pass), and that K5 raised the arrival
            words and K4 delivered the counts once a policy (every count
            set to 0 just before, read just after).
6. result:  one ``{"kernels": [...]}`` line (K1-K5), the card line, and the
            last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
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

# (b, s, h, p, n, chunk): the three shapes of tests/test_kernels.py, one
# ragged chunk and the smoke configs' dims in chunks of 11
SSD_SHAPES = [
    (1, 128, 2, 32, 16, 32),
    (2, 128, 4, 64, 32, 64),
    (1, 256, 2, 64, 128, 128),
    (1, 255, 2, 64, 128, 255),
    (2, 132, 2, 16, 16, 11),
]
# the figures of tests/test_kernels.py; the bf16 kernel must also hold half
# of its tolerance (it splits f32 operands into bf16 hi + lo and rounds only
# y, where the reference rounds it).  The final state is f32 on both sides.
SSD_TOL = {"float32": 3e-4, "bfloat16": 3e-2}

# K3's party counts: 1, powers and non-powers of two, the paper's 8, and
# more than one CTA an SM; the largest resident count is added at run time
SCU_PARTIES = [1, 2, 3, 5, 6, 8, 64, 128]
SCU_BACK_TO_BACK = 10_000
SCU_SIGNAL_SIZES = [8, 1, 7, 4099, 2**20]
SWEEP_PARTIES = 8  # the paper's eight-core cluster


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


def bound(nbytes: float, flops: float, dtype_name: str):
    """Least time for the work: (ms, 'bytes' | 'operations'), the larger of the two."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_bound(b, h, kvh, sq, sk, d, causal, dtype_name):
    """Bytes: q, k, v read once, out and lse written once.  Operations: two
    products of 2*d each for every (query, key) pair that the mask keeps."""
    size = 2 if dtype_name == "bfloat16" else 4
    nbytes = size * d * (2 * b * h * sq + 2 * b * kvh * sk) + 4 * b * h * sq
    pairs = sq * (sq + 1) // 2 if causal else sq * sk
    return bound(nbytes, 4 * d * b * h * pairs, dtype_name)


def ssd_flops(b, s, h, p, n, chunk) -> int:
    """Operations of the chunked SSD form, as the reference computes it: per
    (batch, head, chunk of Q), C B^T over the j <= i pairs only (the masked
    half not counted; counted per head, as the reference and the kernel
    compute it per head), those scores times x (j <= i), C times the carried
    state, and the state update: 2 FLOP a multiply-add.  The kernel's second
    (lo) products and the elementwise exp, decay and cumsum are not counted."""
    nc = s // chunk
    pairs = chunk * (chunk + 1) // 2
    return b * h * nc * (2 * pairs * (n + p) + 4 * chunk * n * p)


def ssd_bound(b, s, h, p, n, chunk, dtype_name):
    """Bytes: x, dt, A, B, C read once; y and the final state written once."""
    size = 2 if dtype_name == "bfloat16" else 4
    nbytes = size * (2 * b * s * h * p + 2 * b * s * n) + 4 * (b * s * h + h + b * h * p * n)
    return bound(nbytes, ssd_flops(b, s, h, p, n, chunk), dtype_name)


def check_attention_kernel(prompt_len: int, cfg) -> dict:
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


def check_ssd_kernel(prompt_len: int, cfg) -> dict:
    """Phase 3 for K2, the SSD chunked scan.  Returns its entry of the kernels line."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_fwd
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)

    def draw(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def inputs(b, s, h, p, n, x_dtype, dt_dtype):
        """Drawn as tests/test_kernels.py draws them."""
        return (draw(b, s, h, p, scale=0.5, dtype=x_dtype),
                F.softplus(draw(b, s, h)).to(dt_dtype),
                -torch.exp(draw(h, scale=0.3)),
                draw(b, s, n, scale=0.3, dtype=x_dtype),
                draw(b, s, n, scale=0.3, dtype=x_dtype))  # fmt: skip

    def ref32(x, dt, A, B, C, chunk):
        """The plain version on the same values widened to float32."""
        return ssd_scan_ref(x.float(), dt.float(), A, B.float(), C.float(), chunk=chunk)

    worst_bf16 = 0.0
    for b, s, h, p, n, chunk in SSD_SHAPES:
        for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            x, dt, A, B, C = inputs(b, s, h, p, n, dtype, dtype)
            y, st = ssd_scan_fwd(x, dt, A, B, C, chunk=chunk)
            torch.cuda.synchronize()
            ry, rst = ref32(x, dt, A, B, C, chunk)
            err = (y.float() - ry).abs().max().item()
            rel = ((y.float() - ry).abs() / (1 + ry.abs())).max().item()  # in units of the tolerance's
            floor = (ry.to(dtype).float() - ry).abs().max().item()  # rounding y to the output type alone
            st_err = (st - rst).abs().max().item()
            tol = SSD_TOL[name]
            print(f"[kernels] ssd_scan_fwd b={b} s={s} h={h} p={p} n={n} chunk={chunk} {name}: "
                  f"y max_abs_err {err:.3e} (tol {tol:g}; max |y| {ry.abs().max().item():.3f}, rounding y to "
                  f"{name} alone {floor:.3e}), err/(1+|y|) {rel:.3e}, final_state max_abs_err {st_err:.3e} (tol 3e-4)")
            if not torch.allclose(y.float(), ry, rtol=tol, atol=tol):
                raise SystemExit(f"ssd_scan_fwd disagrees with ssd_scan_ref: {err}")
            if not torch.allclose(st, rst, rtol=3e-4, atol=3e-4):
                raise SystemExit(f"ssd_scan_fwd's final state disagrees with ssd_scan_ref: {st_err}")
            if name == "bfloat16":
                worst_bf16 = max(worst_bf16, rel)
                if rel > tol / 2:
                    raise SystemExit(f"ssd_scan_fwd bf16 error {rel} is above half the tolerance")
    print(f"[kernels] ssd_scan_fwd largest bf16 error at the test shapes: {worst_bf16:.3e} of 3e-2 "
          "(|kernel - plain| / (1 + |plain|), the tolerance's own measure)")

    # the shape the serving path gives it: x, B, C bf16 from the conv, dt f32 from the softplus
    s_cfg = cfg.ssm
    h = s_cfg.expand * cfg.d_model // s_cfg.head_dim
    b, s, p, n, chunk = BATCH, prompt_len, s_cfg.head_dim, s_cfg.d_state, min(s_cfg.chunk, prompt_len)
    x, dt, A, B, C = inputs(b, s, h, p, n, torch.bfloat16, torch.float32)
    y, st = ssd_scan_fwd(x, dt, A, B, C, chunk=chunk)
    torch.cuda.synchronize()
    ry, rst = ref32(x, dt, A, B, C, chunk)
    scale = ry.abs().max().item()
    err = (y.float() - ry).abs().max().item()
    floor = (ry.to(torch.bfloat16).float() - ry).abs().max().item()
    st_err = (st - rst).abs().max().item()
    print(f"[kernels] ssd_scan_fwd at the serving shape b={b} s={s} h={h} p={p} n={n} g=1 chunk={chunk} "
          f"(x, B, C bf16, dt f32): y max_abs_err {err:.3e} (max |y| {scale:.3f}; rounding y to bf16 alone "
          f"{floor:.3e}), final_state max_abs_err {st_err:.3e} (max |state| {rst.abs().max().item():.3f})")
    if not (err <= 3e-2 * max(1.0, scale) and st_err <= 3e-4 * max(1.0, rst.abs().max().item())):
        raise SystemExit("ssd_scan_fwd disagrees with ssd_scan_ref at the serving shape")
    del ry, rst

    ms = time_ms(lambda: ssd_scan_fwd(x, dt, A, B, C, chunk=chunk), iters=20)
    plain_ms = time_ms(lambda: ssd_scan_ref(x, dt, A, B, C, chunk=chunk), iters=3, warmup=1)
    bound_ms, bound_by = ssd_bound(b, s, h, p, n, chunk, "bfloat16")
    flops = ssd_flops(b, s, h, p, n, chunk)
    print(f"[kernels] ssd_scan_fwd at the serving shape: kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s "
          f"of {flops / 1e9:.1f} GFLOP), plain {plain_ms:.3f} ms, library none (no PyTorch call computes "
          f"the SSD scan), bound {bound_ms:.4f} ms by {bound_by}")
    return {
        "name": "ssd_scan_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan_fwd.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:111",
        "launches": 0,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }


def check_scu_kernels() -> list:
    """Phase 3 for K3-K5, the SCU barrier, notifier and self-signal.  Every
    word is integer-valued, so every sum is exact in any order and each
    kernel must equal its plain version exactly.  Returns their entries of
    the kernels line, timed at the shapes the barrier sweep gives them."""
    import torch

    from repro_torch.kernels.scu_barrier import kernel as scu
    from repro_torch.kernels.scu_barrier.ref import barrier_ref, notifier_ref, self_signal_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)

    def words(*shape):
        return torch.randint(0, 50, shape, generator=gen, device=dev).float()

    def exact(name, got, want):
        torch.cuda.synchronize()  # a trap in the kernel surfaces here
        err = (got - want).abs().max().item()
        if got.shape != want.shape or err != 0:
            raise SystemExit(f"{name} disagrees with its plain version: max abs err {err}")
        return err

    # K3 --------------------------------------------------------------------
    most = scu.max_parties(0)
    for n in SCU_PARTIES + [most]:
        for shape in ((n,), (n, 3, 5)):
            arrive = words(*shape)
            exact(f"scu_barrier n={n} {shape}", scu.scu_barrier(arrive), barrier_ref(arrive))
    try:
        scu.scu_barrier(words(most + 1))
    except ValueError:
        pass
    else:
        raise SystemExit(f"scu_barrier took {most + 1} parties, more than fit on the card at once")
    print(f"[kernels] scu_barrier exact at n = {SCU_PARTIES + [most]} (the last the largest resident "
          f"group: one-warp CTAs, cooperative launch), words of shape () and (3, 5)")
    batch = words(SCU_BACK_TO_BACK, 8)
    outs = torch.empty_like(batch)
    t0 = time.perf_counter()
    for k in range(SCU_BACK_TO_BACK):
        outs[k] = scu.scu_barrier(batch[k])
    exact("scu_barrier back to back", outs, batch.sum(1, keepdim=True).expand_as(batch))
    print(f"[kernels] scu_barrier {SCU_BACK_TO_BACK} back-to-back launches at n=8, every result exact "
          f"({time.perf_counter() - t0:.2f} s on the host clock)")

    n = SWEEP_PARTIES
    arrive = torch.ones(n, device=dev)  # the sweep's arrival words
    err3 = exact("scu_barrier at the sweep's shape", scu.scu_barrier(arrive), barrier_ref(arrive))
    k3_ms = time_ms(lambda: scu.scu_barrier(arrive), iters=2000, warmup=20)
    k3_plain = time_ms(lambda: barrier_ref(arrive), iters=2000, warmup=20)
    k3_library = time_ms(lambda: arrive.sum(0, keepdim=True).expand_as(arrive), iters=2000, warmup=20)
    # bytes: the n arrival words read once, the n counts written once; operations: n adds a party
    k3_bound, k3_by = bound(8 * n, n * n, "float32")
    handoff = scu.handoff_ms()
    launch = scu.launch_ms(n)
    rounds = (n - 1).bit_length()
    print(f"[kernels] scu_barrier at n={n} (one word a party): kernel {k3_ms * 1e3:.2f} us, plain "
          f"{k3_plain * 1e3:.2f} us, library (sum + expand) {k3_library * 1e3:.2f} us, bound "
          f"{k3_bound * 1e3:.2e} us by {k3_by}; latency floor {rounds} hand-offs x {handoff * 1e3:.3f} us "
          f"+ one empty cooperative launch of {n} CTAs {launch * 1e3:.2f} us = "
          f"{(rounds * handoff + launch) * 1e3:.2f} us")

    # K4 --------------------------------------------------------------------
    for m in (1, 130):
        payload = words(n, m)
        for target in range(n):
            exact(f"scu_notifier n={n} m={m} target={target}", scu.scu_notifier(payload, target),
                  notifier_ref(payload, target))  # fmt: skip
    print(f"[kernels] scu_notifier exact at n={n} for every target, rows of 1 and 130 words")
    counts = torch.full((n, 1), float(n), device=dev)  # the sweep sends each party's count to party 0
    err4 = exact("scu_notifier at the sweep's shape", scu.scu_notifier(counts, 0), notifier_ref(counts, 0))
    k4_ms = time_ms(lambda: scu.scu_notifier(counts, 0), iters=2000, warmup=20)
    k4_plain = time_ms(lambda: notifier_ref(counts, 0), iters=2000, warmup=20)
    k4_bound, k4_by = bound(8 * n, n, "float32")
    print(f"[kernels] scu_notifier at n={n}, one word a party, target 0: kernel {k4_ms * 1e3:.2f} us, plain "
          f"{k4_plain * 1e3:.2f} us, library none (no one PyTorch call sends to one party), bound "
          f"{k4_bound * 1e3:.2e} us by {k4_by}; latency floor one hand-off + one launch")

    # K5 --------------------------------------------------------------------
    for size in SCU_SIGNAL_SIZES:
        x = torch.arange(size, dtype=torch.float32, device=dev)
        exact(f"scu_self_signal size {size}", scu.scu_self_signal(x), self_signal_ref(x))
    view = torch.arange(4100, dtype=torch.float32, device=dev)[1:]
    exact("scu_self_signal on an unaligned view", scu.scu_self_signal(view), self_signal_ref(view))
    print(f"[kernels] scu_self_signal exact at arange of {SCU_SIGNAL_SIZES} and on a view one element "
          "off the 16-byte boundary")
    big = torch.arange(2**20, dtype=torch.float32, device=dev)
    big_ms = time_ms(lambda: scu.scu_self_signal(big), iters=200, warmup=5)
    big_bound, _ = bound(8 * big.numel(), big.numel(), "float32")
    print(f"[kernels] scu_self_signal at 2^20 floats: kernel {big_ms * 1e3:.2f} us, library (x + 1) "
          f"{time_ms(lambda: big + 1, iters=200, warmup=5) * 1e3:.2f} us, bound {big_bound * 1e3:.2f} us by bytes")
    zeros = torch.zeros(n, device=dev)  # the sweep's arrival events
    err5 = exact("scu_self_signal at the sweep's shape", scu.scu_self_signal(zeros), self_signal_ref(zeros))
    k5_ms = time_ms(lambda: scu.scu_self_signal(zeros), iters=2000, warmup=20)
    k5_plain = time_ms(lambda: self_signal_ref(zeros), iters=2000, warmup=20)
    k5_bound, k5_by = bound(8 * n, n, "float32")
    print(f"[kernels] scu_self_signal at the sweep's shape ({n} floats): kernel {k5_ms * 1e3:.2f} us, plain and "
          f"library (x + 1) {k5_plain * 1e3:.2f} us, bound {k5_bound * 1e3:.2e} us by {k5_by}")

    source = "src/repro_torch/kernels/scu_barrier/csrc/scu_barrier.cu"
    replaces = "src/repro/kernels/scu_barrier/kernel.py"
    return [
        {"name": "scu_barrier", "route": "cuda", "source": source, "replaces": f"{replaces}:79",
         "launches": 0, "max_abs_err": err3, "ms": k3_ms, "plain_ms": k3_plain, "bound_ms": k3_bound,
         "bound_by": k3_by, "library_ms": k3_library},
        {"name": "scu_notifier", "route": "cuda", "source": source, "replaces": f"{replaces}:112",
         "launches": 0, "max_abs_err": err4, "ms": k4_ms, "plain_ms": k4_plain, "bound_ms": k4_bound,
         "bound_by": k4_by, "library_ms": None},
        {"name": "scu_self_signal", "route": "cuda", "source": source, "replaces": f"{replaces}:134",
         "launches": 0, "max_abs_err": err5, "ms": k5_ms, "plain_ms": k5_plain, "bound_ms": k5_bound,
         "bound_by": k5_by, "library_ms": k5_plain},
    ]  # fmt: skip


def barrier_sweep(counters) -> dict:
    """Phase 5: the chip-level barrier sweep under every policy; returns the
    SCU kernels' launches in it."""
    import torch

    from repro_torch.launch.barriers import N_BARRIERS, REGION_SIZES, run
    from repro_torch.sync import available_policies

    names = available_policies()
    for counted in counters.values():
        counted.launches = 0
    t0 = time.perf_counter()
    result = run(parties=SWEEP_PARTIES, device="cuda", verbose=False)
    torch.cuda.synchronize()
    launches = {name: counted.launches for name, counted in counters.items()}
    n = SWEEP_PARTIES
    print(f"[sync] barrier sweep, {n} parties of (8, 128) f32, {N_BARRIERS} barriers a pass, "
          f"{result['passes']} passes a region (one warm-up), all {len(names)} policies: "
          f"{time.perf_counter() - t0:.1f} s")
    print("[sync] region  " + "".join(f"{s:>9s}" for s in names) + "   (overhead against compute only)")
    for i, region in enumerate(REGION_SIZES):
        print(f"[sync] {region:6d}  " + "".join(f"{result['curves'][s][i][2] * 100:8.0f}%" for s in names))
    print("[sync] us per (region + barrier) at region 1: "
          + ", ".join(f"{s} {result['curves'][s][0][1]:.2f}" for s in names))
    for s in names:
        if result["counts"][s] != [float(n)] * n:
            raise SystemExit(f"[sync] {s} released the parties with {result['counts'][s]}, not {n} each")
        if result["notified"][s] != float(n * (n - 1)):
            raise SystemExit(f"[sync] {s}: the notifier delivered {result['notified'][s]} to party 0, "
                             f"not the {n - 1} other counts of {n}")
    want = {"flash_attention_fwd": 0, "ssd_scan_fwd": 0,
            "scu_barrier": result["passes"] * N_BARRIERS * len(REGION_SIZES),
            "scu_notifier": len(names), "scu_self_signal": len(names)}  # fmt: skip
    if launches != want:
        raise SystemExit(f"[sync] kernel launches in the sweep {launches}, expected {want}")
    print(f"[sync] every party released with {n} under every policy; kernel launches {launches} "
          f"(scu_barrier {N_BARRIERS} a region a pass under the scu policy)")
    return launches


def plain_attention():
    """Within the block, the models' attention goes through its plain version."""
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models.layers import attention as attention_mod

    def plain(q, k, v, *, causal=True):
        return attention_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=causal
        ).transpose(1, 2)

    return _swapped(attention_mod, "flash_attention", plain)


def plain_ssd_scan():
    """Within the block, the SSD layers' scan goes through its plain version."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    def plain(x, dt, A, B, C, *, chunk, initial_state=None):
        return ssd_scan_ref(x, dt, A, B[:, :, 0], C[:, :, 0], chunk=chunk, initial_state=initial_state)

    return _swapped(ssd_ops, "ssd_scan", plain)


@contextlib.contextmanager
def _swapped(module, name, replacement):
    kept = getattr(module, name)
    setattr(module, name, replacement)
    try:
        yield
    finally:
        setattr(module, name, kept)


def check_model_against_plain(model, cfg, batch: int, plain, max_stray, step_len: int, s: int = 512) -> None:
    """The kernel path against the plain path and a float32 model at a prompt
    the plain version fits (``s``), and prefill(``step_len``) + staged cache +
    one decode step against a prefill of one more token, on the card.

    ``max_stray``, when given, also bounds the bf16 kernel path's distance
    from the float32 model by that share of the largest logit.
    """
    import torch

    from repro_torch.launch.serve import make_inputs, stage_prefill_cache
    from repro_torch.serve.decode import CausalLM

    gen = torch.Generator(device=model.device).manual_seed(3)
    tokens = make_inputs(cfg, batch, s + 1, gen)["tokens"]
    logits, cache = model.prefill({"tokens": tokens[:, :s]})
    with plain():
        plain_logits, plain_cache = model.prefill({"tokens": tokens[:, :s]})
    # the yardstick for both: the same weights in float32 through the plain version
    model32 = CausalLM(dataclasses.replace(cfg, dtype="float32"), model.params).to(torch.float32)
    with plain():
        true_logits, _ = model32.prefill({"tokens": tokens[:, :s]})
    err = (logits - plain_logits).abs().max().item()
    err_kernel = (logits - true_logits).abs().max().item()
    err_plain = (plain_logits - true_logits).abs().max().item()
    scale = true_logits.abs().max().item()
    name, first = next((k, v) for k, v in cache["blocks"]["pos_0"].items())
    leaf_err = (first[-1].float() - plain_cache["blocks"]["pos_0"][name][-1].float()).abs().max().item()
    print(f"[serve] {cfg.name} prefill({batch}x{s}) last logits (largest {scale:.2f}): kernel path vs plain "
          f"{err:.3e}; against the float32 model through the plain version: bf16 kernel path {err_kernel:.3e}, "
          f"bf16 plain path {err_plain:.3e}; last layer's cached {name}, kernel vs plain: {leaf_err:.3e}")
    # many layers of bf16 activations: the two bf16 paths round at different
    # places, so each is held to the float32 model, and the kernel path may
    # not stray further from it than the plain bf16 path does (x1.5 for the
    # spread between two draws of rounding noise)
    if not err_kernel <= 1.5 * err_plain + 1e-2:
        raise SystemExit(f"{cfg.name}: the kernel path strays further from float32 than the plain path")
    if max_stray is not None and not err_kernel <= max_stray * max(1.0, scale):
        raise SystemExit(f"{cfg.name}: the kernel path strays from the float32 model by {err_kernel}")

    # prefill n tokens, stage, decode token n + 1  ==  prefill of n + 1 tokens
    n = step_len

    def step_against_longer(m):
        small = m.prefill({"tokens": tokens[:, :n]})[1]
        big = stage_prefill_cache(small, m.init_cache(batch, n + 8), n)
        position = torch.full((batch,), n, dtype=torch.int32, device=m.device)
        return m.decode_step(big, tokens[:, n : n + 1], position)[1], m.prefill({"tokens": tokens[:, : n + 1]})[0]

    step_logits, longer_logits = step_against_longer(model)
    err = (step_logits - longer_logits).abs().max().item()
    print(f"[serve] {cfg.name} prefill({n}) + staged cache + one decode step vs prefill({n + 1}): max_abs_err {err:.3e}")
    # two bf16 paths again (the decode step is plain PyTorch, the prefill the kernel)
    if not err <= 5e-2 * max(1.0, longer_logits.abs().max().item()):
        raise SystemExit(f"{cfg.name}: decode against the staged prefill cache disagrees with a longer prefill")
    # the same in float32 through the kernels, where the staged cache must be exact
    step32, longer32 = step_against_longer(model32)
    with plain():
        plain32 = model32.prefill({"tokens": tokens[:, : n + 1]})[0]
    e32 = (step32 - longer32).abs().max().item()
    e_plain = (longer32 - plain32).abs().max().item()
    print(f"[serve] {cfg.name} float32 through the kernels: prefill({n}) + staged cache + one decode step vs "
          f"prefill({n + 1}) {e32:.3e}; prefill({n + 1}) against the plain version {e_plain:.3e}")
    if not (e32 <= 1e-3 * max(1.0, scale) and e_plain <= 1e-3 * max(1.0, scale)):
        raise SystemExit(f"{cfg.name}: the float32 kernel path disagrees")
    del model32
    torch.cuda.empty_cache()


def serve_at_full_width(cfg, kernel, counters, plain, max_stray, step_len: int) -> int:
    """Phase 4 for one model: returns how often ``kernel`` launched in its served request."""
    import torch

    from repro_torch.launch.serve import make_inputs, serve
    from repro_torch.models.lm import init_lm
    from repro_torch.serve.decode import CausalLM

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = CausalLM(cfg, init_lm(torch.Generator(device=dev).manual_seed(0), cfg, torch.bfloat16))
    n_params = sum(t.numel() for t in model.buffers())
    torch.cuda.synchronize()
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, vocab {cfg.vocab_size}, "
          f"{n_params / 1e9:.2f} B parameters in bf16, drawn on the card in {time.perf_counter() - t0:.1f} s")
    check_model_against_plain(model, cfg, BATCH, plain, max_stray, step_len)

    inputs = make_inputs(cfg, BATCH, PROMPT_LEN, torch.Generator(device=dev).manual_seed(1))
    torch.cuda.reset_peak_memory_stats()
    for counted in counters.values():
        counted.launches = 0
    result = serve(model, inputs, GEN)
    launches = {name: counted.launches for name, counted in counters.items()}
    if launches[kernel] != cfg.n_layers:
        raise SystemExit(f"{cfg.name}: prefill launched {kernel} {launches[kernel]} times, "
                         f"not once per layer ({cfg.n_layers})")
    if result["prefill_logits"].shape != (BATCH, cfg.vocab_size) or result["tokens"].shape != (BATCH, GEN + 1):
        raise SystemExit(f"{cfg.name}: serve returned the wrong shapes")
    if not (torch.isfinite(result["prefill_logits"]).all() and torch.isfinite(result["last_logits"]).all()):
        raise SystemExit(f"{cfg.name}: serve produced logits that are not finite")
    if not ((result["tokens"] >= 0) & (result["tokens"] < cfg.vocab_size)).all():
        raise SystemExit(f"{cfg.name}: serve produced token ids outside the vocabulary")
    tokens_in = BATCH * PROMPT_LEN
    print(f"[serve] {cfg.name} prefill {result['prefill_s'] * 1e3:.1f} ms ({tokens_in / result['prefill_s']:.0f} tok/s), "
          f"decode {result['decode_s'] / GEN * 1e3:.2f} ms/step ({GEN * BATCH / result['decode_s']:.1f} tok/s), "
          f"kernel launches {launches}, peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del model, result
    torch.cuda.empty_cache()
    return launches[kernel]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.compat import card_name_and_power_limit
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.scu_barrier import kernel as scu_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel

    t_start = time.perf_counter()
    # ---- 1. device ----------------------------------------------------------
    card = card_name_and_power_limit()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"torch.backends.cuda.matmul.allow_tf32 = {torch.backends.cuda.matmul.allow_tf32}")

    # ---- 2. build: one nvcc a source, all at once ----------------------------
    def timed_build(kernel_module):
        t0 = time.perf_counter()
        kernel_module.build()
        return time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor() as pool:
        builds = {name: pool.submit(timed_build, module) for name, module in
                  (("flash_attention_fwd.cu", flash_kernel), ("ssd_scan_fwd.cu", ssd_kernel),
                   ("scu_barrier.cu", scu_kernel))}
        for name, future in builds.items():
            print(f"[build] {name} with nvcc for sm_90a: {future.result():.1f} s (set-up; built side by side)")

    # ---- 3. kernels ---------------------------------------------------------
    phi4, mamba2 = get_config("phi4-mini-3.8b"), get_config("mamba2-1.3b")
    k1 = check_attention_kernel(PROMPT_LEN, phi4)
    k2 = check_ssd_kernel(PROMPT_LEN, mamba2)
    k3, k4, k5 = check_scu_kernels()

    # ---- 4. serve -----------------------------------------------------------
    counters = {"flash_attention_fwd": flash_kernel.flash_attention_fwd, "ssd_scan_fwd": ssd_kernel.ssd_scan_fwd,
                "scu_barrier": scu_kernel.scu_barrier, "scu_notifier": scu_kernel.scu_notifier,
                "scu_self_signal": scu_kernel.scu_self_signal}
    # 513 is no multiple of any attention tile: the ragged edge on the serving path
    k1["launches"] = serve_at_full_width(phi4, "flash_attention_fwd", counters, plain_attention, 5e-2, 512)
    # the SSD chunk must divide the prompt: 255 and 256 are one chunk each (255 the ragged one).
    # 48 layers of random SSD weights in bf16 stray from float32 further than 5 % of the
    # largest logit on either path, so only the plain path bounds the kernel's
    k2["launches"] = serve_at_full_width(mamba2, "ssd_scan_fwd", counters, plain_ssd_scan, None, 255)

    # ---- 5. sync -------------------------------------------------------------
    swept = barrier_sweep(counters)
    for entry in (k3, k4, k5):
        entry["launches"] = swept[entry["name"]]

    # ---- 6. result ----------------------------------------------------------
    print(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [k1, k2, k3, k4, k5]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
