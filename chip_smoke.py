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
            (K1) and its backward, the SSD scan (K2), and the SCU barrier,
            notifier and self-signal (K3-K5, one source).
3. kernels: each kernel against its plain PyTorch version on the card, at the
            test shapes and at the shape its path gives it; its time
            beside the plain version's, one library call's (where PyTorch
            has one) and its bound.  K2 names the form each shape took
            (``sequential``, or ``clusterK``: K CTAs a (batch, head)); the
            test shapes take clusters of 2, 4 and 8, the serving shapes the
            sequential form (the batch) and clusters of 2 (one prompt); it
            is timed at jamba's SSD dims too.  K1 names the
            path each shape took (``wgmma``, ``mma_sync`` or ``f32``), is
            checked at MLA's head dims (qk 192, v 128) and at head dim 80
            (both on ``wgmma`` in bf16, which the run checks), and is also
            timed at musicgen's heads (24 of 64), deepseek's MLA prefill (16
            heads, qk 192, v 128) and stablelm's head dim 80 beside SDPA and
            its bound; held to its plain version (a sequence at a time) and
            timed beside SDPA at llava-next's prefill (56 / 8 heads: 7 q
            heads a kv head) and command-r-plus's (96 / 8: 12).  K3
            exact in its cluster form (n = 1 to 8, and 9 and 16 where the
            card allows a cluster of 16) and its
            dissemination form (n = 64, 128 and the largest resident
            group), words of shape () and (3, 5), at rows one word under
            and one over the cluster form's cap, in 10,000 back-to-back
            launches and in 1,000 that alternate the forms; on words that
            are not integers every party's row bitwise the same in both
            forms.  K4 for every target, K5 at sizes 1 to 2^20 and on an
            unaligned view, all exact; beside K3's bound, the floor of the
            form it takes at the sweep's shape (measured in the same run).
            The autograd Functions around K1 and K2: each gradient against
            PyTorch's autograd of the plain version on the card (K1 at phi4's,
            deepseek's MLA and stablelm's head dims in bf16 and phi4's in
            float32, 1024 tokens, one launch of K1's backward kernel a
            gradient; K2 at mamba2's dims in the sequential and a cluster
            form).  K1's backward kernel against its plain version
            (``ops.attention_bwd``) at b=1, 4096 tokens at phi4's, MLA's and
            head dim 80's dims, and timed there in turns with SDPA's
            backward and the PyTorch FA-2 backward it replaced; K2's
            backward timed at the serving shape.
4. serve:   each served model at its published width (random weights from a
            seed) through the launcher's functions: a batch of prompts is
            prefilled, then greedy-decoded.  phi4-mini-3.8b (32 layers,
            d_model 3072, vocab 200064) through the attention kernel;
            mamba2-1.3b (48 layers, d_model 2048, vocab 50280) through the
            SSD-scan kernel; stablelm-3b (32 layers, d_model 2560, 32 heads of
            80) through the attention kernel at head dim 80;
            deepseek-v2-lite-16b (27 layers: MLA through the attention kernel
            at qk 192 / v 128, a dense prelude layer, 26 MoE layers) and
            qwen3-moe-30b-a3b (48 GQA + MoE layers) whole; and
            jamba-v0.1-52b cut to one group of 8 of its 32 layers (1
            attention and 7 SSD layers, 4 MoE; the whole model does not fit
            the card); then the four archs first served in this phase:
            codeqwen1.5-7b (32 layers, QKV bias) and musicgen-medium (48
            layers, frame embeddings from its stubbed frontend) whole,
            llava-next-34b whole (60 layers, 68.8 GB; its checks at 4
            layers) and command-r-plus-104b cut to 16 of its 64 layers
            (56.7 GB of 207.6; its checks at 2).  A check at a cut depth
            runs on the cut drawn alone before the served model, from its
            seed (the same weights).  Every model decodes its request
            through one captured CUDA graph and nothing else (the eager
            step refuses to be made), and the graph is held to the eager
            step: the same staged cache in two copies, 32 steps each,
            tokens equal at every step and the logits' largest gap within
            5e-2 of the largest logit (printed, and whether it is 0); ms a
            step of each in turns, one profiled step's idle share of each,
            and the peak memory with each.  Checks that the logits are
            finite and the tokens in the vocabulary, that prefill launched the attention kernel once
            per attention layer and the SSD kernel once per SSD layer (every
            count set to 0 just before, read just after), that the kernel
            path strays from a float32 model no further than the plain bf16
            path does (deepseek and qwen3-moe on their first 4 layers, whose
            float32 copy fits beside the model; a MoE model's routing
            differences between the paths are counted), and that prefill +
            staged cache + one decode step equals a prefill of one more
            token (a MoE model with capacity for every slot).  mamba2 then
            answers one prompt alone (K2 in clusters of 2, counted the same
            way), and that prefill is timed in turns with K2's sequential
            form, the form of a card without cluster launch.
4b. batch:  ``serve_stream`` on phi4-mini-3.8b whole: 24 requests from seed
            3 (prompts of 128-1024 tokens, 8-64 new tokens each) over 8
            slots of a 1152-position cache, through the graph, then the same
            stream through the eager step.  Checks that every request
            finishes with its tokens, that both runs' tokens are equal, and
            that K1 ran one batch-1 prefill per request (32 launches each);
            prints requests/s, generated tokens/s and ms a step of each.
5. train:   make_train_step (bf16 params, the scu policy, full remat) for
            5 steps on one fixed random batch: mamba2-1.3b whole (48 layers,
            4 x 4096) and phi4-mini-3.8b whole (32 layers, 1 x 4096), after a
            float32 step of each at 4 layers and 512 tokens through the
            kernels against one through the plain versions (loss, gradient
            norm, updated params).  Checks that every parameter leaf has a
            finite, non-zero gradient at step 0, that every loss is finite and
            the loss after 5 steps is below the first, and that a step
            launched K1 and K2 twice per layer of their kind (the forward and
            its recompute) and K1's backward once per attention layer (every
            count set to 0 just before, read just after).
            Reports step ms, peak memory, and one profiled step's device busy
            time, idle share and largest kernels.
5b. dist:   the data axis through ``torch.distributed``: one process, an NCCL
            group of world 1 (``file://`` rendezvous under ``build/``) and its
            ``{"data": 1, "model": 1}`` ``DeviceMesh``, after the train
            phase's memory is freed.  phi4-mini-3.8b whole trains 3 steps at
            1 x 4096 (the train phase's batch, bf16, scu, full remat) through
            ``make_train_step`` over the ``DeviceMesh`` (the scu policy's
            gradient collectives over NCCL, the step's placements) and 3
            steps without a group: losses and params bit-equal; K1's forward
            and backward launches a step those of the train phase (counts set
            to 0 just before a step, read just after).  The seven chip
            barriers over the mesh's data axis through NCCL equal the stacked
            shim at n = 1.  The params and the step saved by the group and
            restored with their placements, bit-equal (under ``build/``,
            removed after).  Prints the NCCL version, ms a step beside the
            train phase's, the checkpoint's seconds and the phase's.
6. loop:    the training loop, the checkpoint and the data pipeline
            (``repro_torch.launch.train``'s objects, ``train/loop.py``,
            ``train/checkpoint.py``, ``train/data.py``): mamba2-1.3b whole
            at 4 x 4096 SyntheticLM tokens a step (bf16, the scu policy, full
            remat, the launcher's lr 3e-3 and 10-step warm-up).  (A) 4 steps
            without a checkpoint; (B) ``launch.train.main`` itself, 2 steps
            with a checkpoint at step 2 under ``build/`` (removed at the end);
            (C) 4 steps in that directory, which resume at step 2.  Checks
            that C's losses are A's within rtol 1e-5 (atol 1e-6), that every
            step of A and C launched K2 twice a layer (counts set to 0 just
            before a step, read just after), and that every loss is finite.
            Reports the free disk and host memory, A's step ms beside the
            train phase's, SyntheticLM's ms a batch, the checkpoint's bytes,
            the snapshot's, the background write's and the restore's seconds,
            peak device memory and the largest loss gap.
7. sync:    the chip-level barrier sweep (``repro_torch.launch.barriers``,
            the paper's Fig. 5 at chip granularity) with 8 parties under all
            seven registered policies: microseconds per barrier and the
            overhead curve for each.  Checks that every party is released
            with the count 8, that the ``scu`` policy launched K3 once a
            barrier (16 a region a pass), and that K5 raised the arrival
            words and K4 delivered the counts once a policy (every count
            set to 0 just before, read just after).
8. trace:   the simulator's trace executor (``repro_torch.core.scu.trace_exec``
            ``run_traces_torch``: a block of cycles as one captured CUDA
            graph), every program built by the port's own ``TraceBuilder``
            and lowering.  (a) On the card against its CPU run, every field
            bit for bit: pure-TCDM programs at 4, 8 and 64 cores, a contended
            test-and-set lock, a store and loads of one word in one cycle,
            the ``sw``, ``tree`` and ``tree4`` barriers, the ``sw`` mutex and
            the ``sw``, ``tree`` and ``tree4`` barrier-synchronous chains (6
            items through 8 stages) at 8 cores, and the ``sw`` barrier at 64;
            the card at K = 1 and the default K.  (b) The paper's software barrier across the card:
            8,192 clusters of 8 cores (65,536 lanes, each cluster on its own
            16 banks), 8 barriers a core after an SFR of 0, 32, 128 or 512
            cycles, or 2 after one of 2048 (cut to keep the phase under 60
            s), in one call.  Checks that every cluster equals its
            SFR's cluster run alone on the CPU (counters, finish cycles,
            words), and the batch's bank conflicts and cycles; prints cycles
            a barrier and the overhead per SFR (the SW curve of the paper's
            Fig. 5), simulated cycles/s and lane-cycles/s, ms a replay,
            replays, capture s, and the CPU's us a cycle at 8 lanes.  No
            kernel launches in this phase (every count set to 0 just before,
            read just after).
9. result:  one ``{"kernels": [...]}`` line (K1, K1's backward, K2-K5), the
            card line, and the last line ``{"ok": true, "device": {...}}``.
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
# ragged length, the non-causal case, llava's 7 and command-r's 12 q heads a kv
# head at a ragged length, head dim 80 (causal, and non-causal at 4 q heads a kv head) and the
# smoke configs' 16
KERNEL_SHAPES = [
    (1, 4, 4, 128, 64, True),
    (2, 8, 2, 256, 64, True),
    (1, 4, 1, 256, 128, True),
    (1, 2, 2, 512, 64, True),
    (2, 6, 2, 200, 128, True),
    (1, 2, 2, 128, 64, False),
    (1, 7, 1, 333, 128, True),
    (1, 12, 1, 333, 128, True),
    (1, 4, 4, 200, 80, True),
    (2, 8, 2, 333, 80, False),
    (2, 4, 2, 130, 16, True),
]
# (b, h, kvh, s, dqk, dv, causal): MLA's pair (deepseek-v2-lite: qk 192 = nope
# 128 + rope 64, v 128, kvh = h = 16) at lengths shorter than one tile and one
# past a multiple of every tile, causal and not
KERNEL_PAIR_SHAPES = [
    (1, 16, 16, 77, 192, 128, True),
    (2, 16, 16, 513, 192, 128, True),
    (1, 16, 16, 200, 192, 128, False),
]
# musicgen-medium's attention (24 heads of 64, no GQA) at the serving request's
# length: K1's other Hopper head dim, timed beside the serving shape
MUSICGEN_HEADS = (24, 24, 64)
# float32: the same f32 arithmetic in another order.  bfloat16: p and the
# output are rounded to 8 bits of mantissa at different places on each side.
KERNEL_TOL = {"float32": 2e-5, "bfloat16": 2e-2}

# (b, s, h, p, n, chunk): the three shapes of tests/test_kernels.py, one
# ragged chunk, the smoke configs' dims in chunks of 11, and 16 tiles of two
# heads; in bf16 they take clusters of 2, 2, 4, 4, 2 and 8 CTAs (`scan_form`)
SSD_SHAPES = [
    (1, 128, 2, 32, 16, 32),
    (2, 128, 4, 64, 32, 64),
    (1, 256, 2, 64, 128, 128),
    (1, 255, 2, 64, 128, 255),
    (2, 132, 2, 16, 16, 11),
    (1, 1024, 2, 64, 128, 256),
]
# jamba-v0.1-52b's SSD layer (heads, head dim, state dim, chunk): d_model
# 4096, expand 2, 64-wide heads, d_state 16, chunk 128
JAMBA_SSD = (128, 64, 16, 128)
# the figures of tests/test_kernels.py; the bf16 kernel must also hold half
# of its tolerance (it splits f32 operands into bf16 hi + lo and rounds only
# y, where the reference rounds it).  The final state is f32 on both sides.
SSD_TOL = {"float32": 3e-4, "bfloat16": 3e-2}

# K3's party counts: in its cluster form 1, powers and non-powers of two and
# the paper's 8 (9 and 16 are added where the card allows a cluster of 16);
# in its dissemination form more than one CTA an SM, and the largest
# resident count, added at run time
SCU_CLUSTER_PARTIES = [1, 2, 3, 5, 6, 8]
SCU_DISSEMINATION_PARTIES = [64, 128]
SCU_BACK_TO_BACK = 10_000
SCU_ALTERNATING = 1_000
SCU_SIGNAL_SIZES = [8, 1, 7, 4099, 2**20]
SWEEP_PARTIES = 8  # the paper's eight-core cluster
# the one-prompt mamba2 prefill in K2's two forms: pairs timed in turns
ONE_SEQUENCE_PAIRS = 10
# command-r-plus-104b is served at this depth: 16 of its 64 layers (56.7 GB in bf16)
COMMAND_R_LAYERS = 16
# the [batch] phase: serve_stream on phi4-mini-3.8b whole, requests drawn from a
# seed with prompt lengths and max_new_tokens in these ranges (both ends included)
STREAM_SLOTS, STREAM_REQUESTS, STREAM_SEED = 8, 24, 3
STREAM_PROMPT, STREAM_NEW, STREAM_MAX_SEQ = (128, 1024), (8, 64), 1152

# K1's autograd Function (kernel forward, kernel backward) is checked at b=1,
# s=GRAD_LEN; the backward kernel is checked against its plain version and
# timed at b=1, s=PROMPT_LEN (phi4's training shape)
GRAD_LEN = 1024
# the gradient of the kernel path against autograd of the plain version on
# float32 copies of the inputs: float32 1e-4 of the largest entry; bf16 no
# further than 1.5x the plain bf16 path strays, plus 1e-2 of the largest entry
GRAD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# K1's backward kernel against its plain version (`ops.attention_bwd`, float32
# products) on the same bf16 inputs, each gradient within this share of its
# largest entry: the kernel rounds P and dS to bf16 as tensor-core operands and
# both round the gradients to bf16
BWD_TOL = 2e-2
# the backward's timing in turns: rounds of (kernel, SDPA, PyTorch FA-2) then
# the reverse; iterations of each (the FA-2 backward takes some 25 ms)
BWD_ROUNDS, BWD_ITERS, FA2_ITERS = 2, 20, 2
# K2's Function recomputes the plain version itself: its gradients are the
# plain version's at the same inputs, 1e-5 of the largest entry
SSD_GRAD_TOL = 1e-5
# the training phase: (arch, batch, sequence), TRAIN_STEPS steps each on one
# fixed batch, bf16 params, the scu policy, full remat
TRAIN_RUNS = (("mamba2-1.3b", 4, 4096), ("phi4-mini-3.8b", 1, 4096))
TRAIN_STEPS = 5
# the reference's default lr without its 100-step warm-up: five steps must move the loss
TRAIN_LR, TRAIN_WARMUP = 3e-4, 1
# the float32 step through the kernels against the plain versions: depth, length
F32_STEP_LAYERS, F32_STEP_LEN = 4, 512
# the loop phase: the launcher's arguments (its defaults otherwise: lr 3e-3 after a
# 10-step warm-up, SyntheticLM from seed 0), the steps of the uninterrupted run, and
# the step at which the interrupted run checkpoints; the resumed losses are held to
# the reference's resume tolerance (tests/test_train.py::test_checkpoint_resume_is_exact)
# the dist phase: steps of phi4-mini-3.8b through the DeviceMesh step and without a
# group (the train phase's batch and optimizer); the barrier words' shapes
DIST_ARCH, DIST_STEPS = "phi4-mini-3.8b", 3
DIST_WORD_SHAPES = ((), (3,), (2, 5))
LOOP_BATCH, LOOP_SEQ = 4, 4096
LOOP_ARGS = ["--arch", "mamba2-1.3b", "--batch", str(LOOP_BATCH), "--seq", str(LOOP_SEQ), "--sync", "scu",
             "--remat", "full"]  # fmt: skip
LOOP_STEPS, LOOP_CKPT_STEP = 4, 2
LOOP_RTOL, LOOP_ATOL = 1e-5, 1e-6
# the trace phase: the paper's software barrier (the ``sw`` policy) as TRACE_CLUSTERS
# independent clusters of TRACE_CORES cores (65,536 lanes), each on its own
# TRACE_BANKS banks (an eight-core cluster's, banking factor 2), TRACE_ITERS
# barriers a core after an SFR of each size in turn, cluster by cluster.  SFR
# 2048 is cut to TRACE_CUT_ITERS barriers: at 8 its 17,768 cycles would set the
# batch's length, and with the run of its cluster alone on the CPU take the phase
# past its 60 s on an H100
TRACE_CLUSTERS, TRACE_CORES, TRACE_BANKS = 8192, 8, 16
TRACE_SFRS, TRACE_ITERS, TRACE_CUT_ITERS = (0, 32, 128, 512, 2048), 8, {2048: 2}


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


def attention_flops(b, h, sq, sk, d, dv, causal) -> int:
    """Two products for every (query, key) pair that the mask keeps: q k^T
    (2*d FLOP) and p v (2*dv FLOP)."""
    pairs = sq * (sq + 1) // 2 if causal else sq * sk
    return 2 * (d + dv) * b * h * pairs


def attention_bound(b, h, kvh, sq, sk, d, causal, dtype_name, dv=None):
    """Bytes: q, k (d wide), v (dv wide) read once, out (dv wide) and lse
    written once.  Operations: ``attention_flops``."""
    dv = d if dv is None else dv
    size = 2 if dtype_name == "bfloat16" else 4
    nbytes = size * (d * (b * h * sq + b * kvh * sk) + dv * (b * kvh * sk + b * h * sq)) + 4 * b * h * sq
    return bound(nbytes, attention_flops(b, h, sq, sk, d, dv, causal), dtype_name)


def attention_bwd_bound(b, h, kvh, s, d, dv, dtype_name):
    """K1's backward, causal, sq = sk = s.  Bytes: q, k, v, out, dout and lse
    read once, dq, dk, dv written once.  Operations: the function's five
    products (P again, dP, dV, dK, dQ), 2.5x the forward's; the kernel's two
    passes take S and dP twice, 3.5x, which the bound does not count."""
    size = 2 if dtype_name == "bfloat16" else 4
    nbytes = size * (2 * d * (b * h * s + b * kvh * s) + dv * (b * kvh * s + 2 * b * h * s) + dv * b * kvh * s)
    nbytes += 4 * b * h * s
    return bound(nbytes, 2.5 * attention_flops(b, h, s, s, d, dv, True), dtype_name)


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


def check_attention_kernel(prompt_len: int, cfg, mla_cfg, d80_cfg, group_cfgs) -> dict:
    """Phase 3 for K1, the flash-attention forward.  Returns its entry of the
    kernels line: timed at ``cfg``'s serving shape, musicgen's heads,
    ``mla_cfg``'s MLA pair (qk 192, v 128) and ``d80_cfg``'s head dim 80; held
    to its plain version and timed at each of ``group_cfgs``' prefill shapes
    (llava's 7 and command-r's 12 q heads a kv head)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd, kernel_path
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref, attention_ref_lse

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)

    def draw(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    shapes = [(b, h, kvh, s, d, d, causal) for b, h, kvh, s, d, causal in KERNEL_SHAPES] + KERNEL_PAIR_SHAPES
    for b, h, kvh, s, d, dv, causal in shapes:
        if d in (80, 192) and kernel_path(torch.bfloat16, d, dv) != "wgmma":
            raise SystemExit(f"K1 at dqk={d} dv={dv} in bf16 takes the {kernel_path(torch.bfloat16, d, dv)} path, "
                             "not wgmma")
        for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            q, k, v = draw(b, h, s, d, dtype=dtype), draw(b, kvh, s, d, dtype=dtype), draw(b, kvh, s, dv, dtype=dtype)
            out, lse = flash_attention_fwd(q, k, v, causal=causal)
            torch.cuda.synchronize()
            ref = attention_ref(q, k, v, causal=causal)
            err = (out.float() - ref.float()).abs().max().item()
            lse_err = (lse - attention_ref_lse(q, k, causal=causal)).abs().max().item()
            tol = KERNEL_TOL[name]
            dims = f"d={d}" if dv == d else f"dqk={d} dv={dv}"
            print(f"[kernels] flash_attention_fwd b={b} h={h} kvh={kvh} s={s} {dims} causal={causal} "
                  f"{name}, {kernel_path(dtype, d, dv)} path: max_abs_err {err:.3e} (tol {tol:g}), lse err {lse_err:.3e}")
            if not torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol):
                raise SystemExit(f"flash_attention_fwd disagrees with attention_ref: {err}")
            if not lse_err <= 1e-4 * max(1.0, lse.abs().max().item()):
                raise SystemExit(f"flash_attention_fwd lse disagrees: {lse_err}")

    def at_full_size(b, h, kvh, d, with_plain, dv=None):
        """The kernel through ``ops.flash_attention`` on the models' (b, s, h, d)
        layout at the serving request's length: checked against the plain
        version, then timed beside it, one SDPA call and the bound."""
        s = prompt_len
        dv = d if dv is None else dv
        q = draw(b, s, h, d, dtype=torch.bfloat16)
        k = draw(b, s, kvh, d, dtype=torch.bfloat16)
        v = draw(b, s, kvh, dv, dtype=torch.bfloat16)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        out = flash_attention(q, k, v, causal=True)
        _, lse = flash_attention_fwd(qt, kt, vt, causal=True)
        torch.cuda.synchronize()
        # the plain version a sequence at a time: its float32 scores of all b at
        # command-r's 96 heads would take 26 GB
        rows = range(b)
        ref = torch.cat([attention_ref(qt[i : i + 1], kt[i : i + 1], vt[i : i + 1], causal=True) for i in rows])
        ref = ref.transpose(1, 2)
        err = (out.float() - ref.float()).abs().max().item()
        ref_lse = torch.cat([attention_ref_lse(qt[i : i + 1], kt[i : i + 1], causal=True) for i in rows])
        lse_err = (lse - ref_lse).abs().max().item()
        tol = KERNEL_TOL["bfloat16"]
        dims = f"d={d}" if dv == d else f"dqk={d} dv={dv}"
        if not torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol) or not lse_err <= 2e-3:
            raise SystemExit(f"flash_attention disagrees at b={b} s={s} h={h} kvh={kvh} {dims}: {err}, lse {lse_err}")
        del ref
        row = {"path": kernel_path(torch.bfloat16, d, dv), "max_abs_err": err,
               "ms": time_ms(lambda: flash_attention(q, k, v, causal=True), iters=20)}
        row["plain_ms"] = (time_ms(lambda: attention_ref(qt, kt, vt, causal=True), iters=3, warmup=1)
                           if with_plain else None)
        # the yardstick: one library call for the same function; the port never calls it.
        # SDPA takes dv != dqk on some of its backends; where none does, there is no such call.
        try:
            row["library_ms"] = time_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True), iters=20)
        except RuntimeError as refused:
            if dv == d:
                raise
            print(f"[kernels] SDPA refuses dqk={d} dv={dv}: {str(refused).splitlines()[0]}")
            row["library_ms"] = None
        row["bound_ms"], row["bound_by"] = attention_bound(b, h, kvh, s, s, d, True, "bfloat16", dv)
        flops = attention_flops(b, h, s, s, d, dv, True)
        plain = f"plain {row['plain_ms']:.3f} ms, " if with_plain else ""
        library = ("none" if row["library_ms"] is None else
                   f"{row['library_ms']:.3f} ms ({row['ms'] / row['library_ms']:.2f}x)")
        print(f"[kernels] flash_attention_fwd b={b} s={s} h={h} kvh={kvh} {dims} bf16 causal, {row['path']} path: "
              f"max_abs_err {err:.3e} (tol {tol:g}), lse err {lse_err:.3e}; kernel {row['ms']:.3f} ms "
              f"({flops / row['ms'] / 1e9:.1f} TFLOP/s, {row['bound_ms'] / row['ms'] * 100:.0f} % of the bound's "
              f"rate), {plain}library (SDPA) {library}, bound {row['bound_ms']:.3f} ms by {row['bound_by']}")
        return row

    # the shape the serving path gives it, then musicgen's heads at the same length,
    # deepseek's MLA pair (its prefill's shape) and stablelm's head dim 80
    serving = at_full_size(BATCH, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, with_plain=True)
    d64 = at_full_size(BATCH, *MUSICGEN_HEADS, with_plain=False)
    m = mla_cfg.mla
    mla = at_full_size(BATCH, mla_cfg.n_heads, mla_cfg.n_kv_heads, m.qk_nope_dim + m.qk_rope_dim,
                       with_plain=True, dv=m.v_head_dim)
    d80 = at_full_size(BATCH, d80_cfg.n_heads, d80_cfg.n_kv_heads, d80_cfg.resolved_head_dim, with_plain=True)
    # before llava and command-r serve: the first groups that do not divide 8 (bands of 2) and
    # that exceed it (bands of 1)
    groups = {c.name: at_full_size(BATCH, c.n_heads, c.n_kv_heads, c.resolved_head_dim, with_plain=False)
              for c in group_cfgs}  # fmt: skip
    keys = ("path", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:126",
        "launches": 0,
        **{key: serving[key] for key in keys},
        "d64": {key: d64[key] for key in ("path", "ms", "library_ms", "bound_ms")},
        # launches: one a layer of a deepseek or a stablelm prefill, filled in by the serving phase
        "mla": {"model": mla_cfg.name, "launches": 0, **{key: mla[key] for key in keys}},
        "d80": {"model": d80_cfg.name, "launches": 0, **{key: d80[key] for key in keys}},
        # by model, the group (q heads a kv head) and the launches of its prefill, filled in by the serving phase
        "groups": {name: {"group": c.n_heads // c.n_kv_heads, "launches": 0, **{key: groups[name][key] for key in keys}}
                   for name, c in zip(groups, group_cfgs)},  # fmt: skip
        "launches_by_model": {},
    }


def check_ssd_kernel(prompt_len: int, cfg) -> dict:
    """Phase 3 for K2, the SSD chunked scan.  Returns its entry of the kernels line."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
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
            form = "f32" if name == "float32" else ssd_kernel.scan_form(
                b, h, s, chunk, p, n, ssd_kernel.cluster_limit(p, n, 0)).name
            print(f"[kernels] ssd_scan_fwd b={b} s={s} h={h} p={p} n={n} chunk={chunk} {name}, {form} form: "
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

    # the shapes the serving path gives it: x, B, C bf16 from the conv, dt f32
    # from the softplus; the batch of prompts (b h = 256 pairs: the sequential
    # form) and one prompt alone (64 pairs: a chunk-parallel form).  Bound and
    # TFLOP/s count the products at the kernel's own tile, the chunk it walks.
    s_cfg = cfg.ssm
    h = s_cfg.expand * cfg.d_model // s_cfg.head_dim
    s, p, n, chunk = prompt_len, s_cfg.head_dim, s_cfg.d_state, min(s_cfg.chunk, prompt_len)
    limit = ssd_kernel.cluster_limit(p, n, 0)

    def at_serving_shape(b):
        form = ssd_kernel.scan_form(b, h, s, chunk, p, n, limit)
        x, dt, A, B, C = inputs(b, s, h, p, n, torch.bfloat16, torch.float32)
        y, st = ssd_scan_fwd(x, dt, A, B, C, chunk=chunk)
        torch.cuda.synchronize()
        ry, rst = ref32(x, dt, A, B, C, chunk)
        scale = ry.abs().max().item()
        err = (y.float() - ry).abs().max().item()
        rel = ((y.float() - ry).abs() / (1 + ry.abs())).max().item()
        floor = (ry.to(torch.bfloat16).float() - ry).abs().max().item()
        st_err = (st - rst).abs().max().item()
        print(f"[kernels] ssd_scan_fwd at the serving shape b={b} s={s} h={h} p={p} n={n} g=1 chunk={chunk} "
              f"(x, B, C bf16, dt f32), form {form.name} (CTAs a (batch, head): {form.cluster}; the card's "
              f"cluster limit {limit}): y max_abs_err {err:.3e} (max |y| {scale:.3f}; rounding y to bf16 alone "
              f"{floor:.3e}), err/(1+|y|) {rel:.3e}, final_state max_abs_err {st_err:.3e} (max |state| "
              f"{rst.abs().max().item():.3f})")
        if not (err <= 3e-2 * max(1.0, scale) and st_err <= 3e-4 * max(1.0, rst.abs().max().item())):
            raise SystemExit(f"ssd_scan_fwd disagrees with ssd_scan_ref at the serving shape b={b}")
        if rel > SSD_TOL["bfloat16"] / 2:
            raise SystemExit(f"ssd_scan_fwd bf16 error {rel} at the serving shape b={b} is above half the tolerance")
        del ry, rst
        ms = time_ms(lambda: ssd_scan_fwd(x, dt, A, B, C, chunk=chunk), iters=20)
        plain_ms = time_ms(lambda: ssd_scan_ref(x, dt, A, B, C, chunk=chunk), iters=3, warmup=1)
        bound_ms, bound_by = ssd_bound(b, s, h, p, n, ssd_kernel.TILE, "bfloat16")
        flops = ssd_flops(b, s, h, p, n, ssd_kernel.TILE)
        print(f"[kernels] ssd_scan_fwd at the serving shape b={b}, form {form.name}: kernel {ms:.3f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s of {flops / 1e9:.1f} GFLOP at the tile of {ssd_kernel.TILE}, "
              f"{bound_ms / ms * 100:.1f} % of the bound's rate), plain {plain_ms:.3f} ms, library none (no "
              f"PyTorch call computes the SSD scan), bound {bound_ms:.4f} ms by {bound_by}")
        return form, err, ms, plain_ms, bound_ms, bound_by

    form, err, ms, plain_ms, bound_ms, bound_by = at_serving_shape(BATCH)
    form1, _, ms1, _, bound1, _ = at_serving_shape(1)

    # jamba's SSD dims (p=64, n=16, 128 heads, chunk 128) at the same request
    b = BATCH
    jh, jp, jn, jchunk = JAMBA_SSD
    jx, jdt, jA, jB, jC = inputs(b, s, jh, jp, jn, torch.bfloat16, torch.float32)
    jy, jst = ssd_scan_fwd(jx, jdt, jA, jB, jC, chunk=jchunk)
    torch.cuda.synchronize()
    jry, jrst = ref32(jx, jdt, jA, jB, jC, jchunk)
    jerr = (jy.float() - jry).abs().max().item()
    if not (jerr <= 3e-2 * max(1.0, jry.abs().max().item())
            and (jst - jrst).abs().max().item() <= 3e-4 * max(1.0, jrst.abs().max().item())):
        raise SystemExit("ssd_scan_fwd disagrees with ssd_scan_ref at jamba's serving shape")
    del jry, jrst
    jform = ssd_kernel.scan_form(b, jh, s, jchunk, jp, jn, ssd_kernel.cluster_limit(jp, jn, 0))
    jms = time_ms(lambda: ssd_scan_fwd(jx, jdt, jA, jB, jC, chunk=jchunk), iters=20)
    jbound, jby = ssd_bound(b, s, jh, jp, jn, ssd_kernel.TILE, "bfloat16")
    print(f"[kernels] ssd_scan_fwd at jamba's dims b={b} s={s} h={jh} p={jp} n={jn} chunk={jchunk}, form "
          f"{jform.name}: y max_abs_err {jerr:.3e}; kernel {jms:.3f} ms, bound {jbound:.4f} ms by {jby} "
          f"({jbound / jms * 100:.1f} % of the bound's rate)")
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
        "form": form.name,
        "form_one_sequence": form1.name,
        "ms_one_sequence": ms1,
        "bound_ms_one_sequence": bound1,
        "launches_one_sequence": 0,
    }


def check_attention_backward(cfg, mla_cfg, d80_cfg) -> dict:
    """Phase 3 for K1's backward kernel (``flash_attention_bwd``) and the
    autograd Function around K1.  The Function's gradients against PyTorch's
    autograd of the plain version on the card, at ``GRAD_LEN`` tokens,
    causal, one backward launch a gradient: bf16 at ``cfg``'s (phi4: 24 / 8
    heads of 128), ``mla_cfg``'s (qk 192, v 128) and ``d80_cfg``'s (32
    heads of 80) head dims, and phi4's in float32.  Then, at b=1,
    ``PROMPT_LEN`` tokens (the training shape) and each of those head dims,
    the kernel against its plain version (``ops.attention_bwd``) on the same
    inputs, and timed in turns with SDPA's backward (a yardstick only) and
    the PyTorch FA-2 backward (``ops.attention_bwd``, the route it
    replaced).  Returns the kernel's entry for the kernels line."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd, flash_attention_fwd, kernel_bwd_path
    from repro_torch.kernels.flash_attention.ops import attention_bwd, flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)
    m = mla_cfg.mla
    dims = {"phi4": (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.resolved_head_dim),
            "mla": (mla_cfg.n_heads, mla_cfg.n_kv_heads, m.qk_nope_dim + m.qk_rope_dim, m.v_head_dim),
            "d80": (d80_cfg.n_heads, d80_cfg.n_kv_heads, d80_cfg.resolved_head_dim, d80_cfg.resolved_head_dim)}

    def draw(b, s, h, kvh, dqk, dv, dtype):
        shapes = ((b, s, h, dqk), (b, s, kvh, dqk), (b, s, kvh, dv), (b, s, h, dv))
        return [torch.randn(sh, generator=gen, device=dev).to(dtype) for sh in shapes]

    def plain(q, k, v):
        return attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=True).transpose(1, 2)

    def grads(fn, inputs, dout):
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        return torch.autograd.grad(fn(*leaves), leaves, dout)

    entry = {"name": "flash_attention_bwd", "route": "cuda",
             "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd.cu",
             "replaces": "src/repro/models/layers/flash_core.py:119 (_bwd; no Pallas original)",
             "launches": 0, "checks": [], "timed": []}  # fmt: skip
    cases = [(name, "bfloat16") for name in dims] + [("phi4", "float32")]
    for name, dtype_name in cases:
        h, kvh, dqk, dv = dims[name]
        dtype = getattr(torch, dtype_name)
        q, k, v, dout = draw(1, GRAD_LEN, h, kvh, dqk, dv, dtype)
        before = flash_attention_bwd.launches
        got = grads(lambda q, k, v: flash_attention(q, k, v, causal=True), (q, k, v), dout)
        if flash_attention_bwd.launches != before + 1:
            raise SystemExit(f"K1's backward at {name} {dtype_name}: {flash_attention_bwd.launches - before} "
                             "kernel launches for one gradient, not 1")
        plain_same = grads(plain, (q, k, v), dout)
        ref = grads(plain, [t.float() for t in (q, k, v)], dout.float())
        torch.cuda.synchronize()
        path = kernel_bwd_path(dtype, dqk, dv)
        row = {"dims": name, "dtype": dtype_name, "h": h, "kvh": kvh, "head_dims": [dqk, dv], "path": path}
        for which, g, pg, r in zip(("dq", "dk", "dv"), got, plain_same, ref):
            scale = r.abs().max().item()
            err = (g.float() - r).abs().max().item()
            plain_err = (pg.float() - r).abs().max().item()
            limit = (GRAD_TOL["float32"] * max(1.0, scale) if dtype_name == "float32"
                     else 1.5 * plain_err + GRAD_TOL["bfloat16"] * max(1.0, scale))
            row[which] = {"max_abs_err": err, "rel_err": err / max(scale, 1e-30), "plain_max_abs_err": plain_err,
                          "limit": limit}  # fmt: skip
            if not (torch.isfinite(g).all() and err <= limit):
                raise SystemExit(f"K1's backward: {which} at {name} {dtype_name} strays from plain autograd by "
                                 f"{err} (limit {limit})")
        print(f"[kernels] flash_attention backward b=1 s={GRAD_LEN} h={h} kvh={kvh} dqk={dqk} dv={dv} {dtype_name} "
              f"causal, {path} kernels (1 launch), against autograd of the plain version in float32: "
              + "; ".join(f"{w} max_abs_err {row[w]['max_abs_err']:.3e} (rel {row[w]['rel_err']:.2e}; plain "
                          f"{dtype_name} path {row[w]['plain_max_abs_err']:.3e}; limit {row[w]['limit']:.3e})"
                          for w in ("dq", "dk", "dv")))
        entry["checks"].append(row)
        del q, k, v, dout, got, plain_same, ref

    tol = BWD_TOL
    for name in dims:
        h, kvh, dqk, dv = dims[name]
        s = PROMPT_LEN
        q, k, v, dout = draw(1, s, h, kvh, dqk, dv, torch.bfloat16)
        qt, kt, vt, dt = (x.transpose(1, 2) for x in (q, k, v, dout))
        out, lse = flash_attention_fwd(qt, kt, vt, causal=True)
        o = out.transpose(1, 2)

        def kernel():
            return flash_attention_bwd(qt, kt, vt, out, lse, dt, causal=True)

        def fa2():
            return attention_bwd(q, k, v, o, lse, dout, causal=True)

        got, want = kernel(), fa2()
        torch.cuda.synchronize()
        errs = {}
        for which, g, w in zip(("dq", "dk", "dv"), got, want):
            errs[which] = (g.transpose(1, 2).float() - w.float()).abs().max().item()
            if not (torch.isfinite(g).all() and errs[which] <= tol * max(1.0, w.float().abs().max().item())):
                raise SystemExit(f"K1's backward kernel: {which} at {name} b=1 s={s} strays from its plain version "
                                 f"by {errs[which]} (tol {tol:g} of the largest entry)")
        del got, want
        qs, ks, vs = (x.detach().clone().requires_grad_(True) for x in (qt, kt, vt))
        try:
            ref_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)

            def sdpa():
                return torch.autograd.grad(ref_out, (qs, ks, vs), dt, retain_graph=True)

            sdpa()
        except RuntimeError as refused:
            print(f"[kernels] SDPA refuses dqk={dqk} dv={dv} with a backward: {str(refused).splitlines()[0]}")
            sdpa = None
        # in turns: kernel, SDPA, FA-2, then the reverse
        runs = [("kernel", kernel, BWD_ITERS), ("sdpa", sdpa, BWD_ITERS), ("fa2", fa2, FA2_ITERS)]
        times = {key: [] for key, _, _ in runs}
        for r in range(BWD_ROUNDS):
            for key, fn, iters in (runs if r % 2 == 0 else runs[::-1]):
                if fn is not None:
                    times[key].append(time_ms(fn, iters=iters, warmup=1))
        bound_ms, bound_by = attention_bwd_bound(1, h, kvh, s, dqk, dv, "bfloat16")
        flops = 2.5 * attention_flops(1, h, s, s, dqk, dv, True)
        ms = min(times["kernel"])
        row = {"dims": name, "b": 1, "s": s, "h": h, "kvh": kvh, "head_dims": [dqk, dv],
               "path": kernel_bwd_path(torch.bfloat16, dqk, dv), "max_abs_err": max(errs.values()),
               "max_abs_err_by_grad": errs, "ms": ms, "ms_turns": times["kernel"],
               "plain_ms": min(times["fa2"]), "plain_ms_turns": times["fa2"],
               "library_ms": min(times["sdpa"]) if times["sdpa"] else None, "library_ms_turns": times["sdpa"],
               "bound_ms": bound_ms, "bound_by": bound_by}  # fmt: skip
        entry["timed"].append(row)
        sdpa_text = ("refused" if not times["sdpa"] else
                     f"{', '.join(f'{x:.3f}' for x in times['sdpa'])} ms (kernel {ms / row['library_ms']:.2f}x)")
        print(f"[kernels] flash_attention_bwd b=1 s={s} h={h} kvh={kvh} dqk={dqk} dv={dv} bf16 causal, {row['path']} "
              f"kernels: against its plain version max_abs_err "
              + ", ".join(f"{w} {e:.3e}" for w, e in errs.items())
              + f" (tol {tol:g} of the largest entry); kernel {', '.join(f'{x:.3f}' for x in times['kernel'])} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s counting 2.5x the forward's products, {bound_ms / ms * 100:.0f} % of "
              f"the bound's rate), PyTorch FA-2 backward {', '.join(f'{x:.3f}' for x in times['fa2'])} ms "
              f"(kernel {row['plain_ms'] / ms:.1f}x faster), SDPA's backward {sdpa_text}, bound {bound_ms:.3f} ms "
              f"by {bound_by} (in turns)")
        del q, k, v, dout, qt, kt, vt, dt, out, lse, o, qs, ks, vs
        if sdpa is not None:
            del ref_out
        torch.cuda.empty_cache()
    # the entry's own figures are the main path's shape: phi4's
    phi4 = entry["timed"][0]
    for key in ("path", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"):
        entry[key] = phi4[key]
    return entry


def check_ssd_backward(cfg) -> dict:
    """Phase 3 for K2's autograd Function: its gradients against PyTorch's
    autograd of the plain version at the same inputs on the card, bf16 at
    ``cfg``'s dims (mamba2: 64 heads of 64, state 128) in the sequential form
    (b=2) and a cluster form (b=1), with an initial state; the backward timed
    at the 4-prompt serving shape.  Returns the entry for the kernels line."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(19)
    s_cfg = cfg.ssm
    h, p, n, chunk = s_cfg.expand * cfg.d_model // s_cfg.head_dim, s_cfg.head_dim, s_cfg.d_state, s_cfg.chunk
    limit = ssd_kernel.cluster_limit(p, n, 0)

    def draw(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def plain(x, dt, A, B, C, *, chunk, initial_state):
        return ssd_scan_ref(x, dt, A, B[:, :, 0], C[:, :, 0], chunk=chunk, initial_state=initial_state)

    def run(scan, inputs):
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        y, final = scan(*leaves[:5], chunk=chunk, initial_state=leaves[5])
        return leaves, (y, final)

    entry = {"route": "pytorch", "source": "src/repro_torch/kernels/ssd_scan/ops.py (ssd_scan_bwd: ssd_chunked "
             "recomputed under autograd)", "checks": []}  # fmt: skip
    for b, s in ((2, 1024), (1, 1024), (BATCH, PROMPT_LEN)):
        form = ssd_kernel.scan_form(b, h, s, chunk, p, n, limit).name
        inputs = (draw(b, s, h, p, scale=0.5, dtype=torch.bfloat16), F.softplus(draw(b, s, h)),
                  -torch.exp(draw(h, scale=0.3)), draw(b, s, 1, n, scale=0.3, dtype=torch.bfloat16),
                  draw(b, s, 1, n, scale=0.3, dtype=torch.bfloat16), draw(b, h, p, n, scale=0.1))  # fmt: skip
        dy, dfinal = draw(b, s, h, p, dtype=torch.bfloat16), draw(b, h, p, n)
        leaves, outs = run(ssd_scan, inputs)
        if s == PROMPT_LEN:  # the serving shape: timed only
            ms = time_ms(lambda: torch.autograd.grad(outs, leaves, (dy, dfinal), retain_graph=True), iters=3,
                         warmup=1)  # fmt: skip
            entry["ms"], entry["timed_at"] = ms, {"b": b, "s": s, "form": form}
            print(f"[kernels] ssd_scan backward at the serving shape b={b} s={s} h={h} p={p} n={n} (form {form} "
                  f"forward): recompute through ssd_chunked + autograd {ms:.3f} ms; library none")
            del leaves, outs
            continue
        got = torch.autograd.grad(outs, leaves, (dy, dfinal))
        pleaves, pouts = run(plain, inputs)
        want = torch.autograd.grad(pouts, pleaves, (dy, dfinal))
        torch.cuda.synchronize()
        errs = {}
        for name, g, w in zip(("x", "dt", "A", "B", "C", "initial_state"), got, want):
            errs[name] = (g.float() - w.float()).abs().max().item()
            if not (torch.isfinite(g).all() and errs[name] <= SSD_GRAD_TOL * max(1.0, w.abs().max().item())):
                raise SystemExit(f"K2's backward: d{name} at b={b} ({form}) strays from plain autograd by {errs[name]}")
        entry["checks"].append({"b": b, "s": s, "form": form, "max_abs_err": errs})
        print(f"[kernels] ssd_scan backward b={b} s={s} h={h} p={p} n={n} bf16 ({form} forward), against autograd "
              f"of the plain version at the same inputs (tol {SSD_GRAD_TOL:g} of the largest entry): "
              + ", ".join(f"d{k} {v:.3e}" for k, v in errs.items()))
        del leaves, outs, got, pleaves, pouts, want
    return entry


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
    cluster_parties, row_cap = scu.cluster_limit(0)

    def barrier_in(form, arrive):
        """K3 on ``arrive``, which must take ``form``; exact against its plain version."""
        n = arrive.shape[0]
        got = scu.barrier_form(n, arrive[0].numel(), cluster_parties, row_cap)
        if got != form:
            raise SystemExit(f"scu_barrier took the {got} form for {tuple(arrive.shape)}, not the {form} form")
        return exact(f"scu_barrier {form} form {tuple(arrive.shape)}", scu.scu_barrier(arrive), barrier_ref(arrive))

    cluster_ns = SCU_CLUSTER_PARTIES + ([9, 16] if cluster_parties >= 16 else [])
    for form, ns in (("cluster", cluster_ns), ("dissemination", SCU_DISSEMINATION_PARTIES + [most])):
        for n in ns:
            for shape in ((n,), (n, 3, 5)):
                barrier_in(form, words(*shape))
    for m, form in ((row_cap - 1, "cluster"), (row_cap + 1, "dissemination")):
        barrier_in(form, words(SWEEP_PARTIES, m))
    try:
        scu.scu_barrier(words(most + 1))
    except ValueError:
        pass
    else:
        raise SystemExit(f"scu_barrier took {most + 1} parties, more than fit on the card at once")
    print(f"[kernels] scu_barrier exact in the cluster form at n = {cluster_ns} (cluster limit {cluster_parties}: "
          f"{'the non-portable 16 taken' if cluster_parties >= 16 else 'the portable 8'}, rows of at most "
          f"{row_cap} words) and the dissemination form at n = {SCU_DISSEMINATION_PARTIES + [most]} (the last the "
          f"largest resident group), words of shape () and (3, 5); at n = {SWEEP_PARTIES} rows of {row_cap - 1} "
          f"(cluster) and {row_cap + 1} words (dissemination)")
    for shape in ((SWEEP_PARTIES, 37), (SWEEP_PARTIES, row_cap + 1), (64,), (64, 40)):
        x = torch.randn(shape, generator=gen, device=dev)
        out = scu.scu_barrier(x)
        torch.cuda.synchronize()
        if not torch.equal(out, out[:1].expand_as(out)):
            raise SystemExit(f"scu_barrier gave the parties different rows at {shape}")
        # the rounding bound of an n-term float32 sum, in any order
        if not ((out - barrier_ref(x)).abs() <= shape[0] * 2.0**-23 * x.abs().sum(0, keepdim=True)).all():
            raise SystemExit(f"scu_barrier strays from its plain version beyond rounding at {shape}")
    print("[kernels] scu_barrier on normal random words: every party's row bitwise the same, in the cluster "
          f"form at ({SWEEP_PARTIES}, 37) and the dissemination form at ({SWEEP_PARTIES}, {row_cap + 1}), (64,) "
          "and (64, 40); within n 2^-23 sum|x| of the plain version")
    batch = words(SCU_BACK_TO_BACK, SWEEP_PARTIES)
    outs = torch.empty_like(batch)
    t0 = time.perf_counter()
    for k in range(SCU_BACK_TO_BACK):
        outs[k] = scu.scu_barrier(batch[k])
    exact("scu_barrier back to back", outs, batch.sum(1, keepdim=True).expand_as(batch))
    print(f"[kernels] scu_barrier {SCU_BACK_TO_BACK} back-to-back launches at n={SWEEP_PARTIES} (cluster form), "
          f"every result exact ({time.perf_counter() - t0:.2f} s on the host clock)")
    small, big = words(SWEEP_PARTIES), words(64)
    outs = [scu.scu_barrier(small if k % 2 == 0 else big) for k in range(SCU_ALTERNATING)]
    for k, out in enumerate(outs):
        exact("scu_barrier alternating forms", out, barrier_ref(small if k % 2 == 0 else big))
    print(f"[kernels] scu_barrier {SCU_ALTERNATING} launches on one stream alternating the cluster form "
          f"(n={SWEEP_PARTIES}) and the dissemination form (n=64), every result exact")

    n = SWEEP_PARTIES
    arrive = torch.ones(n, device=dev)  # the sweep's arrival words
    k3_form = scu.barrier_form(n, 1, cluster_parties, row_cap)
    err3 = exact("scu_barrier at the sweep's shape", scu.scu_barrier(arrive), barrier_ref(arrive))
    k3_ms = time_ms(lambda: scu.scu_barrier(arrive), iters=2000, warmup=20)
    k3_plain = time_ms(lambda: barrier_ref(arrive), iters=2000, warmup=20)
    k3_library = time_ms(lambda: arrive.sum(0, keepdim=True).expand_as(arrive), iters=2000, warmup=20)
    # bytes: the n arrival words read once, the n counts written once; operations: n adds a party
    k3_bound, k3_by = bound(8 * n, n * n, "float32")
    floor = scu.cluster_floor_ms(n, 2)
    print(f"[kernels] scu_barrier at n={n} (one word a party), {k3_form} form: kernel {k3_ms * 1e3:.2f} us a call, "
          f"library (sum + expand) {k3_library * 1e3:.2f} us ({k3_ms / k3_library:.2f}x), plain "
          f"{k3_plain * 1e3:.2f} us, bound {k3_bound * 1e3:.2e} us by {k3_by}; latency floor one launch of a "
          f"cluster of {n} CTAs with two cluster.sync() {floor * 1e3:.2f} us")
    wide = torch.ones(most, device=dev)
    print(f"[kernels] scu_barrier at n={most} (dissemination form): kernel "
          f"{time_ms(lambda: scu.scu_barrier(wide), iters=200, warmup=5) * 1e3:.2f} us a call")

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
    print(f"[kernels] scu_self_signal at the sweep's shape ({n} floats): kernel {k5_ms * 1e3:.2f} us a call, plain "
          f"and library (x + 1) {k5_plain * 1e3:.2f} us ({k5_ms / k5_plain:.2f}x), bound {k5_bound * 1e3:.2e} us "
          f"by {k5_by}")

    source = "src/repro_torch/kernels/scu_barrier/csrc/scu_barrier.cu"
    replaces = "src/repro/kernels/scu_barrier/kernel.py"
    return [
        {"name": "scu_barrier", "route": "cuda", "source": source, "replaces": f"{replaces}:79",
         "launches": 0, "max_abs_err": err3, "ms": k3_ms, "plain_ms": k3_plain, "bound_ms": k3_bound,
         "bound_by": k3_by, "library_ms": k3_library, "form": k3_form},
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
    want = {"flash_attention_fwd": 0, "ssd_scan_fwd": 0, "flash_attention_bwd": 0,
            "scu_barrier": result["passes"] * N_BARRIERS * len(REGION_SIZES),
            "scu_notifier": len(names), "scu_self_signal": len(names)}  # fmt: skip
    if launches != want:
        raise SystemExit(f"[sync] kernel launches in the sweep {launches}, expected {want}")
    print(f"[sync] every party released with {n} under every policy; kernel launches {launches} "
          f"(scu_barrier {N_BARRIERS} a region a pass under the scu policy)")
    return launches


def tcdm_traces(tb_class, n: int) -> list:
    """Small pure-TCDM programs of ``n`` cores with contention on one bank
    (``tests/test_trace.py``'s ``_tcdm_traces``), built with ``tb_class``."""
    out = []
    for cid in range(n):
        tb = tb_class()
        for it in range(3):
            tb.mark()
            tb.compute(2 + cid)
            tb.mem("sw", 0x80 + 4 * cid, 10 * cid + it)
            tb.mem("lw", 0x80 + 4 * ((cid + 1) % n))
            tb.mem("lw", 0x40)  # everyone hits one bank: forced conflicts
        out.append(tb.build(label=f"xp:{cid}"))
    return out


def tas_lock_traces(tb_class) -> list:
    """Four cores contend for one test-and-set lock, hold it 5 cycles and free it."""
    out = []
    for _ in range(4):
        tb = tb_class()
        tb.compute(2)
        tb.poll("tas", 0x40, 0, 1, 2)
        tb.compute(5)
        tb.mem("sw", 0x40, 0)
        out.append(tb.build())
    return out


def same_word_traces(tb_class) -> list:
    """Core 0 stores 7 to a word while three cores load it in the same cycle."""
    out = []
    for cid in range(4):
        tb = tb_class()
        if cid == 0:
            tb.mem("sw", 0x40, 7)
        else:
            tb.mem("lw", 0x40)
        out.append(tb.build())
    return out


def relocated_address(addr: int, cluster: int, n_clusters: int, banks: int) -> int:
    """Where word ``w = addr >> 2`` of a cluster of ``banks`` banks lies when the
    cluster is number ``cluster`` of ``n_clusters``, each on its own banks:
    ``(w // banks) * banks * n_clusters + banks * cluster + w % banks``.  In a
    run over ``banks * n_clusters`` banks each word keeps its bank within the
    cluster, and each bank its round-robin order, so the clusters run as they
    would alone."""
    w = addr >> 2
    return ((w // banks) * banks * n_clusters + banks * cluster + w % banks) << 2 | (addr & 3)


def relocate_cluster(programs, cluster: int, n_clusters: int, banks: int) -> list:
    """One cluster's programs with every address moved by :func:`relocated_address`;
    new programs, of the input's class."""
    from repro_torch.core.scu.trace import T_MEM, T_POLL

    moved = {}
    for p in programs:
        for r in p.rows:
            if r[0] in (T_MEM, T_POLL) and r[3] not in moved:
                moved[r[3]] = relocated_address(r[3], cluster, n_clusters, banks)
    return [type(p)(rows=tuple(r[:3] + (moved[r[3]],) + r[4:] if r[0] in (T_MEM, T_POLL) else r for r in p.rows),
                    label=f"{p.label}@{cluster}")
            for p in programs]  # fmt: skip


def same_trace_result(a: dict, b: dict) -> bool:
    """Two executor results equal on every field, bit for bit."""
    import numpy as np

    return (a["cycles"] == b["cycles"] and a["bank_conflicts"] == b["bank_conflicts"] and a["tcdm"] == b["tcdm"]
            and np.array_equal(a["finished_at"], b["finished_at"])
            and all(np.array_equal(a["counters"][k], b["counters"][k]) for k in a["counters"]))  # fmt: skip


def trace_parity_programs() -> dict:
    """The parity programs of the trace phase: name -> (a fresh program list, n_banks)."""
    from repro_torch.core.scu.programs import trace_barrier_programs, trace_chain_programs, trace_mutex_programs
    from repro_torch.core.scu.trace import TraceBuilder

    cases = {f"tcdm x{n}": (lambda n=n: tcdm_traces(TraceBuilder, n), 2 * n) for n in (4, 8, 64)}
    cases["contended tas lock x4"] = (lambda: tas_lock_traces(TraceBuilder), 8)
    cases["same-word store and loads x4"] = (lambda: same_word_traces(TraceBuilder), 8)
    for v in ("sw", "tree", "tree4"):
        cases[f"{v} barrier x8"] = (lambda v=v: trace_barrier_programs(v, 8, sfr=7, iters=6), 16)
    cases["sw mutex x8"] = (lambda: trace_mutex_programs("sw", 8, t_crit=3, iters=4), 16)
    for v in ("sw", "tree", "tree4"):
        cases[f"{v} chain x8"] = (lambda v=v: trace_chain_programs(v, 8, sfr=7, iters=6), 16)
    cases["sw barrier x64, 1 iteration"] = (lambda: trace_barrier_programs("sw", 64, sfr=7, iters=1), 128)
    return cases


def trace_batch(card: str) -> dict:
    """The trace phase: the trace executor on the card against its CPU run, and
    the paper's software barrier as TRACE_CLUSTERS eight-core clusters in one call."""
    import numpy as np
    import torch

    from repro_torch.core.scu.programs import trace_barrier_programs
    from repro_torch.core.scu.trace_exec import BLOCK_CYCLES, run_traces_torch

    t_phase = time.perf_counter()
    # (a) parity: the card against the CPU on every field, bit for bit
    for name, (make, n_banks) in trace_parity_programs().items():
        cpu = run_traces_torch(make(), n_banks=n_banks, device="cpu")
        gpu = run_traces_torch(make(), n_banks=n_banks)
        if not same_trace_result(gpu, cpu):
            raise SystemExit(f"[trace] {name}: the card's result differs from the CPU's")
        print(f"[trace] {name}: card = CPU on every field ({cpu['cycles']} cycles, "
              f"{cpu['bank_conflicts']} bank conflicts)")
    make, n_banks = trace_parity_programs()["sw barrier x8"]
    one = run_traces_torch(make(), n_banks=n_banks, block_cycles=1)
    if not same_trace_result(one, run_traces_torch(make(), n_banks=n_banks)):
        raise SystemExit("[trace] sw barrier x8: K = 1 and the default K differ on the card")
    print(f"[trace] sw barrier x8 on the card: K = 1 and K = {BLOCK_CYCLES} give the same result")

    # (b) the software baseline across the card
    n_clusters, cores, banks = TRACE_CLUSTERS, TRACE_CORES, TRACE_BANKS
    sfrs = TRACE_SFRS
    iters = {sfr: TRACE_CUT_ITERS.get(sfr, TRACE_ITERS) for sfr in sfrs}
    t0 = time.perf_counter()
    templates = {sfr: trace_barrier_programs("sw", cores, sfr=sfr, iters=iters[sfr]) for sfr in sfrs}
    programs = [p for c in range(n_clusters)
                for p in relocate_cluster(templates[sfrs[c % len(sfrs)]], c, n_clusters, banks)]  # fmt: skip
    build_s = time.perf_counter() - t0
    stats = {}
    t0 = time.perf_counter()
    got = run_traces_torch(programs, n_banks=banks * n_clusters, stats=stats)
    call_s = time.perf_counter() - t0
    lanes = n_clusters * cores
    cnt = np.stack([got["counters"][k] for k in got["counters"]]).reshape(-1, n_clusters, cores)
    fin = got["finished_at"].reshape(n_clusters, cores)
    alone, cpu_s, cpu_cycles, conflicts = {}, 0.0, 0, 0
    for i, sfr in enumerate(sfrs):
        cst = {}
        ref = run_traces_torch(trace_barrier_programs("sw", cores, sfr=sfr, iters=iters[sfr]), n_banks=banks,
                               device="cpu", stats=cst)  # fmt: skip
        alone[sfr] = ref
        cpu_s += cst["run_s"]
        cpu_cycles += ref["cycles"]
        mine = cnt[:, i::len(sfrs)]
        ref_cnt = np.stack([ref["counters"][k] for k in ref["counters"]])
        if not (mine == mine[:, :1]).all():
            raise SystemExit(f"[trace] SFR {sfr}: the clusters' counters differ")
        if not (np.array_equal(mine[:, 0], ref_cnt) and np.array_equal(fin[i], ref["finished_at"])):
            raise SystemExit(f"[trace] SFR {sfr}: cluster {i} differs from the cluster run alone on the CPU")
        if (fin[i::len(sfrs)] != ref["finished_at"]).any():
            raise SystemExit(f"[trace] SFR {sfr}: a cluster finished otherwise than the cluster run alone")
        if fin[i].max() + 1 != ref["cycles"]:
            raise SystemExit(f"[trace] SFR {sfr}: the cluster's last core finished at {fin[i].max()}, "
                             f"the run alone took {ref['cycles']} cycles")
        for c in range(i, n_clusters, len(sfrs)):
            if any(got["tcdm"][relocated_address(a, c, n_clusters, banks)] != v for a, v in ref["tcdm"].items()):
                raise SystemExit(f"[trace] SFR {sfr}: cluster {c}'s words differ from the cluster run alone")
        conflicts += len(range(i, n_clusters, len(sfrs))) * ref["bank_conflicts"]
    if got["bank_conflicts"] != conflicts or got["cycles"] != max(r["cycles"] for r in alone.values()):
        raise SystemExit(f"[trace] the batch's bank conflicts {got['bank_conflicts']} and cycles {got['cycles']}, "
                         f"the clusters alone {conflicts} and {max(r['cycles'] for r in alone.values())}")
    print(f"[trace] {n_clusters} clusters of {cores} cores ({lanes} lanes, {banks * n_clusters} banks), "
          f"the sw barrier {TRACE_ITERS} times a core after an SFR of {list(sfrs)} cluster by cluster ("
          + ", ".join(f"SFR {sfr} cut to {k}" for sfr, k in TRACE_CUT_ITERS.items())
          + ", to keep the phase under 60 s), in one call: "
          f"every cluster of an SFR has the same counters, finish cycles and words as that cluster run "
          f"alone on the CPU; bank conflicts {got['bank_conflicts']} = the clusters' sum; {got['cycles']} cycles = the "
          f"longest cluster's")
    print(f"[trace] {card}: SFR, barriers a core, cycles alone, cycles an iteration, cycles a barrier, "
          f"overhead 1 - SFR x barriers / cycles:")
    for sfr, ref in alone.items():
        k = iters[sfr]
        print(f"[trace]   {sfr:5d} {k:3d} {ref['cycles']:7d} {ref['cycles'] / k:9.1f} {ref['cycles'] / k - sfr:8.1f} "
              f"{1 - sfr * k / ref['cycles']:7.3f}")
    run_s = stats["run_s"]
    print(f"[trace] {card}: {got['cycles'] / run_s:,.0f} simulated cycles/s, {lanes * got['cycles'] / run_s:,.0f} "
          f"lane-cycles/s ({run_s:.3f} s for {got['cycles']} cycles); {run_s / stats['replays'] * 1e3:.3f} ms a "
          f"replay of K = {stats['block_cycles']} cycles ({run_s / got['cycles'] * 1e6:.1f} us a cycle), "
          f"{stats['replays']} replays and as many host syncs; capture {stats['capture_s']:.2f} s; "
          f"{stats['depth']} fetch passes a cycle; programs built and relocated in {build_s:.1f} s, the call "
          f"{call_s:.1f} s")
    print(f"[trace] the CPU at 8 lanes: {cpu_s / cpu_cycles * 1e6:.1f} us a cycle ({cpu_cycles} cycles, "
          f"{cpu_s:.1f} s); the card at {lanes} lanes: {run_s / got['cycles'] * 1e6:.1f} us a cycle")
    phase_s = time.perf_counter() - t_phase
    print(f"[trace] phase {phase_s:.1f} s")
    return {"lanes": lanes, "cycles": got["cycles"], "run_s": run_s, "phase_s": phase_s}


def plain_attention():
    """Within the block, the models' attention (GQA and MLA) goes through its plain version."""
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
def plain_hybrid():
    """Both of the above: jamba's attention and SSD layers."""
    with plain_attention(), plain_ssd_scan():
        yield


@contextlib.contextmanager
def _swapped(module, name, replacement):
    kept = getattr(module, name)
    setattr(module, name, replacement)
    try:
        yield
    finally:
        setattr(module, name, kept)


def recorded_routing(into: list):
    """Within the block, every MoE layer appends its (T, K) expert ids, sorted per token, to ``into``."""
    from repro_torch.models.layers import moe as moe_mod

    kept = moe_mod.router_topk

    def record(logits, m):
        weights, idx = kept(logits, m)
        into.append(idx.sort(dim=-1).values)
        return weights, idx

    return _swapped(moe_mod, "router_topk", record)


def pinned_routing(idx_list: list):
    """Within the block, the MoE layers take, in their order, the expert ids
    of ``idx_list`` ((T, K) each), with their router's own weights for them."""
    import torch

    from repro_torch.models.layers import moe as moe_mod

    pinned_ids = iter(idx_list)

    def pinned(logits, m):
        idx = next(pinned_ids)
        weights = torch.softmax(logits.float(), dim=-1).gather(-1, idx)
        if m.router_norm_topk:
            weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
        return weights, idx

    return _swapped(moe_mod, "router_topk", pinned)


def routing_gap(a: list, b: list) -> str:
    """How many (token, layer) routings of two runs differ, of how many."""
    if not a:
        return "no MoE layer"
    differ = sum(int((x != y).any(-1).sum()) for x, y in zip(a, b))
    return f"{differ} of {sum(x.shape[0] for x in a)} token-layer top-k sets differ"


def ample_capacity(model):
    """The same weights (shared, not copied) with ``capacity_factor =
    n_experts / top_k``, so that no MoE slot is dropped; the model itself for
    an arch without MoE."""
    from repro_torch.serve.decode import CausalLM

    m = model.cfg.moe
    if m is None:
        return model
    cfg = dataclasses.replace(model.cfg, moe=dataclasses.replace(m, capacity_factor=m.n_experts / m.top_k))
    return CausalLM(cfg, model.params)


def check_model_against_plain(model, batch: int, plain, max_stray, step_len: int, s: int = 512,
                              offload: bool = False) -> None:
    """The kernel path against the plain path and a float32 model at a prompt
    the plain version fits (``s``), and prefill(``step_len``) + staged cache +
    one decode step against a prefill of one more token, on the card.

    ``max_stray``, when given, also bounds the bf16 kernel path's distance
    from the float32 model by that share of the largest logit.  A MoE arch's
    step-against-longer runs with ample capacity (``ample_capacity``): the
    capacity depends on the token count, so prefill(n) + one step and
    prefill(n + 1) may drop different slots under the reference's own
    semantics; the other checks keep the config's capacity.  There the new
    token's routing in the decode step is pinned to the one the longer
    prefill gave it: its attention output differs from the prefill's by the
    rounding of another order of sums (MLA's absorbed decode, plain PyTorch
    against the kernel), which flips near-tie top-k choices; the flips are
    counted and the unpinned error printed beside the held one.  ``offload``
    moves the bf16 model to the host while its float32 copy is on the card.
    An arch whose frontend is a stub (musicgen, llava) is prefilled with the
    embedding table's rows of the same tokens, the embeddings its decode step
    takes for a token, so that prefill(n) + one step and prefill(n + 1) see
    the same inputs.
    """
    import torch

    from repro_torch.launch.serve import stage_prefill_cache
    from repro_torch.serve.decode import CausalLM
    from repro_torch.train.optimizer import tree_map

    cfg = model.cfg
    dev = model.device
    gen = torch.Generator(device=dev).manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (batch, s + 1), generator=gen, device=dev)

    def prompt(m, upto):
        if cfg.frontend is None:
            return {"tokens": tokens[:, :upto]}
        return {"embeddings": m.params["embed"]["table"][tokens[:, :upto]]}

    routes = {"kernel": [], "plain": [], "float32": []}
    with recorded_routing(routes["kernel"]):
        logits, cache = model.prefill(prompt(model, s))
    with plain(), recorded_routing(routes["plain"]):
        plain_logits, plain_cache = model.prefill(prompt(model, s))
    name, first = next((k, v) for k, v in cache["blocks"]["pos_0"].items())
    leaf_err = (first[-1].float() - plain_cache["blocks"]["pos_0"][name][-1].float()).abs().max().item()
    del cache, plain_cache

    # prefill n tokens, stage, decode token n + 1  ==  prefill of n + 1 tokens
    n = step_len
    ample = "" if cfg.moe is None else f", capacity factor {cfg.moe.n_experts / cfg.moe.top_k:g} (none dropped)"

    def step_against_longer(m):
        """(decode step logits, longer prefill logits, what was pinned)."""
        longer_routes, free_routes = [], []
        with recorded_routing(longer_routes):
            longer = m.prefill(prompt(m, n + 1))[0]
        small = m.prefill(prompt(m, n))[1]
        position = torch.full((batch,), n, dtype=torch.int32, device=m.device)

        def step():  # on a cache staged afresh: a step advances an SSD layer's state
            big = stage_prefill_cache(small, m.init_cache(batch, n + 8), n)
            return m.decode_step(big, tokens[:, n : n + 1], position)[1]

        with recorded_routing(free_routes):
            free = step()
        if not longer_routes:
            return free, longer, ""
        last = [r.view(batch, n + 1, -1)[:, -1] for r in longer_routes]  # the new token's
        with pinned_routing(last):
            pinned = step()
        return pinned, longer, (f"; the new token's routing pinned to the longer prefill's (unpinned: "
                                f"{routing_gap(free_routes, last)}, max_abs_err "
                                f"{(free - longer).abs().max().item():.3e})")

    step_logits, longer_logits, pinned = step_against_longer(ample_capacity(model))
    err = (step_logits - longer_logits).abs().max().item()
    print(f"[serve] {cfg.name} prefill({n}) + staged cache + one decode step vs prefill({n + 1}){ample}: "
          f"max_abs_err {err:.3e}{pinned}")
    # two bf16 paths again (the decode step is plain PyTorch, the prefill the kernel)
    if not err <= 5e-2 * max(1.0, longer_logits.abs().max().item()):
        raise SystemExit(f"{cfg.name}: decode against the staged prefill cache disagrees with a longer prefill")

    # the yardstick for both paths: the same weights in float32 through the plain version
    if offload:
        model.to("cpu")
        torch.cuda.empty_cache()
    model32 = CausalLM(dataclasses.replace(cfg, dtype="float32"),
                       tree_map(lambda t: t.to(dev, torch.float32), model.params))
    with plain(), recorded_routing(routes["float32"]):
        true_logits, _ = model32.prefill(prompt(model32, s))
    err = (logits - plain_logits).abs().max().item()
    err_kernel = (logits - true_logits).abs().max().item()
    err_plain = (plain_logits - true_logits).abs().max().item()
    scale = true_logits.abs().max().item()
    print(f"[serve] {cfg.name} ({cfg.n_layers} layers) prefill({batch}x{s}) last logits (largest {scale:.2f}): "
          f"kernel path vs plain {err:.3e}; against the float32 model through the plain version: bf16 kernel "
          f"path {err_kernel:.3e}, bf16 plain path {err_plain:.3e}; last layer's cached {name}, kernel vs plain: "
          f"{leaf_err:.3e}")
    if cfg.moe is not None:
        print(f"[serve] {cfg.name} routing on that prompt (capacity factor {cfg.moe.capacity_factor:g}): "
              f"bf16 kernel path vs bf16 plain path: {routing_gap(routes['kernel'], routes['plain'])}; "
              f"bf16 kernel path vs float32: {routing_gap(routes['kernel'], routes['float32'])}; "
              f"bf16 plain path vs float32: {routing_gap(routes['plain'], routes['float32'])}")
    # many layers of bf16 activations: the two bf16 paths round at different
    # places, so each is held to the float32 model, and the kernel path may
    # not stray further from it than the plain bf16 path does (x1.5 for the
    # spread between two draws of rounding noise)
    if not err_kernel <= 1.5 * err_plain + 1e-2:
        raise SystemExit(f"{cfg.name}: the kernel path strays further from float32 than the plain path")
    if max_stray is not None and not err_kernel <= max_stray * max(1.0, scale):
        raise SystemExit(f"{cfg.name}: the kernel path strays from the float32 model by {err_kernel}")

    # the same in float32 through the kernels, where the staged cache must be exact
    step32, longer32, pinned = step_against_longer(ample_capacity(model32))
    with plain():
        plain32 = ample_capacity(model32).prefill(prompt(model32, n + 1))[0]
    e32 = (step32 - longer32).abs().max().item()
    e_plain = (longer32 - plain32).abs().max().item()
    print(f"[serve] {cfg.name} float32 through the kernels: prefill({n}) + staged cache + one decode step vs "
          f"prefill({n + 1}){ample} {e32:.3e}{pinned}; prefill({n + 1}) against the plain version {e_plain:.3e}")
    if not (e32 <= 1e-3 * max(1.0, scale) and e_plain <= 1e-3 * max(1.0, scale)):
        raise SystemExit(f"{cfg.name}: the float32 kernel path disagrees")
    del model32
    torch.cuda.empty_cache()
    if offload:
        model.to(dev)


def expected_launches(cfg) -> dict:
    """K1 once a prefill for each attention layer, K2 for each SSD layer; no
    backward."""
    attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))
    return {"flash_attention_fwd": attn, "ssd_scan_fwd": cfg.n_layers - attn, "flash_attention_bwd": 0}


@contextlib.contextmanager
def graph_only(captured: list):
    """Within the block the launchers decode through the captured graph and
    nothing else: the eager step refuses to be made, and every captured step
    is appended to ``captured`` (its ``replays`` count the graph's launches)."""
    from repro_torch.launch import serve as serve_mod

    kept = serve_mod.capture_serve_step

    def refused(*args):
        raise SystemExit("a launcher made the eager decode step on the card")

    def counted(*args):
        step = kept(*args)
        captured.append(step)
        return step

    with _swapped(serve_mod, "EagerServeStep", refused), _swapped(serve_mod, "capture_serve_step", counted):
        yield


def eager_launchers():
    """Within the block the launchers decode with the eager step on the card:
    the yardstick the graph is held to."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.serve.decode import EagerServeStep

    return _swapped(serve_mod, "capture_serve_step", EagerServeStep)


def graph_against_eager(model, inputs) -> dict:
    """The decode graph against the eager step on one served request: its
    staged cache in two copies, ``GEN`` steps of each from the prefill's
    token, tokens equal at every step and the logits' largest gap within the
    serving tolerance (5e-2 of the largest logit; 0 where the same kernels
    run).  Then ms a step of each (host clock around ``GEN`` steps and a
    synchronise) in turns (eager, graph, graph, eager), one profiled step of
    each (device busy and idle share, as ``scripts/profile_serve_torch.py``
    reads them), the peak device memory of each run (both caches live) and
    the capture's seconds."""
    import torch

    from repro_torch.launch.serve import stage_prefill_cache
    from repro_torch.serve.decode import capture_serve_step
    from repro_torch.train.optimizer import tree_map

    cfg, dev = model.cfg, model.device
    batch, prompt_len = next(iter(inputs.values())).shape[:2]
    logits, small = model.prefill(inputs)
    first = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    eager_cache = stage_prefill_cache(small, model.init_cache(batch, prompt_len + GEN), prompt_len)
    del logits, small
    graph_cache = tree_map(torch.clone, eager_cache)
    start = torch.full((batch,), prompt_len, dtype=torch.int32, device=dev)

    def eager(keep=None):
        tok = first
        for i in range(GEN):
            next_tok, step_logits, _ = model.decode_step(eager_cache, tok, start + i)
            tok = next_tok[:, None]
            if keep is not None:
                keep.append((next_tok, step_logits))

    def graph(keep=None):
        step.feed(first, start)
        for _ in range(GEN):
            next_tok, step_logits = step.replay()
            if keep is not None:
                keep.append((next_tok.clone(), step_logits.clone()))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    by_eager = []
    eager(by_eager)
    torch.cuda.synchronize()
    eager_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step = capture_serve_step(cfg, model.params, graph_cache, batch)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    by_graph = []
    graph(by_graph)
    torch.cuda.synchronize()
    graph_peak = torch.cuda.max_memory_allocated() / 2**30
    if step.replays != GEN:
        raise SystemExit(f"{cfg.name}: the graph was replayed {step.replays} times for {GEN} steps")

    differ = [i for i, (e, g) in enumerate(zip(by_eager, by_graph)) if not torch.equal(e[0], g[0])]
    gap = max((e[1] - g[1]).abs().max().item() for e, g in zip(by_eager, by_graph))
    bitwise = all(torch.equal(e[1], g[1]) for e, g in zip(by_eager, by_graph))
    scale = max(e[1].abs().max().item() for e in by_eager)
    tol = 5e-2 * max(1.0, scale)
    finite = all(torch.isfinite(g[1]).all() for g in by_graph)
    print(f"[graph] {cfg.name} {GEN} decode steps from the staged cache, graph vs eager: tokens equal at "
          f"{GEN - len(differ)} of {GEN} steps, logits' largest gap {gap:.3e} (bit for bit: {bitwise}; tol "
          f"{tol:.3e}, 5e-2 of the largest logit {scale:.2f}); capture {capture_s:.2f} s")
    if differ or gap > tol or not finite:
        raise SystemExit(f"{cfg.name}: the decode graph disagrees with the eager step (steps {differ}, gap {gap})")
    del by_eager, by_graph

    def per_step_ms(run):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / GEN * 1e3

    ms = {"eager": [], "graph": []}
    for name in ("eager", "graph", "graph", "eager"):
        ms[name].append(per_step_ms(eager if name == "eager" else graph))
    _, e_wall, e_busy, _ = _profiled(lambda: model.decode_step(eager_cache, first, start))
    step.feed(first, start)
    _, g_wall, g_busy, g_kernels = _profiled(step.replay)
    e_idle, g_idle = max(0.0, 1 - e_busy / e_wall), max(0.0, 1 - g_busy / g_wall)
    # the same busy time against the unprofiled ms a step: the profiler's own start and stop
    # weigh on one replay's wall
    g_idle_steady = max(0.0, 1 - g_busy / min(ms["graph"]))
    groups = {}
    for name, kernel_ms, _ in g_kernels:
        groups[kernel_group(name)] = groups.get(kernel_group(name), 0.0) + kernel_ms
    print(f"[graph] {cfg.name} ms a step (host clock, {GEN} steps, in turns eager, graph, graph, eager): eager "
          f"{[round(t, 2) for t in ms['eager']]}, graph {[round(t, 2) for t in ms['graph']]}; one profiled step: "
          f"eager wall {e_wall:.2f} ms, device busy {e_busy:.2f} ms, idle {e_idle:.2f}; graph wall {g_wall:.2f} ms, "
          f"device busy {g_busy:.2f} ms ({len(g_kernels)} kernels by name), idle {g_idle:.2f} (against the "
          f"unprofiled ms a step: {g_idle_steady:.2f}); peak device memory eager {eager_peak:.2f} GiB, graph "
          f"{graph_peak:.2f} GiB (both caches live)")
    print(f"[graph] {cfg.name} the graph's step by kernel group, device ms: "
          + ", ".join(f"{group} {t:.2f}" for group, t in sorted(groups.items(), key=lambda kv: -kv[1]))
          + "; largest: " + "; ".join(f"{t:.2f} ms x{n} {name[:60]}" for name, t, n in g_kernels[:3]))
    del step, eager_cache, graph_cache
    torch.cuda.empty_cache()
    return {"eager_ms": ms["eager"], "graph_ms": ms["graph"], "eager_idle": e_idle, "graph_idle": g_idle,
            "eager_busy_ms": e_busy, "graph_busy_ms": g_busy, "graph_idle_steady": g_idle_steady,
            "max_logit_gap": gap, "bitwise": bitwise,
            "eager_peak_gib": eager_peak, "graph_peak_gib": graph_peak, "capture_s": capture_s}  # fmt: skip


def serve_at_full_width(cfg, counters, plain, max_stray, step_len: int, one_sequence=None,
                        check_layers=None, offload=False) -> tuple:
    """Phase 4 for one model: returns the kernels' launches in its served
    request and its decode graph's numbers (``graph_against_eager``).

    The checks against the plain path and a float32 model run on the served
    model's first ``check_layers`` layers (all of them where None), moved to
    the host while its float32 copy is on the card where ``offload`` says.
    A cut is drawn alone, before the served model: ``init_lm`` draws group by
    group from one generator, so its weights are the served model's first
    layers.  The served request decodes through the graph and nothing else
    (``graph_only``).  ``one_sequence``, where given, is then called with the
    model."""
    import torch

    from repro_torch.launch.serve import make_inputs, serve
    from repro_torch.models.lm import init_lm
    from repro_torch.serve.decode import CausalLM

    dev = torch.device("cuda")

    def draw(c):
        return CausalLM(c, init_lm(torch.Generator(device=dev).manual_seed(0), c, torch.bfloat16))

    if check_layers is not None and check_layers != cfg.n_layers:
        print(f"[serve] {cfg.name}: the checks against the plain path and the float32 model run on its first "
              f"{check_layers} layers at full width (a float32 copy of all {cfg.n_layers} does not fit beside "
              "the bf16 model), drawn alone before it from its seed")
        check_model_against_plain(draw(dataclasses.replace(cfg, n_layers=check_layers)), BATCH, plain, max_stray,
                                  step_len, offload=offload)  # fmt: skip
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = draw(cfg)
    n_params = sum(t.numel() for t in model.buffers())
    torch.cuda.synchronize()
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, vocab {cfg.vocab_size}, "
          f"{n_params / 1e9:.2f} B parameters in bf16, drawn on the card in {time.perf_counter() - t0:.1f} s")
    if check_layers is None or check_layers == cfg.n_layers:
        check_model_against_plain(model, BATCH, plain, max_stray, step_len, offload=offload)

    inputs = make_inputs(cfg, BATCH, PROMPT_LEN, torch.Generator(device=dev).manual_seed(1))
    torch.cuda.reset_peak_memory_stats()
    for counted in counters.values():
        counted.launches = 0
    captured = []
    with graph_only(captured):
        result = serve(model, inputs, GEN)
    launches = {name: counted.launches for name, counted in counters.items()}
    want = expected_launches(cfg)
    if {name: launches[name] for name in want} != want:
        raise SystemExit(f"{cfg.name}: prefill launched {launches}, not once per layer of each kind ({want})")
    if [step.replays for step in captured] != [GEN]:
        raise SystemExit(f"{cfg.name}: serve replayed {[step.replays for step in captured]} graphs, "
                         f"not one {GEN} times")
    del captured
    if result["prefill_logits"].shape != (BATCH, cfg.vocab_size) or result["tokens"].shape != (BATCH, GEN + 1):
        raise SystemExit(f"{cfg.name}: serve returned the wrong shapes")
    if not (torch.isfinite(result["prefill_logits"]).all() and torch.isfinite(result["last_logits"]).all()):
        raise SystemExit(f"{cfg.name}: serve produced logits that are not finite")
    if not ((result["tokens"] >= 0) & (result["tokens"] < cfg.vocab_size)).all():
        raise SystemExit(f"{cfg.name}: serve produced token ids outside the vocabulary")
    tokens_in = BATCH * PROMPT_LEN
    print(f"[serve] {cfg.name} prefill {result['prefill_s'] * 1e3:.1f} ms ({tokens_in / result['prefill_s']:.0f} tok/s), "
          f"decode through one CUDA graph (captured in {result['capture_s']:.2f} s) "
          f"{result['decode_s'] / GEN * 1e3:.2f} ms/step ({GEN * BATCH / result['decode_s']:.1f} tok/s), "
          f"kernel launches {launches}, peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del result
    graph = graph_against_eager(model, inputs)
    if one_sequence is not None:
        one_sequence(model)
    del model
    torch.cuda.empty_cache()
    return launches, graph


def serve_one_sequence(model, cfg, counters, entry) -> None:
    """mamba2 answering one prompt of PROMPT_LEN alone, as a latency-bound
    server does: 64 (batch, head) pairs, so K2 takes a chunk-parallel form.
    Served once with the counts set to 0 just before and read just after;
    then its prefill is timed in turns with the sequential form, which
    ``scan_form`` gives a card without cluster launch (a cluster limit of 1)."""
    import torch

    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.launch.serve import make_inputs, serve

    s_cfg = cfg.ssm
    h, p, n = s_cfg.expand * cfg.d_model // s_cfg.head_dim, s_cfg.head_dim, s_cfg.d_state
    form = ssd_kernel.scan_form(1, h, PROMPT_LEN, s_cfg.chunk, p, n, ssd_kernel.cluster_limit(p, n, 0))
    if form.cluster == 1:
        raise SystemExit(f"{cfg.name}: one prompt of {PROMPT_LEN} takes the sequential form on this card")
    inputs = make_inputs(cfg, 1, PROMPT_LEN, torch.Generator(device=model.device).manual_seed(2))
    for counted in counters.values():
        counted.launches = 0
    with graph_only([]):
        result = serve(model, inputs, GEN)
    launches = {name: counted.launches for name, counted in counters.items()}
    if launches["ssd_scan_fwd"] != cfg.n_layers:
        raise SystemExit(f"{cfg.name}: one prompt launched ssd_scan_fwd {launches['ssd_scan_fwd']} times, "
                         f"not once per layer ({cfg.n_layers})")
    if result["prefill_logits"].shape != (1, cfg.vocab_size) or result["tokens"].shape != (1, GEN + 1):
        raise SystemExit(f"{cfg.name}: serve returned the wrong shapes for one prompt")
    if not (torch.isfinite(result["prefill_logits"]).all() and torch.isfinite(result["last_logits"]).all()):
        raise SystemExit(f"{cfg.name}: serve produced logits that are not finite for one prompt")
    if not ((result["tokens"] >= 0) & (result["tokens"] < cfg.vocab_size)).all():
        raise SystemExit(f"{cfg.name}: serve produced token ids outside the vocabulary for one prompt")
    print(f"[serve] {cfg.name} one prompt of {PROMPT_LEN}, K2 form {form.name}: prefill "
          f"{result['prefill_s'] * 1e3:.1f} ms ({PROMPT_LEN / result['prefill_s']:.0f} tok/s), decode "
          f"{result['decode_s'] / GEN * 1e3:.2f} ms/step, kernel launches {launches}")
    entry["launches_one_sequence"] = launches["ssd_scan_fwd"]

    def prefill():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = model.prefill(inputs)[0]
        torch.cuda.synchronize()
        return time.perf_counter() - t0, logits

    def sequential():
        return _swapped(ssd_kernel, "cluster_limit", lambda p, n, device_index: 1)

    # ONE_SEQUENCE_PAIRS pairs, each form first in every other pair
    times, last = {form.name: [], "sequential": []}, {}
    for i in range(ONE_SEQUENCE_PAIRS):
        for name in (form.name, "sequential")[:: 1 if i % 2 == 0 else -1]:
            with sequential() if name == "sequential" else contextlib.nullcontext():
                seconds, logits = prefill()
            times[name].append(seconds * 1e3)
            if not torch.isfinite(logits).all():
                raise SystemExit(f"{cfg.name}: the {name} form's prefill of one prompt is not finite")
            last[name] = logits
    gap = (last[form.name] - last["sequential"]).abs().max().item()
    wins = sum(a < b for a, b in zip(times[form.name], times["sequential"]))

    def quartiles(ms):
        q = torch.tensor(ms).quantile(torch.tensor([0.25, 0.5, 0.75])).tolist()
        return f"median {q[1]:.2f} ms (quartiles {q[0]:.2f}-{q[2]:.2f})"

    print(f"[serve] {cfg.name} prefill of one prompt of {PROMPT_LEN}, {ONE_SEQUENCE_PAIRS} pairs in turns: "
          f"{form.name} {quartiles(times[form.name])}, sequential {quartiles(times['sequential'])}; "
          f"{form.name} faster in {wins} of {ONE_SEQUENCE_PAIRS} pairs; last logits, the two forms apart by {gap:.3e}")
    print(f"[serve] {cfg.name} one-prompt prefill ms, {form.name}: {[round(t, 2) for t in times[form.name]]}, "
          f"sequential: {[round(t, 2) for t in times['sequential']]}")


def serve_a_stream(cfg, counters) -> dict:
    """The ``[batch]`` phase: ``serve_stream`` on ``cfg`` whole, a stream of
    ``STREAM_REQUESTS`` requests from seed ``STREAM_SEED`` over
    ``STREAM_SLOTS`` slots, decoded through the graph (and nothing else),
    then the same stream through the eager step.  Checks that every request
    finishes with its ``max_new_tokens`` tokens, that the two runs' tokens
    are equal, and that K1 ran one batch-1 prefill per admitted request."""
    import numpy as np
    import torch

    from repro_torch.launch.serve import serve_stream
    from repro_torch.models.lm import init_lm
    from repro_torch.serve.batching import Request
    from repro_torch.serve.decode import CausalLM

    dev = torch.device("cuda")
    model = CausalLM(cfg, init_lm(torch.Generator(device=dev).manual_seed(0), cfg, torch.bfloat16))

    def requests():
        rng = np.random.default_rng(STREAM_SEED)
        lens = rng.integers(STREAM_PROMPT[0], STREAM_PROMPT[1] + 1, STREAM_REQUESTS)
        new = rng.integers(STREAM_NEW[0], STREAM_NEW[1] + 1, STREAM_REQUESTS)
        return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, int(n)).tolist(), max_new_tokens=int(m))
                for i, (n, m) in enumerate(zip(lens, new))]  # fmt: skip

    asked = {req.rid: req.max_new_tokens for req in requests()}
    prompt_tokens = sum(len(req.prompt) for req in requests())
    torch.cuda.reset_peak_memory_stats()
    for counted in counters.values():
        counted.launches = 0
    captured = []
    with graph_only(captured):
        graph = serve_stream(model, requests(), STREAM_SLOTS, STREAM_MAX_SEQ)
    launches = {name: counted.launches for name, counted in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    with eager_launchers():
        eager = serve_stream(model, requests(), STREAM_SLOTS, STREAM_MAX_SEQ)
    want = {"flash_attention_fwd": STREAM_REQUESTS * expected_launches(cfg)["flash_attention_fwd"],
            "ssd_scan_fwd": 0, "flash_attention_bwd": 0}  # fmt: skip
    if {name: launches[name] for name in want} != want:
        raise SystemExit(f"[batch] the stream launched {launches}, not one prefill's per request ({want})")
    if [step.replays for step in captured] != [graph["steps"]]:
        raise SystemExit(f"[batch] {len(captured)} graphs replayed {[s.replays for s in captured]} times for "
                         f"{graph['steps']} steps")
    short = {rid: len(toks) for rid, toks in graph["tokens"].items() if len(toks) != asked[rid]}
    if sorted(graph["tokens"]) != sorted(asked) or short:
        raise SystemExit(f"[batch] requests that did not finish with their max_new_tokens: {short}")
    differ = [rid for rid in asked if graph["tokens"][rid] != eager["tokens"].get(rid)]
    if differ or graph["steps"] != eager["steps"]:
        raise SystemExit(f"[batch] the graph's tokens differ from the eager step's for requests {differ}")
    print(f"[batch] {cfg.name} whole: {STREAM_REQUESTS} requests (seed {STREAM_SEED}, prompts "
          f"{STREAM_PROMPT[0]}-{STREAM_PROMPT[1]} tokens, {prompt_tokens} in all; max_new_tokens "
          f"{STREAM_NEW[0]}-{STREAM_NEW[1]}) over {STREAM_SLOTS} slots, cache max_seq {STREAM_MAX_SEQ}: every "
          f"request finished with its tokens ({graph['generated']} in all), the graph's equal to the eager step's "
          f"for every request; K1 launches {launches['flash_attention_fwd']} (one batch-1 prefill of "
          f"{expected_launches(cfg)['flash_attention_fwd']} a request); peak device memory {peak:.2f} GiB")
    for name, run in (("graph", graph), ("eager", eager)):
        print(f"[batch] {name}: {run['steps']} steps in {run['wall_s']:.3f} s ({STREAM_REQUESTS / run['wall_s']:.2f} "
              f"requests/s, {run['generated'] / run['wall_s']:.1f} generated tokens/s); prefill and staging "
              f"{run['prefill_s']:.3f} s, decode {run['decode_s'] / run['steps'] * 1e3:.2f} ms a step (feed, "
              f"step, read back the tokens, observe); capture {run['capture_s']:.2f} s (set-up, not in the wall)")
    del model
    torch.cuda.empty_cache()
    return {"model": cfg.name, "requests": STREAM_REQUESTS, "slots": STREAM_SLOTS, "steps": graph["steps"],
            "launches": launches["flash_attention_fwd"],
            **{f"{name}_{key}": run[key] for name, run in (("graph", graph), ("eager", eager))
               for key in ("wall_s", "prefill_s", "decode_s")}}  # fmt: skip


@contextlib.contextmanager
def handed_gradients(into: list):
    """Within the block, the train step's gradient tree, as AdamW is handed
    it, is appended to ``into`` (one tree a step)."""
    from repro_torch.train import step as step_mod

    kept = step_mod.adamw_update

    def adamw(cfg, grads, *rest):
        into.append(grads)
        return kept(cfg, grads, *rest)

    with _swapped(step_mod, "adamw_update", adamw):
        yield


def train_expected_launches(cfg) -> dict:
    """K1 and K2 twice a step for each layer of their kind under full remat
    (the forward, then the group's forward again in the backward), and K1's
    backward once for each attention layer."""
    forward = expected_launches(cfg)
    return {"flash_attention_fwd": 2 * forward["flash_attention_fwd"], "ssd_scan_fwd": 2 * forward["ssd_scan_fwd"],
            "flash_attention_bwd": forward["flash_attention_fwd"]}  # fmt: skip


def _profiled(fn):
    """``fn()`` once under the profiler: (its result, wall ms with the profiler
    on, device-busy ms, every kernel as (name, ms, count), largest first)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # rows of the device itself only: a host op's row repeats its kernels' time
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kernels = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    return result, wall_ms, busy_ms, [(e.key, e.self_device_time_total / 1e3, e.count) for e in kernels]


def kernel_group(name: str) -> str:
    """The group of a device kernel by its name, for a step's breakdown."""
    if "flash_fwd" in name or "flash_bwd" in name or "ssd_scan" in name:
        return "K1/K2"
    if "f32f32_f32f32" in name:
        return "float32 GEMMs"
    if "gemm" in name or "nvjet" in name:
        return "bf16 GEMMs"
    if "elementwise" in name or "reduce" in name or "copy" in name:
        return "elementwise, reductions, copies"
    return "other"


def train_at_full_width(cfg, counters, batch: int, seq: int) -> dict:
    """The train phase for one model: ``TRAIN_STEPS`` steps of
    ``make_train_step`` on one fixed random batch (bf16 params, the scu
    policy, full remat), timed on the host clock around a synchronise; step
    0's gradients checked leaf by leaf as AdamW is handed them; then one more
    step under the profiler, whose loss is the loss after ``TRAIN_STEPS`` steps.  Returns
    the numbers for the kernels line."""
    import torch

    from repro_torch.models.lm import init_lm
    from repro_torch.train.optimizer import OptConfig, init_opt_state, tree_leaves
    from repro_torch.train.step import TrainConfig, make_train_step

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    params = init_lm(torch.Generator(device=dev).manual_seed(0), cfg, torch.bfloat16)
    n_params = sum(t.numel() for t in tree_leaves(params))
    tcfg = TrainConfig(sync_strategy="scu", remat_policy="full", param_dtype="bfloat16",
                       opt=OptConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP))  # fmt: skip
    step_fn, _, _, _ = make_train_step(cfg, tcfg, {"data": 1, "model": 1})
    opt_state = init_opt_state(params)
    step = torch.zeros((), dtype=torch.int32, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq + 1), generator=torch.Generator(device=dev).manual_seed(1),
                           device=dev)  # fmt: skip
    data = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    torch.cuda.synchronize()
    print(f"[train] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, vocab {cfg.vocab_size}, "
          f"{n_params / 1e9:.2f} B parameters in bf16 with a float32 master and moments, batch {batch} x {seq}, "
          f"drawn on the card in {time.perf_counter() - t0:.1f} s; scu policy, remat full, lr {TRAIN_LR:g} "
          f"(warm-up {TRAIN_WARMUP} step), the same batch every step")

    torch.cuda.reset_peak_memory_stats()
    want = train_expected_launches(cfg)
    losses, step_ms, launches, handed = [], [], [], []
    for i in range(TRAIN_STEPS):
        for counted in counters.values():
            counted.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with handed_gradients(handed) if i == 0 else contextlib.nullcontext():
            params, opt_state, step, metrics = step_fn(params, opt_state, step, data)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"].item())
        launches.append({name: counters[name].launches for name in want})
        if i == 0:
            # step 0's gradients, leaf by leaf and, in the stacked block leaves,
            # group by group: Queue 3 fault 1's gate on the card
            bad, n_leaves = [], 0
            for key in sorted(handed[0]):
                for k, g in enumerate(tree_leaves(handed[0][key])):
                    rows = g.flatten(1) if key == "blocks" else g.reshape(1, -1)
                    n_leaves += 1
                    if not (torch.isfinite(g).all() and (rows.abs().amax(1) > 0).all()):
                        bad.append((key, k, tuple(g.shape)))
            if bad:
                raise SystemExit(f"[train] {cfg.name}: leaves with a zero or non-finite gradient at step 0: {bad}")
            print(f"[train] {cfg.name} step 0: every one of the {n_leaves} parameter leaves (every group of the "
                  f"stacked ones) has a finite, non-zero gradient")
            handed.clear()
    peak = torch.cuda.max_memory_allocated() / 2**30
    for counted in counters.values():
        counted.launches = 0
    (params, opt_state, step, metrics), wall_ms, busy_ms, kernels = _profiled(
        lambda: step_fn(params, opt_state, step, data))
    groups = {}
    for name, ms, _ in kernels:
        groups[kernel_group(name)] = groups.get(kernel_group(name), 0.0) + ms
    after = metrics["loss"].item()
    print(f"[train] {cfg.name} losses of steps 0-{TRAIN_STEPS - 1}: {[round(x, 6) for x in losses]}; after "
          f"{TRAIN_STEPS} steps: {after:.6f}; grad_norm of the last step {metrics['grad_norm'].item():.4f}")
    print(f"[train] {cfg.name} step ms (host clock): {[round(t, 1) for t in step_ms]}; peak device memory "
          f"{peak:.2f} GiB; kernel launches a step {launches[-1]} (expected {want}: the forward and the "
          f"recompute of every layer of its kind, and K1's backward once a layer)")
    print(f"[train] {cfg.name} one profiled step: wall {wall_ms:.1f} ms with the profiler on, device busy "
          f"{busy_ms:.1f} ms, idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}; device ms by group: "
          + ", ".join(f"{g} {ms:.1f}" for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]))
          + "; the largest kernels:")
    for name, ms, count in kernels[:12]:
        print(f"[train]    {ms:9.2f} ms  x{count:<6d} {name[:110]}")
    if not all(torch.isfinite(torch.tensor(losses + [after]))):
        raise SystemExit(f"[train] {cfg.name}: a loss is not finite: {losses + [after]}")
    if not after < losses[0]:
        raise SystemExit(f"[train] {cfg.name}: the loss after {TRAIN_STEPS} steps ({after}) is not below the "
                         f"first ({losses[0]})")
    if any(got != want for got in launches):
        raise SystemExit(f"[train] {cfg.name}: kernel launches a step {launches}, expected {want}")
    del params, opt_state
    torch.cuda.empty_cache()
    return {"model": cfg.name, "layers": cfg.n_layers, "batch": batch, "seq": seq, "losses": losses,
            "loss_after": after, "step_ms": step_ms, "busy_ms": busy_ms, "profiled_wall_ms": wall_ms,
            "device_ms_by_group": groups,
            "peak_gib": peak, "launches_per_step": launches[-1], "expected_per_step": want}  # fmt: skip


def _host_memory_gib() -> tuple:
    """(total, available) host memory in GiB, from ``/proc/meminfo``."""
    fields = dict(line.split(":", 1) for line in Path("/proc/meminfo").read_text().splitlines())
    return tuple(int(fields[k].split()[0]) / 2**20 for k in ("MemTotal", "MemAvailable"))


def train_through_the_loop(card: str, counters, train_step_ms: list) -> dict:
    """The loop phase: ``mamba2-1.3b`` whole through ``repro_torch.launch.train``'s
    objects and the port's ``train``, three runs: (A) ``LOOP_STEPS`` steps
    without a checkpoint; (B) ``launch.train.main`` itself for
    ``LOOP_CKPT_STEP`` steps with a checkpoint at its end; (C) the A run's
    steps again in B's directory, resuming from B's checkpoint.  Holds C's
    losses to A's, every step's kernel launches (counts set to 0 just before
    a step, read just after it), and the losses' finiteness.  The checkpoint
    directory lies under ``build/`` and is removed at the end, failed or not."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.launch import train as launcher
    from repro_torch.train import loop as loop_mod

    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    ckpt_dir = build / "loop_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    disk = shutil.disk_usage(build)
    ram_total, ram_avail = _host_memory_gib()
    print(f"[loop] {card}; free disk under build/ {disk.free / 1e9:.1f} GB of {disk.total / 1e9:.1f} GB; host "
          f"memory {ram_total:.1f} GiB, {ram_avail:.1f} GiB available")
    run_a = launcher.build_run(LOOP_ARGS + ["--steps", str(LOOP_STEPS)])
    cfg, opt, batch_fn = run_a[0], run_a[1].opt, run_a[4]
    want = train_expected_launches(cfg)

    def counted(run):
        """``train`` on a launcher's objects: (history, kernel launches of each step)."""
        cfg, tcfg, trainer, mesh, batch_fn, device = run
        launches = []

        def on_metrics(i, metrics):
            launches.append({name: counters[name].launches for name in want})
            for counter in counters.values():
                counter.launches = 0

        for counter in counters.values():
            counter.launches = 0
        history = loop_mod.train(cfg, tcfg, trainer, mesh, batch_fn, on_metrics, device=device)[2]
        return history, launches

    def with_peak(fn):
        """``fn()``, its peak device memory in GiB appended to ``peaks``."""
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        peaks.append(torch.cuda.max_memory_allocated() / 2**30)
        torch.cuda.empty_cache()
        return out

    batch_ms = []
    for i in range(3):
        t0 = time.perf_counter()
        batch_fn(1000 + i)
        batch_ms.append((time.perf_counter() - t0) * 1e3)

    managers, restore_s, peaks = [], [], []
    kept_manager, kept_restore = loop_mod.CheckpointManager, loop_mod.restore_checkpoint

    def manager(*args, **kwargs):
        managers.append(kept_manager(*args, **kwargs))
        return managers[-1]

    def restore(*args, **kwargs):
        t0 = time.perf_counter()
        out = kept_restore(*args, **kwargs)
        torch.cuda.synchronize()
        restore_s.append(time.perf_counter() - t0)
        return out

    args_b = LOOP_ARGS + ["--steps", str(LOOP_CKPT_STEP), "--ckpt-dir", str(ckpt_dir),
                          "--ckpt-every", str(LOOP_CKPT_STEP)]  # fmt: skip
    args_c = LOOP_ARGS + ["--steps", str(LOOP_STEPS), "--ckpt-dir", str(ckpt_dir)]
    try:
        hist_a, launches_a = with_peak(lambda: counted(run_a))
        with _swapped(loop_mod, "CheckpointManager", manager):
            hist_b = with_peak(lambda: launcher.main(args_b)[2])
        ckpt_bytes = sum(f.stat().st_size for f in (ckpt_dir / f"step_{LOOP_CKPT_STEP:09d}").iterdir())
        with _swapped(loop_mod, "restore_checkpoint", restore):
            hist_c, launches_c = with_peak(lambda: counted(launcher.build_run(args_c)))
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    loss_a, loss_b, loss_c = ([h["loss"] for h in hist] for hist in (hist_a, hist_b, hist_c))
    a_ms = [h["step_time_s"] * 1e3 for h in hist_a]
    gaps = [abs(c - a) for c, a in zip(loss_c, loss_a[LOOP_CKPT_STEP:])]
    rel = max(g / abs(a) for g, a in zip(gaps, loss_a[LOOP_CKPT_STEP:]))
    bit_equal = loss_c == loss_a[LOOP_CKPT_STEP:]
    print(f"[loop] {cfg.name} whole ({cfg.n_layers} layers), {LOOP_BATCH} x {LOOP_SEQ} SyntheticLM tokens a step, "
          f"bf16, scu, remat full, lr {opt.lr:g} (warm-up {opt.warmup_steps}): (A) {LOOP_STEPS} steps, losses "
          f"{loss_a}; (B) launch.train.main, {LOOP_CKPT_STEP} steps and a checkpoint, losses {loss_b}; (C) resumed "
          f"at step {LOOP_CKPT_STEP}, losses {loss_c}")
    print(f"[loop] C against A: largest loss gap {max(gaps):.3e} (rel {rel:.3e}; tol rtol {LOOP_RTOL:g}, atol "
          f"{LOOP_ATOL:g}); bit-equal: {bit_equal}; B's steps against A's bit-equal: "
          f"{loss_b == loss_a[:LOOP_CKPT_STEP]}")
    print(f"[loop] step ms of A (host clock: batch drawn, moved to the card, step, metrics read): "
          f"{[round(t, 1) for t in a_ms]}; the [train] phase's at the same shape: "
          f"{[round(t, 1) for t in train_step_ms]}; SyntheticLM.batch({LOOP_BATCH} x {LOOP_SEQ}) on the host: "
          f"{[round(t, 1) for t in batch_ms]} ms")
    mgr = managers[0]
    print(f"[loop] checkpoint of step {LOOP_CKPT_STEP}: {ckpt_bytes} bytes on disk ({ckpt_bytes / 1e9:.2f} GB); "
          f"snapshot to host {mgr.snapshot_s:.2f} s, background write {mgr.write_s:.2f} s; restore_checkpoint "
          f"{restore_s[0]:.2f} s; peak device memory A {peaks[0]:.2f}, B {peaks[1]:.2f}, C {peaks[2]:.2f} GiB; "
          f"kernel launches a step A {launches_a[-1]}, C {launches_c[-1]} (expected {want})")
    if not all(np.isfinite(loss_a + loss_b + loss_c)):
        raise SystemExit(f"[loop] a loss is not finite: A {loss_a}, B {loss_b}, C {loss_c}")
    if len(loss_c) != LOOP_STEPS - LOOP_CKPT_STEP or not all(
            g <= LOOP_ATOL + LOOP_RTOL * abs(a) for g, a in zip(gaps, loss_a[LOOP_CKPT_STEP:])):
        raise SystemExit(f"[loop] the resumed losses {loss_c} are not A's {loss_a[LOOP_CKPT_STEP:]}")
    if len(launches_a) != LOOP_STEPS or any(got != want for got in launches_a + launches_c):
        raise SystemExit(f"[loop] kernel launches a step A {launches_a}, C {launches_c}, expected {want}")
    return {"model": cfg.name, "layers": cfg.n_layers, "batch": LOOP_BATCH, "seq": LOOP_SEQ, "losses_a": loss_a,
            "losses_b": loss_b, "losses_c": loss_c, "max_loss_gap": max(gaps), "bit_equal": bit_equal,
            "step_ms_a": a_ms, "batch_ms": batch_ms, "ckpt_bytes": ckpt_bytes, "snapshot_s": mgr.snapshot_s,
            "write_s": mgr.write_s, "restore_s": restore_s[0], "peak_gib": dict(zip("ABC", peaks)),
            "launches_per_step": launches_a[-1]}  # fmt: skip


def data_axis_through_nccl(card: str, counters, train_step_ms: list, train_launches: dict) -> dict:
    """The dist phase (see the module note).  The group, its rendezvous file
    and the checkpoint directory are gone at the end, failed or not."""
    import shutil
    import uuid

    import torch
    import torch.distributed as dist

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.models.lm import init_lm
    from repro_torch.parallel.dist import init_distributed
    from repro_torch.sync import available_policies, get_policy
    from repro_torch.sync.axis import MeshAxis
    from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.train.optimizer import OptConfig, init_opt_state, tree_leaves, tree_map
    from repro_torch.train.step import TrainConfig, make_train_step

    t_phase = time.perf_counter()
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    rendezvous = build / f"dist_rendezvous_{uuid.uuid4().hex[:8]}"
    ckpt_dir = build / "dist_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    cfg = get_config(DIST_ARCH)
    batch, seq = next((b, s) for arch, b, s in TRAIN_RUNS if arch == DIST_ARCH)
    tcfg = TrainConfig(sync_strategy="scu", remat_policy="full", param_dtype="bfloat16",
                       opt=OptConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP))  # fmt: skip
    want = train_expected_launches(cfg)
    try:
        dev = init_distributed("cuda", rank=0, world=1, init_method=f"file://{rendezvous}", timeout=300)
        mesh = device_mesh({"data": 1, "model": 1}, dev)
        nccl = ".".join(str(v) for v in torch.cuda.nccl.version())
        print(f"[dist] {card}; NCCL {nccl}; backend {dist.get_backend()}, world {dist.get_world_size()}, "
              f"DeviceMesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}")
        tokens = torch.randint(0, cfg.vocab_size, (batch, seq + 1), generator=torch.Generator(device=dev).manual_seed(1),
                               device=dev)  # fmt: skip
        data = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

        def run(step_mesh):
            """DIST_STEPS steps from the train phase's params: (params, step,
            shardings, losses, ms a step, launches a step)."""
            params = init_lm(torch.Generator(device=dev).manual_seed(0), cfg, torch.bfloat16)
            step_fn, (in_sh, _), _, _ = make_train_step(cfg, tcfg, step_mesh)
            opt_state = init_opt_state(params, None if isinstance(step_mesh, dict) else in_sh[1])
            step = torch.zeros((), dtype=torch.int32, device=dev)
            losses, step_ms, launches = [], [], []
            for _ in range(DIST_STEPS):
                for counted in counters.values():
                    counted.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, opt_state, step, metrics = step_fn(params, opt_state, step, data)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                launches.append({name: counters[name].launches for name in want})
                losses.append(metrics["loss"].item())
            del opt_state
            return params, step, in_sh, losses, step_ms, launches

        params_a, _, _, loss_a, ms_a, launches_a = run({"data": 1, "model": 1})
        host_a = [t.to("cpu", copy=True) for t in tree_leaves(params_a)]
        del params_a
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params_b, step_b, sh_b, loss_b, ms_b, launches_b = run(mesh)
        peak = torch.cuda.max_memory_allocated() / 2**30
        params_equal = all(torch.equal(a, b.cpu()) for a, b in zip(host_a, tree_leaves(params_b)))
        del host_a
        torch.cuda.empty_cache()

        axis = MeshAxis(mesh, "data")
        barriers = {}
        for name in available_policies():
            for shape in DIST_WORD_SHAPES:
                words = torch.arange(1, 1 + max(1, torch.Size(shape).numel()), dtype=torch.float32, device=dev)
                words = (words * 7 % 50).reshape(shape)
                got = get_policy(name).chip_barrier(words, axis)
                stacked = get_policy(name).chip_barrier(words[None], "x")[0]
                barriers[(name, shape)] = bool(torch.equal(got, stacked))
        torch.cuda.synchronize()

        state = {"params": params_b, "step": step_b}
        placements = {"params": sh_b[0], "step": sh_b[2]}
        t0 = time.perf_counter()
        save_checkpoint(str(ckpt_dir), DIST_STEPS, state, placements)
        save_s = time.perf_counter() - t0
        ckpt_bytes = sum(f.stat().st_size for f in (ckpt_dir / f"step_{DIST_STEPS:09d}").iterdir())
        t0 = time.perf_counter()
        restored = restore_checkpoint(str(ckpt_dir), DIST_STEPS, tree_map(lambda t: t.to("meta"), state),
                                      placements, device=dev)  # fmt: skip
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        ckpt_equal = all(torch.equal(a, b) for a, b in zip(tree_leaves(restored), tree_leaves(state)))
        del restored, state, params_b
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        if dist.is_initialized():
            dist.destroy_process_group()
        rendezvous.unlink(missing_ok=True)
        torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase

    print(f"[dist] {cfg.name} whole ({cfg.n_layers} layers), {batch} x {seq}, bf16, scu, remat full: {DIST_STEPS} "
          f"steps through the DeviceMesh step, losses {loss_b}; without a group {loss_a}; losses bit-equal "
          f"{loss_b == loss_a}, params bit-equal {params_equal}")
    print(f"[dist] step ms (host clock) through the DeviceMesh {[round(t, 1) for t in ms_b]}, without a group "
          f"{[round(t, 1) for t in ms_a]}, the [train] phase's {[round(t, 1) for t in train_step_ms]}; peak "
          f"device memory through the DeviceMesh {peak:.2f} GiB; kernel launches a step {launches_b[-1]} "
          f"(the [train] phase's {train_launches})")
    print(f"[dist] the seven chip barriers over the data axis through NCCL against the stacked shim at n = 1, "
          f"shapes {list(DIST_WORD_SHAPES)}: {sum(barriers.values())} of {len(barriers)} equal")
    print(f"[dist] checkpoint of the params and the step, saved by the group and restored at their placements: "
          f"{ckpt_bytes} bytes ({ckpt_bytes / 1e9:.2f} GB), save {save_s:.2f} s, restore {restore_s:.2f} s, "
          f"bit-equal {ckpt_equal}; phase {phase_s:.1f} s")
    if not (loss_b == loss_a and params_equal):
        raise SystemExit(f"[dist] the DeviceMesh steps differ from the steps without a group: losses {loss_b} "
                         f"against {loss_a}, params bit-equal {params_equal}")
    if any(got != want for got in launches_a + launches_b) or launches_b[-1] != train_launches:
        raise SystemExit(f"[dist] kernel launches a step {launches_b} (without a group {launches_a}), expected "
                         f"{want}, the [train] phase's {train_launches}")
    if not all(barriers.values()):
        raise SystemExit(f"[dist] chip barriers through NCCL differ from the stacked shim: "
                         f"{[key for key, ok in barriers.items() if not ok]}")
    if not ckpt_equal:
        raise SystemExit("[dist] the checkpoint restored at its placements is not the saved state")
    return {"model": cfg.name, "losses": loss_b, "losses_without_group": loss_a, "step_ms": ms_b,
            "step_ms_without_group": ms_a, "peak_gib": peak, "launches_per_step": launches_b[-1],
            "ckpt_bytes": ckpt_bytes, "save_s": save_s, "restore_s": restore_s, "phase_s": phase_s, "nccl": nccl}


def dist_alone() -> dict:
    """The dist phase by itself (about 80 s on an H100, K1's two builds
    included), held to the launches a train step must make in place of the
    train phase's: ``python3 -c 'import chip_smoke; chip_smoke.dist_alone()'``."""
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.compat import card_name_and_power_limit
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel

    flash_kernel.build()
    flash_kernel.build_bwd()
    torch.backends.cuda.matmul.allow_tf32 = False
    counters = {"flash_attention_fwd": flash_kernel.flash_attention_fwd,
                "flash_attention_bwd": flash_kernel.flash_attention_bwd, "ssd_scan_fwd": ssd_kernel.ssd_scan_fwd}
    want = train_expected_launches(get_config(DIST_ARCH))
    return data_axis_through_nccl(card_name_and_power_limit(), counters, [], want)


def check_train_step_against_plain(cfg, plain, grad_tol: float) -> dict:
    """One float32 train step at ``cfg``'s full width cut to ``F32_STEP_LAYERS``
    layers and ``F32_STEP_LEN`` tokens, through the kernels and through their
    plain versions (``plain``), from the same params and batch: the loss, the
    gradients AdamW is handed (each leaf within ``grad_tol`` of its largest
    entry: the path's kernel forward is held to its plain version within that
    figure in float32, and every gradient downstream of it moves with it), the
    gradient norm and the updated params."""
    import torch

    from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd, flash_attention_fwd
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_fwd
    from repro_torch.models.lm import init_lm
    from repro_torch.train.optimizer import OptConfig, init_opt_state, tree_leaves, tree_map
    from repro_torch.train.step import TrainConfig, make_train_step

    dev = torch.device("cuda")
    cfg = dataclasses.replace(cfg, n_layers=F32_STEP_LAYERS, dtype="float32")
    params = init_lm(torch.Generator(device=dev).manual_seed(5), cfg, torch.float32)
    opt = OptConfig(lr=TRAIN_LR, warmup_steps=1)
    step_fn, _, _, _ = make_train_step(cfg, TrainConfig(remat_policy="full", param_dtype="float32", opt=opt),
                                       {"data": 1, "model": 1})  # fmt: skip
    tokens = torch.randint(0, cfg.vocab_size, (1, F32_STEP_LEN + 1), generator=torch.Generator(device=dev).manual_seed(6),
                           device=dev)  # fmt: skip
    data = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

    def one(context):
        """(new params, the gradients AdamW was handed, metrics, kernel launches), as leaves."""
        handed = []
        flash_attention_fwd.launches = flash_attention_bwd.launches = ssd_scan_fwd.launches = 0
        start = tree_map(lambda t: t.clone(), params)
        with context, handed_gradients(handed):
            new, _, _, metrics = step_fn(start, init_opt_state(start), torch.zeros((), dtype=torch.int32, device=dev),
                                         data)  # fmt: skip
        launches = flash_attention_fwd.launches + flash_attention_bwd.launches + ssd_scan_fwd.launches
        return tree_leaves(new), tree_leaves(handed[0]), metrics, launches

    kp, kg, km, k_launches = one(contextlib.nullcontext())
    pp, pg, pm, p_launches = one(plain())
    if k_launches == 0 or p_launches != 0:
        raise SystemExit(f"[train] {cfg.name} float32 check: kernel launches {k_launches} (kernel path), "
                         f"{p_launches} (plain path)")
    loss_err = abs(km["loss"].item() - pm["loss"].item()) / abs(pm["loss"].item())
    gnorm_err = abs(km["grad_norm"].item() - pm["grad_norm"].item()) / pm["grad_norm"].item()
    grad_errs = [(a - b).abs().max().item() / max(b.abs().max().item(), 1e-30) for a, b in zip(kg, pg)]
    grad_err = max(grad_errs)
    worst_leaf = grad_errs.index(grad_err)
    worst = max((a - b).abs().max().item() for a, b in zip(kp, pp))
    # Adam's first step moves an entry by lr (u + wd p), u = g' / (|g'| + eps), g'
    # the clipped gradient: near eps = 1e-8 it turns float32 noise in g into up
    # to 2 lr.  So the two steps' params must differ by lr times the difference
    # of the two paths' u, within 1e-3 lr beyond the two roundings of p (2^-22 |p|):
    # no more than their gradients explain.
    lr = km["lr"].item()

    def u(g, m):
        g = g * torch.clamp(opt.grad_clip / m["grad_norm"], max=1.0)
        return g / (g.abs() + opt.eps)

    unexplained = max(((a - b) + lr * (u(ga, km) - u(gb, pm))).abs().sub(2.0**-22 * b.abs()).max().item()
                      for a, b, ga, gb in zip(kp, pp, kg, pg))  # fmt: skip
    print(f"[train] {cfg.name} at {F32_STEP_LAYERS} layers, full width, 1 x {F32_STEP_LEN} tokens, float32: one step "
          f"through the kernels ({k_launches} launches) vs through the plain versions: loss rel err {loss_err:.2e} "
          f"(tol 1e-5), gradients max err {grad_err:.2e} of each leaf's largest entry (tol {grad_tol:g}; leaf "
          f"{worst_leaf} of {len(kg)}, {tuple(kg[worst_leaf].shape)}), grad_norm rel err "
          f"{gnorm_err:.2e} (tol 1e-4), updated params max abs err {worst:.3e} (at most 2 lr = {2 * TRAIN_LR:g}), "
          f"of which not explained by Adam's update of the two gradients and the rounding of p {unexplained:.3e} "
          f"(tol 1e-3 lr = {1e-3 * lr:.1e})")
    if not (loss_err <= 1e-5 and grad_err <= grad_tol and gnorm_err <= 1e-4 and worst <= 2 * lr * (1 + 1e-3)
            and unexplained <= 1e-3 * lr):
        raise SystemExit(f"[train] {cfg.name}: the float32 step through the kernels disagrees with the plain one")
    del params, kp, pp, kg, pg
    torch.cuda.empty_cache()
    return {"model": cfg.name, "layers": F32_STEP_LAYERS, "seq": F32_STEP_LEN, "loss_rel_err": loss_err,
            "grad_rel_err": grad_err, "grad_norm_rel_err": gnorm_err, "params_max_abs_err": worst,
            "params_unexplained_abs_err": unexplained}


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
    def timed_build(build):
        t0 = time.perf_counter()
        build()
        return time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor() as pool:
        builds = {name: pool.submit(timed_build, build) for name, build in
                  (("flash_attention_fwd.cu", flash_kernel.build), ("flash_attention_bwd.cu", flash_kernel.build_bwd),
                   ("ssd_scan_fwd.cu", ssd_kernel.build), ("scu_barrier.cu", scu_kernel.build))}
        for name, future in builds.items():
            print(f"[build] {name} with nvcc for sm_90a: {future.result():.1f} s (set-up; built side by side)")

    # ---- 3. kernels ---------------------------------------------------------
    phi4, mamba2 = get_config("phi4-mini-3.8b"), get_config("mamba2-1.3b")
    deepseek, qwen3 = get_config("deepseek-v2-lite-16b"), get_config("qwen3-moe-30b-a3b")
    stablelm = get_config("stablelm-3b")
    codeqwen, musicgen = get_config("codeqwen1.5-7b"), get_config("musicgen-medium")
    llava = get_config("llava-next-34b")
    # command-r-plus: 16 of its 64 layers (see the serve phase)
    command_r = dataclasses.replace(get_config("command-r-plus-104b"), n_layers=COMMAND_R_LAYERS)
    k1 = check_attention_kernel(PROMPT_LEN, phi4, deepseek, stablelm, (llava, command_r))
    k1b = check_attention_backward(phi4, deepseek, stablelm)
    k2 = check_ssd_kernel(PROMPT_LEN, mamba2)
    k2["backward"] = check_ssd_backward(mamba2)
    k3, k4, k5 = check_scu_kernels()

    # ---- 4. serve -----------------------------------------------------------
    counters = {"flash_attention_fwd": flash_kernel.flash_attention_fwd,
                "flash_attention_bwd": flash_kernel.flash_attention_bwd, "ssd_scan_fwd": ssd_kernel.ssd_scan_fwd,
                "scu_barrier": scu_kernel.scu_barrier, "scu_notifier": scu_kernel.scu_notifier,
                "scu_self_signal": scu_kernel.scu_self_signal}
    # 513 is no multiple of any attention tile: the ragged edge on the serving path
    by_model, graphs = {}, {}
    by_model[phi4.name], graphs[phi4.name] = serve_at_full_width(phi4, counters, plain_attention, 5e-2, 512)
    # stablelm whole (32 layers of 32 heads of 80): K1's head dim 80 on the serving path
    by_model[stablelm.name], graphs[stablelm.name] = serve_at_full_width(stablelm, counters, plain_attention, 5e-2,
                                                                         512)  # fmt: skip
    # the SSD chunk must divide the prompt: 255 and 256 are one chunk each (255 the ragged one).
    # 48 layers of random SSD weights in bf16 stray from float32 further than 5 % of the
    # largest logit on either path, so only the plain path bounds the kernel's
    # then one prompt alone, where K2 takes a chunk-parallel form
    by_model[mamba2.name], graphs[mamba2.name] = serve_at_full_width(
        mamba2, counters, plain_ssd_scan, None, 255, lambda model: serve_one_sequence(model, mamba2, counters, k2))
    # deepseek (27 layers, 15.7 B) and qwen3-moe (48 layers, 30.5 B) whole; their checks at 4
    # layers (deepseek: the dense prelude and 3 MoE layers).  bf16 routing flips between the
    # two paths move the logits of a random MoE model by more than 5 % of the largest one,
    # so only the plain path bounds the kernel's, as for mamba2.
    for cfg in (deepseek, qwen3):
        by_model[cfg.name], graphs[cfg.name] = serve_at_full_width(cfg, counters, plain_attention, None, 512,
                                                                   check_layers=4)  # fmt: skip
    # jamba: one group of 8 of its 32 layers (1 attention, 7 SSD, 4 MoE): 13.3 B parameters
    # (26.5 GB in bf16) of 51.6 B, which would take 103 GB; the group keeps the 1:7 pattern.
    # Its checks take that whole group, with the bf16 model on the host while the float32
    # copy (53 GB) is on the card.  127 and 128 fit its SSD chunk of 128.
    jamba = dataclasses.replace(get_config("jamba-v0.1-52b"), n_layers=8)
    print(f"[serve] {jamba.name}: cut to one group of {jamba.block_group} layers of its "
          f"{get_config('jamba-v0.1-52b').n_layers} ({jamba.n_params() / 1e9:.1f} B parameters of "
          f"{get_config('jamba-v0.1-52b').n_params() / 1e9:.1f} B; the whole model does not fit the card in bf16)")
    by_model[jamba.name], graphs[jamba.name] = serve_at_full_width(jamba, counters, plain_hybrid, None, 127,
                                                                   offload=True)  # fmt: skip
    # the four archs first served here: codeqwen (32 layers, 32 heads of 128 with a QKV bias,
    # no GQA; 8.2 B) and musicgen (48 layers, 24 heads of 64, sinusoidal positions,
    # LayerNorm, GELU, frame embeddings from its stubbed frontend; 1.4 B) whole;
    # llava-next (60 layers, 56 / 8 heads of 128: K1 at group 7; 34.4 B, 68.8 GB) whole,
    # its checks at 4 layers.
    phase_t0 = time.perf_counter()
    for cfg in (codeqwen, musicgen):
        by_model[cfg.name], graphs[cfg.name] = serve_at_full_width(cfg, counters, plain_attention, 5e-2, 512)
    by_model[llava.name], graphs[llava.name] = serve_at_full_width(llava, counters, plain_attention, 5e-2, 512,
                                                                   check_layers=4)  # fmt: skip
    # command-r-plus: 16 of its 64 layers (96 / 8 heads of 128: K1 at group 12; a parallel
    # block, the tied 256000-row embedding): 56.7 GB of its 207.6 GB in bf16.  Its checks at
    # 2 layers, drawn alone: the float32 embedding alone takes 12.6 GB.
    whole_r = get_config("command-r-plus-104b")
    print(f"[serve] {command_r.name}: cut to {command_r.n_layers} of its {whole_r.n_layers} layers "
          f"({command_r.n_params() / 1e9:.1f} B parameters of {whole_r.n_params() / 1e9:.1f} B; the whole model "
          f"does not fit the card in bf16)")
    by_model[command_r.name], graphs[command_r.name] = serve_at_full_width(command_r, counters, plain_attention,
                                                                           5e-2, 512, check_layers=2)  # fmt: skip
    print(f"[serve] codeqwen, musicgen, llava-next and command-r-plus: {time.perf_counter() - phase_t0:.1f} s")
    print(f"[graph] every served model decoded through one CUDA graph; graph vs eager: "
          + json.dumps({name: {key: got[key] for key in ("max_logit_gap", "bitwise")} for name, got in graphs.items()}))

    # ---- 4b. batch -----------------------------------------------------------
    stream = serve_a_stream(phi4, counters)

    k1["launches"] = by_model[phi4.name]["flash_attention_fwd"]
    k2["launches"] = by_model[mamba2.name]["ssd_scan_fwd"]
    k1["mla"]["launches"] = by_model[deepseek.name]["flash_attention_fwd"]
    k1["d80"]["launches"] = by_model[stablelm.name]["flash_attention_fwd"]
    for name, entry in k1["groups"].items():
        entry["launches"] = by_model[name]["flash_attention_fwd"]
    k1["stream"] = stream
    for entry in (k1, k1b, k2):
        entry["launches_by_model"] = {name: got[entry["name"]] for name, got in by_model.items()}

    # ---- 5. train ------------------------------------------------------------
    # the float32 step through the kernels against the plain versions, at a cut depth
    f32_steps = [check_train_step_against_plain(phi4, plain_attention, KERNEL_TOL["float32"]),
                 check_train_step_against_plain(mamba2, plain_ssd_scan, SSD_TOL["float32"])]
    trained = {}
    for arch, batch, seq in TRAIN_RUNS:
        trained[arch] = train_at_full_width(get_config(arch), counters, batch, seq)
    k1["train"] = {"steps": trained[phi4.name], "float32_step": f32_steps[0]}
    k2["train"] = {"steps": trained[mamba2.name], "float32_step": f32_steps[1]}
    for entry in (k1, k1b, k2):
        entry["launches_per_train_step"] = {name: got["launches_per_step"][entry["name"]]
                                            for name, got in trained.items()}  # fmt: skip
    # the backward runs on the training path only: its launches are a phi4 step's
    k1b["launches"] = k1b["launches_per_train_step"][phi4.name]

    # ---- 5b. dist ------------------------------------------------------------
    data_axis_through_nccl(card, counters, trained[phi4.name]["step_ms"], trained[phi4.name]["launches_per_step"])

    # ---- 6. loop -------------------------------------------------------------
    k2["loop"] = train_through_the_loop(card, counters, trained[mamba2.name]["step_ms"])

    # ---- 7. sync -------------------------------------------------------------
    swept = barrier_sweep(counters)
    for entry in (k3, k4, k5):
        entry["launches"] = swept[entry["name"]]

    # ---- 8. trace ------------------------------------------------------------
    # the simulator's trace executor launches none of the kernels (its cycle step is PyTorch ops)
    for counted in counters.values():
        counted.launches = 0
    trace_batch(card)
    if any(counted.launches for counted in counters.values()):
        raise SystemExit(f"[trace] kernels launched in the trace phase: "
                         f"{ {name: counted.launches for name, counted in counters.items()} }")

    # ---- 9. result ----------------------------------------------------------
    print(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [k1, k1b, k2, k3, k4, k5]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
