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
            path each shape took (``wgmma`` or ``f32``), is
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
            deepseek's MLA and stablelm's head dims and phi4's heads of
            160 in bf16 and phi4's in float32, 1024 tokens, one launch of
            K1's backward kernel a gradient; K2 at mamba2's dims in the
            sequential and a cluster form).  K1's backward kernel against
            its plain version (``ops.attention_bwd``) at b=1, 4096 tokens at
            phi4's, MLA's and head dim 80's dims and at b=4 at phi4's heads
            of 160, two calls the same bits, and timed there in turns with
            SDPA's backward and the PyTorch FA-2 backward it replaced; K2's
            backward timed at the serving shape.  K1 and its backward at
            every width the reference takes (``WIDTHS``: 16, 24, 32, 48, 96,
            the widest square 160, (24, 16) and (96, 64), each in the
            smallest instance that holds it) against their plain versions in
            float32 and bf16, each timed in bf16 at phi4's heads and 4096
            tokens beside SDPA (forward and backward) and the bound.
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
            form, the form of a card without cluster launch.  Then the ten
            smoke configs, each drawn in bf16 and served (2 prompts of 64
            tokens, 4 decoded through the graph): K1 at the smoke widths,
            16 and deepseek's MLA (24, 16); checks that prefill launched K1
            once an attention layer and K2 once an SSD layer, finite logits
            and tokens in the vocabulary.
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
5c. model:  serving over the ``model`` axis: two processes share the card
            on ``{"data": 1, "model": 2}``.  Each first asks for the NCCL
            group that ``init_distributed`` takes for a card; NCCL refuses two
            ranks on one device, and the refusal is printed.  So they join an
            explicit ``gloo`` group over CUDA tensors (the path's collectives
            are all ``all_reduce``), the kernels already built here.  Each
            draws every model leaf by leaf and keeps its ``param_shardings``
            block, and serves through ``serve(..., mesh=...)`` with the eager
            step (a ``gloo`` group's collectives cannot be captured in a
            graph).  phi4-mini-3.8b (12 of 24 q heads and 4 of 8 kv heads a
            rank, the 200,064-row vocabulary split), mamba2-1.3b (32 of 64
            SSD heads, the split gated norm) and deepseek-v2-lite-16b (MLA at
            (192, 128), 8 of 16 heads, 32 of 64 experts a rank, the shared
            experts and the dense first layer split): (a) float32 at a cut
            depth (phi4 2 layers, mamba2 and deepseek 4; 2 x 512, 4 eager
            steps) through the kernels, the routing pinned to the model = 1
            run's, against the same params served at model = 1 here through
            the plain versions (no kernel launched): logits within 1e-4 of
            the largest one, the same tokens, and at most 1 % of the
            router's own top-k sets at model = 2 otherwise than model = 1's;
            (b) bf16 at full width and depth on the serve phase's request
            (4 x 4096, 32 eager steps): prefill s, ms a step, peak GiB and
            params held by rank, and the tokens' agreement with the serve
            phase's model = 1 run (printed, not checked: two bf16 partial
            sums round otherwise).  Checks that every rank launched K1 once
            a prefill for each attention layer and K2 for each SSD layer on
            its local heads (counts set to 0 just before, read just after),
            and that the logits are finite and the tokens in the
            vocabulary.  Then, back in this process, K1 and K2 are held to
            their plain versions and timed (beside SDPA and the bound) at
            the shapes and types the ranks handed them in (b): phi4's 12 /
            4 heads, deepseek's 8 MLA heads at (192, 128), mamba2's 32 SSD
            heads, at 4 x 4096.
5d. mtrain: training over the ``model`` axis, the model phase's two
            processes, NCCL refusal and ``gloo`` group, and models (phi4's 12
            / 4 heads a rank, mamba2's 32 SSD heads, deepseek's 8 MLA heads
            and 32 experts), through ``make_train_step`` over the
            ``DeviceMesh`` (scu, remat full, lr 3e-4): each rank draws its
            parameter blocks leaf by leaf and its optimizer state's.  (a)
            float32 at a cut depth (phi4 2 layers, mamba2 and deepseek 4; 2 x
            512, 3 steps) through the kernels, against the same params
            trained at model = 1 here through the plain versions, the
            routing pinned to that run's: losses and grad norms within 1e-4
            relative; each rank's step-0 gradient of every leaf within 1e-4
            of the largest entry of its block of model = 1's (a missed
            partial sum is off by about half of it); in every parameter
            block every entry within 1e-4 of the block's largest entry plus
            2e-2 of its largest update, but for an entry whose gradient at
            some step is below 1e-3 of its leaf's RMS at model = 1 and at
            model = 2 alike (AdamW lifts float32 noise there, by up to 2 lr
            a step; the yardstick and the ranks record each entry's smallest
            gradient over the steps), and every entry within twice the
            summed learning rates; the leaves whole over ``model`` the same
            bits on both ranks; at most 1 % of the router's own top-k sets
            otherwise than model = 1's.  (b) bf16 at full
            width, the train phase's batch and optimizer: phi4 and mamba2
            whole at 1 x 4096, deepseek at 4 of its 27 layers (its whole
            training state does not fit the card); each rank's memory
            reckoned before the call and printed beside its peak.  Checks,
            by rank, that every leaf of its blocks has a finite, non-zero
            gradient at step 0, that every loss is finite and the last below
            the first, that after the last step the leaves whole over
            ``model`` (each rank updates its own copy) hold the same bits on
            both ranks, and that K1's forward launched twice and its backward
            once per attention layer and K2 twice per SSD layer, a step
            (counts set to 0 just before a step, read just after); prints ms
            a step, peak GiB, params and optimizer state held, and the gap to
            the train phase's model = 1 losses where the batch is the same.
            (c) Back in this process, K1's backward and K2's forward held to
            their plain versions and timed (beside SDPA's backward and the
            bound) at the shapes the ranks handed them in (b).
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
8b. sim:    the port's cycle-accurate SCU cluster simulator
            (``repro_torch.core.scu``, numpy host code as in the reference)
            and its fleet service.  (a) Every parity program of the trace
            phase with no SCU rows, on the port's engine (``Cluster`` in
            lockstep and fastforward, through ``TraceProgram.__call__``)
            and on the card through ``run_traces_torch``: cycles, bank
            conflicts, the nine counters, finish cycles and words equal.
            (b) The paper's results: Table 1's barrier (``prim_cycles`` of
            ``scu`` and ``sw`` at 2, 4 and 8 cores; ``scu`` flat, ``sw`` over
            3x from 2 to 8), and Table 2 / Fig. 6, the nine apps under
            ``scu``, ``tas`` and ``sw`` (cycles, energy uJ, power mW, the
            SCU's cycle and energy gains over ``sw``, their mean and
            maximum).  Checks every cycle count, energy and power against
            the reference's (``SIM_APP_REFERENCE``: cycles exactly, the
            floats within 1e-12 relative), that lockstep equals fastforward
            on dwt and fft, and on every app that ``scu`` takes no more
            cycles than ``sw`` and at most 1.01 x its energy.  (c) A ``FleetService``
            over a ``SlotFleet`` takes a ``poisson_trace`` of barrier jobs
            under a ``CheckpointPolicy``, with priority preemption and one
            fault plan (a droop that times the first attempt of one job out);
            checks that every job completes and that every preempted or
            resumed job's stats equal the same job run uninterrupted.  No
            kernel launches (every count set to 0 just before, read just
            after, and each worker process's counts read at its end);
            prints the phase's host seconds.
9. dryrun:  after every phase that starts a process group
            (``repro_torch.launch.dryrun`` on fake CUDA tensors): phi4
            training at 1 x 4096, mamba2 at 4 x 4096, and both prefilled at
            4 x 4096, at ``{"data": 1, "model": 1}``, and one production
            cell, phi4 ``train_4k`` on the 16 x 16 mesh (a ``"fake"``
            group of 256, rank 0).  Checks that the dry run allocated
            nothing on the card (``memory_allocated`` before and after),
            launched no kernel and left no group up.  Prints each cell's
            roofline bound (``launch/roofline.py``) beside its measured time
            (the train phase's steps; the prefills measured here) and its
            predicted peak beside ``max_memory_allocated``; fails if a
            measured time is below its bound or a peak is off by more than
            25 %.
10. examples: the three example twins (``examples/*_torch.py``), each in a
            process of its own on the card: the quickstart, train_100m at
            40 steps with its resume, the batched serve; checks each exits 0.
11. result: one ``{"kernels": [...]}`` line (K1, K1's backward, K2-K5; K1 and its backward with ``widths``; K1
            and K2 with, under ``model_axis``, each model's launches by rank
            at model = 2 and the check and times at a rank's shape; K1, K1's
            backward and K2 with, under ``model_axis_training``, each model's
            launches a training step by rank at model = 2, and K1's backward
            and K2 their check and times at a rank's training shape), the
            card line, and the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
import math
import re
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# the work's FLOPs and the least time on the card: one definition with the
# kernels' flop formulas (the dry run's count); the card's peaks are
# repro_torch/hardware.py's.  Without the checkout's src/ this import
# fails and the script exits non-zero, printing no result.
from repro_torch.kernels.costs import attention_bwd_bound, attention_flops, bound, ssd_flops  # noqa: E402

# the request the serving phase answers: a batch of prompts, greedy-decoded
BATCH, PROMPT_LEN, GEN = 4, 4096, 32


# (b, h, kvh, s, d, causal): the four shapes of tests/test_kernels.py, one
# ragged length, the non-causal case, llava's 7 and command-r's 12 q heads a kv
# head at a ragged length, head dim 80 (causal, and non-causal at 4 q heads a kv head), the
# smoke configs' 16, and the bf16 schedule's edges: an odd group whose band holds every q tile
# (3 / 1 at 333), one q tile shorter than a key tile under a band wider than the q tiles (2 / 1
# at 77), and 40 keys, not causal
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
    (1, 3, 1, 333, 128, True),
    (2, 2, 1, 77, 128, True),
    (1, 2, 1, 40, 64, False),
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
# K1 in bf16 at phi4's, llava's and command-r's prefill shapes (b=4, 4096 tokens): the error's
# norm over the plain version's.  The kernel read 2.919e-3, 2.909e-3 and 2.918e-3 there
# (PERF.md section 6, "K1's forward at large GQA groups"); 10 % over the largest.  One rounding more moves it where the
# largest absolute error (a bf16 step) does not.
FWD_REL_TOL = 1.10 * 2.919e-3
# K1's widths beyond its first instances: the smoke configs' 16, 24, 32, 48, 96, the widest
# square (160), deepseek's smoke MLA (24, 16) and (96, 64), against the plain versions in
# float32 and bf16 at WIDTHS_CHECK (b, h, kvh, s: ragged, 4 q heads a kv head), the backward
# within WIDTH_BWD_TOL of the largest gradient; timed in bf16 at WIDTHS_TIMED (phi4's heads
# at the serving length)
WIDTHS = [(16, 16), (24, 24), (32, 32), (48, 48), (96, 96), (160, 160), (24, 16), (96, 64)]
WIDTHS_CHECK, WIDTHS_TIMED = (2, 8, 2, 333), (4, 24, 8, 4096)
WIDTH_BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the serve phase's ten smoke configs: a request of SMOKE_BATCH prompts of SMOKE_PROMPT tokens,
# SMOKE_GEN tokens decoded
SMOKE_BATCH, SMOKE_PROMPT, SMOKE_GEN = 2, 64, 4
# the dryrun phase: (arch, kind, batch, seq) of the cells this script measures, at
# {"data": 1, "model": 1}; prefills timed a cell; the predicted peak's tolerance
DRYRUN_CELLS = (("phi4-mini-3.8b", "train", 1, 4096), ("mamba2-1.3b", "train", 4, 4096),
                ("phi4-mini-3.8b", "prefill", 4, 4096), ("mamba2-1.3b", "prefill", 4, 4096))
DRYRUN_PREFILLS, DRYRUN_PEAK_TOL = 3, 0.25
# the examples phase: train_100m's steps, and any example's time limit
EXAMPLE_TRAIN_STEPS, EXAMPLE_TIMEOUT_S = 40, 300

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
# and at phi4's, MLA's and 160's training shapes, each gradient's error norm over the plain
# version's within the errors of one rounding of dS (PERF.md section 6, "dS's rounding at the
# wide instances": the two passes read dq 1.377e-3 and 1.382e-3, dk 2.561e-3 and 2.571e-3, dv 2.535e-3 and 2.528e-3 at
# (192, 128) and 160), rounded up, with 10 % over them: dS rounded once more put 2.6x into dq,
# which BWD_TOL cannot see
BWD_REL_TOL = {name: 1.10 * err for name, err in {"dq": 1.38e-3, "dk": 2.57e-3, "dv": 2.54e-3}.items()}
# the backward's timing in turns: rounds of (kernel, SDPA, PyTorch FA-2) then
# the reverse; iterations of each (the FA-2 backward takes some 25 ms)
BWD_ROUNDS, BWD_ITERS, FA2_ITERS = 2, 20, 2
# K1's backward at the widest square instance besides the models' head dims:
# phi4's 24 / 8 heads of 160 at b=4, held and timed as the models' shapes are
WIDE_BWD_DIMS, WIDE_BWD_BATCH = (160, 160), 4
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
# the model phase: two processes share the card in a gloo group over CUDA tensors
# (NCCL refuses two ranks on one device) on {"data": 1, "model": 2}.  Its models; each
# one's float32 check at (layers, prompt), MODEL_F32_BATCH prompts and MODEL_F32_GEN
# eager steps, against the same params served at model = 1, the logits within
# MODEL_TOL of the largest one (float32 sums in another order: the row-split
# projections' partial sums, the softmax combined across sequence blocks); then each
# at full width and depth in bf16 on the serve phase's request (BATCH x PROMPT_LEN,
# GEN eager steps)
MODEL_ARCHS = ("phi4-mini-3.8b", "mamba2-1.3b", "deepseek-v2-lite-16b")
MODEL_F32 = {"phi4-mini-3.8b": (2, 512), "mamba2-1.3b": (4, 512), "deepseek-v2-lite-16b": (4, 512)}
MODEL_F32_BATCH, MODEL_F32_GEN = 2, 4
MODEL_TOL = 1e-4
# the share of (token, layer) top-k sets that the router at model = 2 may choose
# otherwise than model = 1's (near-ties; a fault in routing across the split shows as many)
MODEL_ROUTING_DIFFER = 0.01
MODEL_RANKS, MODEL_TIMEOUT_S = 2, 400
# the mtrain phase: training over the model axis, the model phase's two processes and
# models.  (a) float32 at a cut depth (layers), MTRAIN_F32_BATCH x MTRAIN_F32_LEN tokens,
# MTRAIN_STEPS steps through the kernels, against the same params trained at model = 1
# through the plain versions, the routing pinned to that run's: losses and grad norms
# within MTRAIN_TOL relative; each rank's step-0 gradient of every leaf within MTRAIN_TOL
# of the largest entry of its block of model = 1's; in every parameter block every entry
# within MTRAIN_TOL of the block's largest entry plus MTRAIN_UPDATE_TOL of its largest
# update over the steps, but for an entry whose gradient at some step, at model = 1 and at
# model = 2 alike, is below MTRAIN_QUIET of its leaf's RMS at model = 1 at that step, and
# every entry within 2 x the summed learning rates (AdamW divides a gradient entry by its
# own running RMS, so where a gradient is near zero, float32 sums in another order move its
# update by up to 2 lr a step: the float32 step of the train phase meets the same, one step
# at a time).  (b) bf16 at
# full width on the train phase's batch and optimizer: (arch, layers or None for the
# whole model, batch, sequence); deepseek cut to 4 of its 27 layers, whose whole
# training state does not fit the card
MTRAIN_F32 = {"phi4-mini-3.8b": 2, "mamba2-1.3b": 4, "deepseek-v2-lite-16b": 4}
MTRAIN_F32_BATCH, MTRAIN_F32_LEN, MTRAIN_STEPS = 2, 512, 3
MTRAIN_TOL, MTRAIN_UPDATE_TOL, MTRAIN_QUIET = 1e-4, 2e-2, 1e-3
MTRAIN_BF16 = (("phi4-mini-3.8b", None, 1, 4096), ("mamba2-1.3b", None, 1, 4096), ("deepseek-v2-lite-16b", 4, 1, 4096))
MTRAIN_TIMEOUT_S = 420
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
# the sim phase: Table 2 of the nine apps at 8 cores, seed 0, as the reference's
# ``repro.core.scu.apps.run_app`` gives it on the CPU: app -> policy -> (cycles,
# energy uJ, power mW); the cycles are held exactly, the floats within SIM_REL_TOL
# relative (tests/test_torch_sim_apps.py holds this table to the reference, and the
# port to the reference app by app)
SIM_APP_REFERENCE = {
    "dwt": {"scu": (11004, 0.7862873499999999, 25.009139631043254),
            "tas": (11915, 0.80970575, 23.784894041124634), "sw": (11875, 0.81849845, 24.12416484210526)},
    "dijkstra": {"scu": (36726, 2.0280652, 19.32752872624299),
                 "tas": (66058, 2.7560681000000002, 14.602679993339187), "sw": (65212, 3.0204632, 16.211159295835124)},
    "aes": {"scu": (41008, 3.0202271499999997, 25.77739715421381),
            "tas": (41292, 3.02800275, 25.6660118788143), "sw": (41292, 3.03200835, 25.69996421825051)},
    "livermore6": {"scu": (23482, 1.1045573999999998, 16.463465207392893),
                   "tas": (30322, 1.3075188, 15.09239430116747), "sw": (29771, 1.4450851, 16.989008934869506)},
    "livermore2": {"scu": (9187, 0.6653234, 25.347032763687817),
                   "tas": (10835, 0.7049865, 22.772983387171205), "sw": (10796, 0.7155668000000001, 23.198256761763613)},
    "fft": {"scu": (6023, 0.4387437, 25.495649178150423),
            "tas": (6520, 0.4509388, 24.20683742331288), "sw": (6495, 0.4541194, 24.471407236335644)},
    "fann": {"scu": (91554, 6.50860255, 24.881609678441144),
             "tas": (111140, 6.98818445, 22.007059182112652), "sw": (110637, 7.1294489500000005, 22.554002119544094)},
    "mfcc": {"scu": (541949, 37.720900549999996, 24.36080736840551),
             "tas": (594886, 39.147425850000005, 23.03231047209045), "sw": (592047, 39.77291405, 23.51252504868701)},
    "pca": {"scu": (2206193, 75.84814655, 12.032878035829139),
            "tas": (2286506, 78.91995825, 12.080434246619077), "sw": (2278039, 98.41551115, 15.120649340287853)},
}  # fmt: skip
SIM_REL_TOL = 1e-12
SIM_POLICIES = ("scu", "tas", "sw")
# the fleet run: SIM_FLEET_JOBS barrier jobs of 8 and 16 cores over SIM_FLEET_SLOTS slots of
# 16 cores, Poisson arrivals at SIM_FLEET_RATE jobs a round, each capped at twice its cycles
# run alone; job SIM_FLEET_FAULTY's first attempt is stalled past its cap by a droop half way
# through, and the last three jobs come at a higher priority
SIM_FLEET_JOBS, SIM_FLEET_SLOTS, SIM_FLEET_RATE, SIM_FLEET_FAULTY = 12, 3, 0.05, 3


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


def attention_bound(b, h, kvh, sq, sk, d, causal, dtype_name, dv=None):
    """Bytes: q, k (d wide), v (dv wide) read once, out (dv wide) and lse
    written once.  Operations: ``attention_flops``."""
    dv = d if dv is None else dv
    size = 2 if dtype_name == "bfloat16" else 4
    nbytes = size * (d * (b * h * sq + b * kvh * sk) + dv * (b * kvh * sk + b * h * sq)) + 4 * b * h * sq
    return bound(nbytes, attention_flops(b, h, sq, sk, d, dv, causal), dtype_name)


def ssd_bound(b, s, h, p, n, chunk, dtype_name):
    """Bytes: x, dt, A, B, C read once; y and the final state written once."""
    size = 2 if dtype_name == "bfloat16" else 4
    nbytes = size * (2 * b * s * h * p + 2 * b * s * n) + 4 * (b * s * h + h + b * h * p * n)
    return bound(nbytes, ssd_flops(b, s, h, p, n, chunk), dtype_name)


def attention_at_shape(gen, b, s, h, kvh, d, with_plain, dv=None, tag="[kernels]", rel_tol=None) -> dict:
    """K1 through ``ops.flash_attention`` on the models' (b, s, h, d) layout,
    bf16, causal, on inputs drawn from ``gen``: checked against the plain
    version (and, with ``rel_tol``, its error's norm over the plain version's
    within it), then timed beside it, one SDPA call and the bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd, kernel_path
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref, attention_ref_lse

    def draw(*shape, dtype):
        return torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32).to(dtype)

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
    rel = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
    ref_lse = torch.cat([attention_ref_lse(qt[i : i + 1], kt[i : i + 1], causal=True) for i in rows])
    lse_err = (lse - ref_lse).abs().max().item()
    tol = KERNEL_TOL["bfloat16"]
    dims = f"d={d}" if dv == d else f"dqk={d} dv={dv}"
    if not torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol) or not lse_err <= 2e-3:
        raise SystemExit(f"flash_attention disagrees at b={b} s={s} h={h} kvh={kvh} {dims}: {err}, lse {lse_err}")
    if rel_tol is not None and not rel <= rel_tol:
        raise SystemExit(f"flash_attention at b={b} s={s} h={h} kvh={kvh} {dims}: the error's norm over the plain "
                         f"version's is {rel:.3e}, past {rel_tol:.3e}")
    del ref
    row = {"path": kernel_path(torch.bfloat16, d, dv), "max_abs_err": err, "rel_err": rel,
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
        print(f"{tag} SDPA refuses dqk={d} dv={dv}: {str(refused).splitlines()[0]}")
        row["library_ms"] = None
    row["bound_ms"], row["bound_by"] = attention_bound(b, h, kvh, s, s, d, True, "bfloat16", dv)
    flops = attention_flops(b, h, s, s, d, dv, True)
    plain = f"plain {row['plain_ms']:.3f} ms, " if with_plain else ""
    library = ("none" if row["library_ms"] is None else
               f"{row['library_ms']:.3f} ms ({row['ms'] / row['library_ms']:.2f}x)")
    print(f"{tag} flash_attention_fwd b={b} s={s} h={h} kvh={kvh} {dims} bf16 causal, {row['path']} path: "
          f"max_abs_err {err:.3e} (tol {tol:g}), rel {rel:.3e}"
          f"{'' if rel_tol is None else f' (tol {rel_tol:.3e})'}, lse err {lse_err:.3e}; kernel {row['ms']:.3f} ms "
          f"({flops / row['ms'] / 1e9:.1f} TFLOP/s, {row['bound_ms'] / row['ms'] * 100:.0f} % of the bound's "
          f"rate), {plain}library (SDPA) {library}, bound {row['bound_ms']:.3f} ms by {row['bound_by']}")
    return row


def check_attention_kernel(prompt_len: int, cfg, mla_cfg, d80_cfg, group_cfgs) -> dict:
    """Phase 3 for K1, the flash-attention forward.  Returns its entry of the
    kernels line: timed at ``cfg``'s serving shape, musicgen's heads,
    ``mla_cfg``'s MLA pair (qk 192, v 128) and ``d80_cfg``'s head dim 80; held
    to its plain version and timed at each of ``group_cfgs``' prefill shapes
    (llava's 7 and command-r's 12 q heads a kv head)."""
    import torch

    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd, kernel_path
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

    def at_full_size(b, h, kvh, d, with_plain, dv=None, rel_tol=None):
        return attention_at_shape(gen, b, prompt_len, h, kvh, d, with_plain, dv, rel_tol=rel_tol)

    # the shape the serving path gives it, then musicgen's heads at the same length,
    # deepseek's MLA pair (its prefill's shape) and stablelm's head dim 80
    serving = at_full_size(BATCH, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, with_plain=True,
                           rel_tol=FWD_REL_TOL)
    d64 = at_full_size(BATCH, *MUSICGEN_HEADS, with_plain=False)
    m = mla_cfg.mla
    mla = at_full_size(BATCH, mla_cfg.n_heads, mla_cfg.n_kv_heads, m.qk_nope_dim + m.qk_rope_dim,
                       with_plain=True, dv=m.v_head_dim)
    d80 = at_full_size(BATCH, d80_cfg.n_heads, d80_cfg.n_kv_heads, d80_cfg.resolved_head_dim, with_plain=True)
    # before llava and command-r serve: the first groups that do not divide 8 (bands of 2) and
    # that exceed it (bands of 1)
    groups = {c.name: at_full_size(BATCH, c.n_heads, c.n_kv_heads, c.resolved_head_dim, with_plain=False,
                                   rel_tol=FWD_REL_TOL)
              for c in group_cfgs}  # fmt: skip
    keys = ("path", "max_abs_err", "rel_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
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


def ssd_inputs(gen, b, s, h, p, n, x_dtype, dt_dtype):
    """K2's inputs drawn from ``gen`` as tests/test_kernels.py draws them."""
    import torch
    import torch.nn.functional as F

    def draw(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=gen.device) * scale).to(dtype)

    return (draw(b, s, h, p, scale=0.5, dtype=x_dtype),
            F.softplus(draw(b, s, h)).to(dt_dtype),
            -torch.exp(draw(h, scale=0.3)),
            draw(b, s, n, scale=0.3, dtype=x_dtype),
            draw(b, s, n, scale=0.3, dtype=x_dtype))  # fmt: skip


def ssd_ref32(x, dt, A, B, C, chunk):
    """K2's plain version on the same values widened to float32."""
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    return ssd_scan_ref(x.float(), dt.float(), A, B.float(), C.float(), chunk=chunk)


def ssd_at_shape(gen, b, s, h, p, n, chunk, tag="[kernels]"):
    """K2 at a serving path's shape (x, B, C bf16 from the conv, dt f32 from
    the softplus), on inputs drawn from ``gen``: checked against its plain
    version, then timed beside it and the bound.  Bound and TFLOP/s count the
    products at the kernel's own tile, the chunk it walks.  Returns (form,
    max_abs_err, ms, plain_ms, bound_ms, bound_by)."""
    import torch

    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_fwd
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    limit = ssd_kernel.cluster_limit(p, n, 0)
    form = ssd_kernel.scan_form(b, h, s, chunk, p, n, limit)
    x, dt, A, B, C = ssd_inputs(gen, b, s, h, p, n, torch.bfloat16, torch.float32)
    y, st = ssd_scan_fwd(x, dt, A, B, C, chunk=chunk)
    torch.cuda.synchronize()
    ry, rst = ssd_ref32(x, dt, A, B, C, chunk)
    scale = ry.abs().max().item()
    err = (y.float() - ry).abs().max().item()
    rel = ((y.float() - ry).abs() / (1 + ry.abs())).max().item()
    floor = (ry.to(torch.bfloat16).float() - ry).abs().max().item()
    st_err = (st - rst).abs().max().item()
    print(f"{tag} ssd_scan_fwd at the serving shape b={b} s={s} h={h} p={p} n={n} g=1 chunk={chunk} "
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
    print(f"{tag} ssd_scan_fwd at the serving shape b={b}, form {form.name}: kernel {ms:.3f} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s of {flops / 1e9:.1f} GFLOP at the tile of {ssd_kernel.TILE}, "
          f"{bound_ms / ms * 100:.1f} % of the bound's rate), plain {plain_ms:.3f} ms, library none (no "
          f"PyTorch call computes the SSD scan), bound {bound_ms:.4f} ms by {bound_by}")
    return form, err, ms, plain_ms, bound_ms, bound_by


def check_ssd_kernel(prompt_len: int, cfg) -> dict:
    """Phase 3 for K2, the SSD chunked scan.  Returns its entry of the kernels line."""
    import torch

    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_fwd

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)

    worst_bf16 = 0.0
    for b, s, h, p, n, chunk in SSD_SHAPES:
        for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            x, dt, A, B, C = ssd_inputs(gen, b, s, h, p, n, dtype, dtype)
            y, st = ssd_scan_fwd(x, dt, A, B, C, chunk=chunk)
            torch.cuda.synchronize()
            ry, rst = ssd_ref32(x, dt, A, B, C, chunk)
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

    # the shapes the serving path gives it: the batch of prompts (b h = 256
    # pairs: the sequential form) and one prompt alone (64 pairs: a
    # chunk-parallel form)
    s_cfg = cfg.ssm
    h = s_cfg.expand * cfg.d_model // s_cfg.head_dim
    s, p, n, chunk = prompt_len, s_cfg.head_dim, s_cfg.d_state, min(s_cfg.chunk, prompt_len)
    form, err, ms, plain_ms, bound_ms, bound_by = ssd_at_shape(gen, BATCH, s, h, p, n, chunk)
    form1, _, ms1, _, bound1, _ = ssd_at_shape(gen, 1, s, h, p, n, chunk)

    # jamba's SSD dims (p=64, n=16, 128 heads, chunk 128) at the same request
    b = BATCH
    jh, jp, jn, jchunk = JAMBA_SSD
    jx, jdt, jA, jB, jC = ssd_inputs(gen, b, s, jh, jp, jn, torch.bfloat16, torch.float32)
    jy, jst = ssd_scan_fwd(jx, jdt, jA, jB, jC, chunk=jchunk)
    torch.cuda.synchronize()
    jry, jrst = ssd_ref32(jx, jdt, jA, jB, jC, jchunk)
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


def attention_bwd_at_shape(gen, b, s, h, kvh, dqk, dv, tag="[kernels]", rel_tol=None) -> dict:
    """K1's backward kernel at one bf16 causal shape: against its plain
    version (``ops.attention_bwd``) on the same inputs, each gradient within
    ``BWD_TOL`` of its largest entry (and, with ``rel_tol``, its error's norm
    over the plain version's within ``rel_tol[grad]``), then timed in turns with SDPA's
    backward (a yardstick only) and the PyTorch FA-2 backward (the plain
    version, the route it replaced); its row for the kernels line."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd, flash_attention_fwd, kernel_bwd_path
    from repro_torch.kernels.flash_attention.ops import attention_bwd

    dev = torch.device("cuda")
    tol = BWD_TOL
    q, k, v, dout = (torch.randn(sh, generator=gen, device=dev).to(torch.bfloat16)
                     for sh in ((b, s, h, dqk), (b, s, kvh, dqk), (b, s, kvh, dv), (b, s, h, dv)))  # fmt: skip
    qt, kt, vt, dt = (x.transpose(1, 2) for x in (q, k, v, dout))
    out, lse = flash_attention_fwd(qt, kt, vt, causal=True)
    o = out.transpose(1, 2)

    def kernel():
        return flash_attention_bwd(qt, kt, vt, out, lse, dt, causal=True)

    def fa2():
        return attention_bwd(q, k, v, o, lse, dout, causal=True)

    got, want = kernel(), fa2()
    torch.cuda.synchronize()
    errs, rels = {}, {}
    for which, g, w in zip(("dq", "dk", "dv"), got, want):
        diff = g.transpose(1, 2).float() - w.float()
        errs[which] = diff.abs().max().item()
        rels[which] = (diff.norm() / w.float().norm()).item()
        del diff
        if not (torch.isfinite(g).all() and errs[which] <= tol * max(1.0, w.float().abs().max().item())):
            raise SystemExit(f"{tag} K1's backward kernel: {which} at b={b} s={s} h={h} kvh={kvh} dqk={dqk} dv={dv} "
                             f"strays from its plain version by {errs[which]} (tol {tol:g} of the largest entry)")
        if rel_tol is not None and not rels[which] <= rel_tol[which]:
            raise SystemExit(f"{tag} K1's backward kernel: {which} at b={b} s={s} h={h} kvh={kvh} dqk={dqk} dv={dv}: "
                             f"the error's norm over the plain version's is {rels[which]:.3e}, past "
                             f"{rel_tol[which]:.3e}")
    # a second call gives the same bits: dQ's shares are added in a fixed order
    again = kernel()
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise SystemExit(f"{tag} K1's backward kernel: two calls at b={b} s={s} h={h} kvh={kvh} dqk={dqk} dv={dv} "
                         "give other bits")
    del got, want, again
    # the device time of each launch of a call, by kernel (delta, the one
    # pass, dq's convert)
    _, _, _, profiled = _profiled(lambda: [kernel() for _ in range(3)])
    launch_ms = {re.search(r"flash_bwd_\w+(<[^>]*>)?", name).group(0): ms / count
                 for name, ms, count in profiled if "flash_bwd" in name}
    qs, ks, vs = (x.detach().clone().requires_grad_(True) for x in (qt, kt, vt))
    ref_out = None
    try:
        ref_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)

        def sdpa():
            return torch.autograd.grad(ref_out, (qs, ks, vs), dt, retain_graph=True)

        sdpa()
    except RuntimeError as refused:
        print(f"{tag} SDPA refuses dqk={dqk} dv={dv} with a backward: {str(refused).splitlines()[0]}")
        sdpa = None
    # in turns: kernel, SDPA, FA-2, then the reverse
    runs = [("kernel", kernel, BWD_ITERS), ("sdpa", sdpa, BWD_ITERS), ("fa2", fa2, FA2_ITERS)]
    times = {key: [] for key, _, _ in runs}
    for r in range(BWD_ROUNDS):
        for key, fn, iters in (runs if r % 2 == 0 else runs[::-1]):
            if fn is not None:
                times[key].append(time_ms(fn, iters=iters, warmup=1))
    bound_ms, bound_by = attention_bwd_bound(b, h, kvh, s, dqk, dv, "bfloat16")
    flops = 2.5 * attention_flops(b, h, s, s, dqk, dv, True)
    ms = min(times["kernel"])
    row = {"b": b, "s": s, "h": h, "kvh": kvh, "head_dims": [dqk, dv],
           "path": kernel_bwd_path(torch.bfloat16, dqk, dv), "max_abs_err": max(errs.values()),
           "two_calls_same_bits": True, "device_ms_by_launch": launch_ms,
           "max_abs_err_by_grad": errs, "rel_err_by_grad": rels, "ms": ms, "ms_turns": times["kernel"],
           "plain_ms": min(times["fa2"]), "plain_ms_turns": times["fa2"],
           "library_ms": min(times["sdpa"]) if times["sdpa"] else None, "library_ms_turns": times["sdpa"],
           "bound_ms": bound_ms, "bound_by": bound_by}  # fmt: skip
    sdpa_text = ("refused" if not times["sdpa"] else
                 f"{', '.join(f'{x:.3f}' for x in times['sdpa'])} ms (kernel {ms / row['library_ms']:.2f}x)")
    print(f"{tag} flash_attention_bwd b={b} s={s} h={h} kvh={kvh} dqk={dqk} dv={dv} bf16 causal, {row['path']} "
          f"kernels: against its plain version max_abs_err "
          + ", ".join(f"{w} {e:.3e} (rel {rels[w]:.3e})" for w, e in errs.items())
          + f" (tol {tol:g} of the largest entry{'' if rel_tol is None else '; rel within ' + str(rel_tol)}); kernel {', '.join(f'{x:.3f}' for x in times['kernel'])} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s counting 2.5x the forward's products, {bound_ms / ms * 100:.0f} % of "
          f"the bound's rate), PyTorch FA-2 backward {', '.join(f'{x:.3f}' for x in times['fa2'])} ms "
          f"(kernel {row['plain_ms'] / ms:.1f}x faster), SDPA's backward {sdpa_text}, bound {bound_ms:.3f} ms "
          f"by {bound_by} (in turns); two calls the same bits; device a launch: "
          + ", ".join(f"{name} {ms:.3f} ms" for name, ms in launch_ms.items()))
    del q, k, v, dout, qt, kt, vt, dt, out, lse, o, qs, ks, vs, ref_out
    torch.cuda.empty_cache()
    return row


def check_attention_backward(cfg, mla_cfg, d80_cfg) -> dict:
    """Phase 3 for K1's backward kernel (``flash_attention_bwd``) and the
    autograd Function around K1.  The Function's gradients against PyTorch's
    autograd of the plain version on the card, at ``GRAD_LEN`` tokens,
    causal, one backward launch a gradient: bf16 at ``cfg``'s (phi4: 24 / 8
    heads of 128), ``mla_cfg``'s (qk 192, v 128) and ``d80_cfg``'s (32
    heads of 80) head dims and at ``cfg``'s heads of ``WIDE_BWD_DIMS`` (160,
    the widest square instance), and phi4's in float32.  Then, at b=1 (b =
    ``WIDE_BWD_BATCH`` at 160), ``PROMPT_LEN`` tokens (the training shape)
    and each of those head dims, the kernel against its plain version
    (``ops.attention_bwd``) on the same inputs, two calls the same bits,
    and timed in turns with SDPA's backward (a yardstick only) and the
    PyTorch FA-2 backward (``ops.attention_bwd``, the route it replaced;
    :func:`attention_bwd_at_shape`).  Returns the kernel's entry for the
    kernels line."""
    import torch

    from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd, kernel_bwd_path
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)
    m = mla_cfg.mla
    dims = {"phi4": (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.resolved_head_dim),
            "mla": (mla_cfg.n_heads, mla_cfg.n_kv_heads, m.qk_nope_dim + m.qk_rope_dim, m.v_head_dim),
            "d80": (d80_cfg.n_heads, d80_cfg.n_kv_heads, d80_cfg.resolved_head_dim, d80_cfg.resolved_head_dim),
            "d160": (cfg.n_heads, cfg.n_kv_heads) + WIDE_BWD_DIMS}
    timed_batch = {"d160": WIDE_BWD_BATCH}

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

    for name in dims:
        h, kvh, dqk, dv = dims[name]
        b = timed_batch.get(name, 1)
        rel_tol = BWD_REL_TOL if name in ("phi4", "mla", "d160") else None
        entry["timed"].append({"dims": name, **attention_bwd_at_shape(gen, b, PROMPT_LEN, h, kvh, dqk, dv,
                                                                      rel_tol=rel_tol)})
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
    # bytes: the n arrival words read once, the n counts written once; operations: the n - 1 adds
    # of the one sum that every party gets
    k3_bound, k3_by = bound(8 * n, n - 1, "float32")
    floor = scu.cluster_floor_ms(n, 2)
    print(f"[kernels] scu_barrier at n={n} (one word a party), {k3_form} form: kernel {k3_ms * 1e3:.2f} us a call, "
          f"library (sum + expand) {k3_library * 1e3:.2f} us ({k3_ms / k3_library:.2f}x), plain "
          f"{k3_plain * 1e3:.2f} us, bound {k3_bound * 1e3:.2e} us by {k3_by}; latency floor one launch of a "
          f"cluster of {n} CTAs with two cluster.sync() {floor * 1e3:.2f} us")
    wide = torch.ones(most, device=dev)
    wide_ms = time_ms(lambda: scu.scu_barrier(wide), iters=200, warmup=5)
    wide_library = time_ms(lambda: wide.sum(0, keepdim=True).expand_as(wide), iters=200, warmup=5)
    wide_bound, wide_by = bound(8 * most, most - 1, "float32")
    print(f"[kernels] scu_barrier at n={most} (dissemination form): kernel {wide_ms * 1e3:.2f} us a call, library "
          f"(sum + expand) {wide_library * 1e3:.2f} us ({wide_ms / wide_library:.2f}x), bound {wide_bound * 1e3:.2e} us "
          f"by {wide_by}")

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
         "bound_by": k3_by, "library_ms": k3_library, "form": k3_form,
         "largest_group": {"n": most, "form": "dissemination", "ms": wide_ms, "bound_ms": wide_bound,
                           "bound_by": wide_by, "library_ms": wide_library}},
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


def engine_against_the_card() -> int:
    """(a) of the sim phase: every parity program with no SCU rows on the port's
    engine (lockstep and fastforward) and on the card; returns how many ran."""
    from repro_torch.core.scu import SCU, T_SCU, Cluster
    from repro_torch.core.scu.engine import _COUNTERS
    from repro_torch.core.scu.trace_exec import run_traces_torch

    ran = 0
    for name, (make, n_banks) in trace_parity_programs().items():
        if not all(p.is_traced and all(r[0] != T_SCU for r in p.rows) for p in make()):
            continue
        runs = []
        for mode in ("lockstep", "fastforward"):
            programs = make()
            cl = Cluster(n_cores=len(programs), scu=SCU(n_cores=len(programs)), mode=mode)
            if cl.n_banks != n_banks:
                raise SystemExit(f"[sim] {name}: the engine has {cl.n_banks} banks, the card's run {n_banks}")
            cl.load(programs)
            runs.append((cl, cl.run()))
        gpu = run_traces_torch(make(), n_banks=n_banks)
        for cl, st in runs:
            fields = {"cycles": gpu["cycles"] == st.cycles, "bank conflicts": gpu["bank_conflicts"] == st.bank_conflicts,
                      "finish cycles": gpu["finished_at"].tolist() == [c.finished_at for c in st.cores],
                      "words": set(cl.tcdm) <= set(gpu["tcdm"])
                      and gpu["tcdm"] == {a: cl.tcdm.get(a, 0) for a in gpu["tcdm"]}}  # fmt: skip
            fields.update({k: gpu["counters"][k].tolist() == [getattr(c, k) for c in st.cores] for k in _COUNTERS})
            wrong = [k for k, same in fields.items() if not same]
            if wrong:
                raise SystemExit(f"[sim] {name}: the card differs from the port's engine ({cl.mode}) in {wrong}")
        print(f"[sim] {name}: the card = the port's engine in lockstep and fastforward on cycles, bank conflicts, "
              f"the nine counters, finish cycles and words ({runs[0][1].cycles} cycles)")
        ran += 1
    return ran


def kernel_launches() -> dict:
    """The launch count of every kernel wrapper in this process."""
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.scu_barrier import kernel as scu_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel

    return {"flash_attention_fwd": flash_kernel.flash_attention_fwd.launches,
            "flash_attention_bwd": flash_kernel.flash_attention_bwd.launches,
            "ssd_scan_fwd": ssd_kernel.ssd_scan_fwd.launches, "scu_barrier": scu_kernel.scu_barrier.launches,
            "scu_notifier": scu_kernel.scu_notifier.launches, "scu_self_signal": scu_kernel.scu_self_signal.launches}


def in_worker(fn, *args):
    """A worker of the sim phase: ``fn(*args)`` and the worker's kernel launches."""
    return fn(*args), kernel_launches()


def run_one_app(name: str, variant: str, mode: str = "fastforward"):
    """One app of Table 2 under one policy: ``run_app``'s ``AppResult``."""
    from repro_torch.core.scu import APPS, run_app

    return run_app(APPS[name], variant, mode=mode)


def barrier_table() -> dict:
    """Table 1's barrier row of the sim phase: ``prim_cycles`` of scu and sw at 2, 4 and 8 cores."""
    from repro_torch.core.scu import run_barrier_bench

    scu = [run_barrier_bench("scu", n, 0, iters=64).prim_cycles for n in (2, 4, 8)]
    sw = [run_barrier_bench("sw", n, 0, iters=64).prim_cycles for n in (2, 4, 8)]
    print(f"[sim] Table 1, barrier prim_cycles at 2, 4 and 8 cores (64 iterations): scu {scu}, sw {sw}")
    if not (max(scu) - min(scu) < 1.0 and sw[2] > 3 * sw[0]):
        raise SystemExit("[sim] Table 1's shape: scu is not flat in the core count or sw not over 3x from 2 to 8")
    return {"scu": scu, "sw": sw}


def app_table(results: dict, apps_s: float) -> dict:
    """Table 2 / Fig. 6 of the sim phase from ``results[(app, policy)]``: prints it and
    the gains, and checks the cycles against the reference's and the paper's claims."""
    rows = {}
    print("[sim] Table 2 / Fig. 6 (8 cores, seed 0): app, then cycles, energy uJ and power mW under "
          + ", ".join(SIM_POLICIES) + "; the SCU's cycle and energy gains over sw")
    for name, want in SIM_APP_REFERENCE.items():
        res = {v: results[(name, v)] for v in SIM_POLICIES}
        scu_r, sw_r = res["scu"], res["sw"]
        gain, egain = sw_r.cycles / scu_r.cycles, sw_r.energy_uj / scu_r.energy_uj
        rows[name] = {"cycles": {v: r.cycles for v, r in res.items()}, "energy_uj": {v: r.energy_uj for v, r in res.items()},
                      "power_mw": {v: r.power_mw for v, r in res.items()}, "gain": gain, "energy_gain": egain}  # fmt: skip
        print(f"[sim]   {name:10s} " + "  ".join(f"{v} {r.cycles} {r.energy_uj:.4f} uJ {r.power_mw:.3f} mW"
                                             for v, r in res.items()) + f"  gains {gain:.4f}x {egain:.4f}x")
        for v, r in res.items():
            cycles, energy_uj, power_mw = want[v]
            if r.cycles != cycles or not all(abs(got - ref) <= SIM_REL_TOL * abs(ref)
                                             for got, ref in ((r.energy_uj, energy_uj), (r.power_mw, power_mw))):
                raise SystemExit(f"[sim] {name} under {v}: (cycles, energy uJ, power mW) "
                                 f"{(r.cycles, r.energy_uj, r.power_mw)}, the reference's {want[v]}")
        if not (scu_r.cycles <= sw_r.cycles and scu_r.energy_uj <= 1.01 * sw_r.energy_uj):
            raise SystemExit(f"[sim] {name}: scu takes more cycles than sw or over 1.01 x its energy")
    gains = {k: r["gain"] for k, r in rows.items()}
    egains = {k: r["energy_gain"] for k, r in rows.items()}
    top, etop = max(gains, key=gains.get), max(egains, key=egains.get)
    mean, emean = sum(gains.values()) / len(gains), sum(egains.values()) / len(egains)
    print(f"[sim] gains of scu over sw: cycles mean {mean:.4f}x ({100 * (mean - 1):.1f} %), max {gains[top]:.4f}x "
          f"({top}); energy mean {emean:.4f}x ({100 * (emean - 1):.1f} %), max {egains[etop]:.4f}x ({etop}); "
          f"{len(rows)} apps x {len(SIM_POLICIES)} policies in {apps_s:.1f} s in worker processes (paper: up to "
          f"92 % and 23 % on average in performance, 98 % and 39 % in energy); every cycle count the reference's, "
          f"every energy and power within {SIM_REL_TOL:g} of it")
    return {"apps": rows, "mean_gain": mean, "max_gain": [top, gains[top]], "mean_energy_gain": emean}


def fleet_run() -> dict:
    """(c) of the sim phase: a Poisson stream of barrier jobs through a
    ``FleetService`` with checkpoints, preemption and one fault plan (run in a
    worker process: its line is returned, under ``"line"``, and printed by the caller)."""
    from repro_torch.core.scu import FaultEvent, FaultPlan, prep_barrier_bench
    from repro_torch.serve.arrivals import poisson_trace
    from repro_torch.serve.fleet_service import CheckpointPolicy, FleetService, RetryPolicy
    from repro_torch.sync import available_policies

    policies = available_policies()

    def job_config(i: int, attempt: int = 0, cap: int = 10_000_000):
        n = 16 if i % 3 == 2 else 8
        config = prep_barrier_bench(policies[i % len(policies)], n, sfr=13 * (i % 5), iters=24 + 8 * (i % 4),
                                    compiled=True).config  # fmt: skip
        config.max_cycles = cap
        if i == SIM_FLEET_FAULTY and attempt == 1:
            config.cluster.faults = FaultPlan([FaultEvent("droop", cycle=cap // 4, cores=tuple(range(n)),
                                                          span=10 * cap, domain="d0")])  # fmt: skip
        return config

    alone = []  # each job run uninterrupted, on its own cluster
    for i in range(SIM_FLEET_JOBS):
        config = job_config(i)
        config.cluster.load(config.programs)
        alone.append(config.cluster.run(config.max_cycles))
    caps = [2 * st.cycles for st in alone]

    arrivals = poisson_trace(SIM_FLEET_RATE, SIM_FLEET_JOBS, seed=0)
    svc = FleetService(SIM_FLEET_SLOTS, 16, admission_order="priority", preempt=True,
                       retry=RetryPolicy(max_attempts=2, backoff_rounds=0), checkpoint=CheckpointPolicy(4))
    jobs, i = [], 0
    while i < SIM_FLEET_JOBS or svc.pending or svc.fleet.occupied:
        while i < SIM_FLEET_JOBS and arrivals[i] <= svc.round:
            jobs.append(svc.submit(factory=lambda attempt, i=i: job_config(i, attempt, caps[i]),
                                   priority=5 if i >= SIM_FLEET_JOBS - 3 else 0))
            i += 1
        svc.step()
        if svc.round > 1_000_000:
            raise SystemExit("[sim] the fleet service did not drain")
    if not all(j.state == "done" and j.error is None for j in jobs):
        raise SystemExit(f"[sim] fleet jobs not done: {[(j.job_id, j.state, j.error) for j in jobs if j.state != 'done']}")
    interrupted = [j for j in jobs if j.preemptions or j.fault_log]
    for j in jobs:
        if alone[j.job_id] != j.stats:
            raise SystemExit(f"[sim] fleet job {j.job_id} (preempted {j.preemptions}, failed attempts "
                             f"{len(j.fault_log)}): its stats differ from the job run uninterrupted")
    preempted = sum(1 for j in jobs if j.preemptions)
    resumed = sum(1 for j in jobs if j.fault_log)
    faulty = jobs[SIM_FLEET_FAULTY]
    if not (len(faulty.fault_log) == 1 and 0 < faulty.wasted_cycles < caps[SIM_FLEET_FAULTY]):
        raise SystemExit(f"[sim] fleet job {SIM_FLEET_FAULTY}: {len(faulty.fault_log)} failed attempts, "
                         f"{faulty.wasted_cycles} wasted cycles; one attempt, resumed from a checkpoint, was expected")
    if not (preempted and resumed):
        raise SystemExit(f"[sim] the fleet run suspended {preempted} jobs and resumed {resumed} from a checkpoint; "
                         "it must do both to check restores")
    line = (f"[sim] fleet: {len(jobs)} barrier jobs ({', '.join(policies)}; 8 and 16 cores) over {SIM_FLEET_SLOTS} "
            f"slots of 16 cores, Poisson arrivals at {SIM_FLEET_RATE} a round (rounds {arrivals[0]}..{arrivals[-1]}), "
            f"{sum(st.cycles for st in alone)} cycles run alone, checkpoints every 4 rounds: every job done in "
            f"{svc.round} rounds, idle lanes {svc.idle_lane_fraction:.4f}; {preempted} preempted ({svc.preemptions} "
            f"preemptions) and {resumed} resumed from a checkpoint after a timed-out attempt (wasted cycles "
            f"{sum(j.wasted_cycles for j in jobs)}), each job's stats = the job run uninterrupted")
    return {"jobs": len(jobs), "rounds": svc.round, "preempted": preempted, "resumed": resumed,
            "interrupted": len(interrupted), "line": line}


def sim_phase(card: str) -> dict:
    """The sim phase (see the module note).  The 27 app runs of Table 2 and
    the fleet run go to worker processes (spawned: they import the port),
    longest first, while this process runs (a) and Table 1.  Each worker
    returns the kernels' launch counts of its own process, which must be 0."""
    import multiprocessing
    import os

    t_phase = time.perf_counter()
    workers = max(1, min(8, os.cpu_count() or 1))
    with concurrent.futures.ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        # pca and mfcc take most of the time (Table 2's cycles under sw)
        order = sorted(SIM_APP_REFERENCE, key=lambda name: -SIM_APP_REFERENCE[name]["sw"][0])
        futures = {(name, v): pool.submit(in_worker, run_one_app, name, v) for name in order[:1] for v in SIM_POLICIES}
        fleet_future = pool.submit(in_worker, fleet_run)
        futures.update({(name, v): pool.submit(in_worker, run_one_app, name, v) for name in order[1:]
                        for v in SIM_POLICIES})  # fmt: skip
        lockstep = {(name, v): pool.submit(in_worker, run_one_app, name, v, "lockstep") for name in ("dwt", "fft")
                    for v in SIM_POLICIES}  # fmt: skip
        parity = engine_against_the_card()
        table1 = barrier_table()
        launched = {}

        def result(future, what):
            got, launches = future.result()
            launched.update({f"{name} in {what}": n for name, n in launches.items() if n})
            return got

        fleet = result(fleet_future, "the fleet run")
        print(fleet.pop("line"))
        results = {key: result(f, f"{key[0]} under {key[1]}") for key, f in futures.items()}
        apps_s = time.perf_counter() - t_phase
        for key, f in lockstep.items():
            if dataclasses.asdict(result(f, f"{key[0]} under {key[1]}, lockstep")) != dataclasses.asdict(results[key]):
                raise SystemExit(f"[sim] {key[0]} under {key[1]}: lockstep and fastforward differ")
    if launched:
        raise SystemExit(f"[sim] kernels launched in the sim phase's workers: {launched}")
    print(f"[sim] dwt and fft under {', '.join(SIM_POLICIES)}: lockstep = fastforward on every AppResult field")
    paper = app_table(results, apps_s)
    phase_s = time.perf_counter() - t_phase
    print(f"[sim] {card}: {parity} parity programs, the paper's tables and one fleet run; no kernel launch in "
          f"the {len(futures) + len(lockstep) + 1} worker runs; phase {phase_s:.1f} s of host time ({workers} worker "
          f"processes)")
    return {"parity_programs": parity, "table1": table1, "paper": paper, "fleet": fleet, "phase_s": phase_s}


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


def pinned_routing(idx_list: list, own: list = None):
    """Within the block, the MoE layers take, in their order, the expert ids
    of ``idx_list`` ((T, K) each), with their router's own weights for them;
    the ids the router would have chosen, sorted per token, are appended to
    ``own`` where it is given."""
    import torch

    from repro_torch.models.layers import moe as moe_mod

    pinned_ids = iter(idx_list)
    kept = moe_mod.router_topk

    def pinned(logits, m):
        idx = next(pinned_ids)
        if own is not None:
            own.append(kept(logits, m)[1].sort(dim=-1).values)
        weights = torch.softmax(logits.float(), dim=-1).gather(-1, idx)
        if m.router_norm_topk:
            weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
        return weights, idx

    return _swapped(moe_mod, "router_topk", pinned)


def routing_differ(a: list, b: list) -> tuple:
    """(how many (token, layer) routings of two runs differ, of how many)."""
    return sum(int((x != y).any(-1).sum()) for x, y in zip(a, b)), sum(x.shape[0] for x in a)


def routing_gap(a: list, b: list) -> str:
    if not a:
        return "no MoE layer"
    differ, total = routing_differ(a, b)
    return f"{differ} of {total} token-layer top-k sets differ"


@contextlib.contextmanager
def recorded_kernel_shapes(into: dict):
    """Within the block, the shapes and types the models' layers hand K1 and
    K2 (through their wrappers, whose launches count as before) are added to
    ``into[kernel name]``, a set."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models.layers import attention as attention_mod

    attend, scan = attention_mod.flash_attention, ssd_ops.ssd_scan

    def described(*tensors):
        return tuple((tuple(t.shape), str(t.dtype).removeprefix("torch.")) for t in tensors)

    def attention(q, k, v, *, causal=True):
        into.setdefault("flash_attention_fwd", set()).add(described(q, k, v) + (causal,))
        return attend(q, k, v, causal=causal)

    def ssd(x, dt, A, B, C, *, chunk, initial_state=None):
        into.setdefault("ssd_scan_fwd", set()).add(described(x, dt, A, B, C) + (chunk, initial_state is None))
        return scan(x, dt, A, B, C, chunk=chunk, initial_state=initial_state)

    with _swapped(attention_mod, "flash_attention", attention), _swapped(ssd_ops, "ssd_scan", ssd):
        yield


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
                        check_layers=None, offload=False, tokens_into=None) -> tuple:
    """Phase 4 for one model: returns the kernels' launches in its served
    request and its decode graph's numbers (``graph_against_eager``).

    The checks against the plain path and a float32 model run on the served
    model's first ``check_layers`` layers (all of them where None), moved to
    the host while its float32 copy is on the card where ``offload`` says.
    A cut is drawn alone, before the served model: ``init_lm`` draws group by
    group from one generator, so its weights are the served model's first
    layers.  The served request decodes through the graph and nothing else
    (``graph_only``).  ``one_sequence``, where given, is then called with the
    model.  ``tokens_into``, where given, receives the served request's
    tokens under the model's name (the model phase's model = 1 run)."""
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
    if tokens_into is not None:
        tokens_into[cfg.name] = result["tokens"].cpu()
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
    (the forward, then the group's forward again in the backward), once for
    a prelude layer (deepseek's dense first layer, which no group holds and
    remat does not recompute), and K1's backward once for each attention
    layer."""
    from repro_torch.models.blocks import prelude_layers

    forward = expected_launches(cfg)
    pre = prelude_layers(cfg)
    again = expected_launches(dataclasses.replace(cfg, n_layers=cfg.n_layers - pre)) if pre else forward
    if pre and any(cfg.layer_kind(i) != cfg.layer_kind(i + pre) for i in range(cfg.n_layers - pre)):
        raise ValueError(f"{cfg.name}: the layer kinds after the prelude are not the model's own, shifted")
    return {"flash_attention_fwd": forward["flash_attention_fwd"] + again["flash_attention_fwd"],
            "ssd_scan_fwd": forward["ssd_scan_fwd"] + again["ssd_scan_fwd"],
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


def zero_gradients(handed) -> list:
    """The leaves of a gradient tree, and the groups of a stacked block leaf,
    that are not finite or are zero throughout: ``(key, index, shape)`` each."""
    import torch

    from repro_torch.train.optimizer import tree_leaves

    bad = []
    for key in sorted(handed):
        for k, g in enumerate(tree_leaves(handed[key])):
            rows = g.flatten(1) if key == "blocks" else g.reshape(1, -1)
            if not (torch.isfinite(g).all() and (rows.abs().amax(1) > 0).all()):
                bad.append((key, k, tuple(g.shape)))
    return bad


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
            bad, n_leaves = zero_gradients(handed[0]), len(tree_leaves(handed[0]))
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
            opt_state = init_opt_state(params, None if isinstance(step_mesh, dict) else in_sh)
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


def join_two_on_one_card(rank: int, world: int, work: Path, out: dict):
    """Join a rank of the two that share the card: NCCL first, as
    ``init_distributed`` takes it for a card (it refuses a second rank on the
    device, and the refusal goes into ``out["nccl"]``), then an explicit
    ``gloo`` group over CUDA tensors.  Returns the ``{"data": 1, "model":
    world}`` ``DeviceMesh``; TF32 matmuls off, as in the parent."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import device_mesh
    from repro_torch.parallel.dist import init_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    try:
        init_distributed(dev, rank=rank, world=world, init_method=f"file://{work / 'nccl_rendezvous'}", timeout=60)
        probe = torch.ones(1, device=dev)
        dist.all_reduce(probe)
        torch.cuda.synchronize()
        out["nccl"] = f"accepted: {probe.item()}"
    except Exception as err:  # the refusal is the finding: its first and last lines are printed
        lines = str(err).strip().splitlines()
        out["nccl"] = f"{type(err).__name__}: {lines[0][:200]} ... {lines[-1][:200]}"
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    init_distributed(dev, rank=rank, world=world, init_method=f"file://{work / 'gloo_rendezvous'}",
                     timeout=MODEL_TIMEOUT_S, backend="gloo")  # fmt: skip
    mesh = device_mesh({"data": 1, "model": world}, dev)
    out["backend"] = dist.get_backend()
    out["coords"] = list(mesh.get_coordinate())
    return mesh


def two_ranks_on_one_card(target, work: Path, timeout: float, tag: str) -> list:
    """``target(rank, MODEL_RANKS, str(work))`` in each of ``MODEL_RANKS``
    spawned processes; each rank's results from ``work/rank<r>.json``.  A
    rank that fails (``rank<r>.err``), a non-zero exit or a rank still
    running after ``timeout`` fails the phase, and no process outlives this
    call."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(rank, MODEL_RANKS, str(work))) for rank in range(MODEL_RANKS)]
    try:
        for proc in procs:
            proc.start()
        deadline = time.monotonic() + timeout
        for proc in procs:
            proc.join(max(0.0, deadline - time.monotonic()))
        hung = [rank for rank, proc in enumerate(procs) if proc.is_alive()]
        errors = {rank: (work / f"rank{rank}.err").read_text() for rank in range(MODEL_RANKS)
                  if (work / f"rank{rank}.err").exists()}  # fmt: skip
        if hung or errors or any(proc.exitcode != 0 for proc in procs):
            raise SystemExit(f"{tag} the two processes failed: exit codes {[proc.exitcode for proc in procs]}, "
                             f"still running after {timeout} s: {hung}; errors: {errors}")
        return [json.loads((work / f"rank{rank}.json").read_text()) for rank in range(MODEL_RANKS)]
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.terminate()
                proc.join(10)
                if proc.is_alive():
                    proc.kill()
                    proc.join(10)


def model_axis_rank(rank: int, world: int, workdir: str) -> None:
    """One process of the model phase (see the module note): its results, or
    its traceback, in ``workdir`` as ``rank<r>.json`` / ``rank<r>.err``."""
    import traceback

    sys.path.insert(0, str(ROOT / "src"))
    work = Path(workdir)
    try:
        import torch
        import torch.distributed as dist

        from repro_torch.configs.registry import get_config
        from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
        from repro_torch.kernels.ssd_scan.kernel import ssd_scan_fwd
        from repro_torch.launch.serve import make_inputs, serve
        from repro_torch.models.lm import init_lm
        from repro_torch.parallel.sharding import param_shardings
        from repro_torch.serve.decode import CausalLM
        from repro_torch.train.step import abstract_params

        dev = torch.device("cuda", 0)
        out = {"rank": rank}
        mesh = join_two_on_one_card(rank, world, work, out)

        def launches():
            return {"flash_attention_fwd": flash_attention_fwd.launches, "ssd_scan_fwd": ssd_scan_fwd.launches}

        def draw(cfg, dtype):
            shardings = param_shardings(abstract_params(cfg, dtype), mesh, cfg)
            params = init_lm(torch.Generator(device=dev).manual_seed(0), cfg, dtype, shardings=shardings)
            return CausalLM(cfg, params, shardings)

        quiet = dict(log=lambda *a: None, mesh=mesh)
        for arch in MODEL_ARCHS:
            # (a) float32 at a cut depth, the routing pinned to the model = 1 run's and
            # the router's own choices counted
            layers, prompt = MODEL_F32[arch]
            cfg = dataclasses.replace(get_config(arch), n_layers=layers, dtype="float32")
            ref = torch.load(work / f"ref_{arch}.pt")
            model = draw(cfg, torch.float32)
            inputs = make_inputs(cfg, MODEL_F32_BATCH, prompt, torch.Generator(device=dev).manual_seed(1))
            pins, own = [r.to(dev) for r in ref["routing"]], []
            flash_attention_fwd.launches = ssd_scan_fwd.launches = 0
            with eager_launchers(), pinned_routing(pins, own):
                got = serve(model, inputs, MODEL_F32_GEN, **quiet)
            scale = max(ref["prefill_logits"].abs().max().item(), ref["last_logits"].abs().max().item())
            gap = max((got["prefill_logits"].cpu() - ref["prefill_logits"]).abs().max().item(),
                      (got["last_logits"].cpu() - ref["last_logits"]).abs().max().item())  # fmt: skip
            out[arch] = {"f32": {"layers": layers, "prompt": prompt, "gap": gap, "scale": scale,
                                 "tokens_equal": bool(torch.equal(got["tokens"].cpu(), ref["tokens"])),
                                 "launches": launches(), "routing_differ": list(routing_differ(own, pins))}}  # fmt: skip
            del model, got, inputs
            torch.cuda.empty_cache()

            # (b) bf16 at full width and depth: the serve phase's request, eager decode
            cfg = get_config(arch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model = draw(cfg, torch.bfloat16)
            torch.cuda.synchronize()
            draw_s = time.perf_counter() - t0
            held = sum(t.numel() for t in model.buffers())
            inputs = make_inputs(cfg, BATCH, PROMPT_LEN, torch.Generator(device=dev).manual_seed(1))
            torch.cuda.reset_peak_memory_stats()
            shapes = {}
            flash_attention_fwd.launches = ssd_scan_fwd.launches = 0
            with eager_launchers(), recorded_kernel_shapes(shapes):
                got = serve(model, inputs, GEN, **quiet)
            counted = launches()
            peak = torch.cuda.max_memory_allocated() / 2**30
            served = torch.load(work / f"bf16_tokens_{arch}.pt")
            tokens = got["tokens"].cpu()
            out[arch]["bf16"] = {
                "draw_s": draw_s, "params_held": held, "prefill_s": got["prefill_s"],
                "step_ms": got["decode_s"] / GEN * 1e3, "peak_gib": peak, "launches": counted,
                "agree": float((tokens == served).float().mean()) if tokens.shape == served.shape else 0.0,
                "first_differ": [next((i for i in range(tokens.shape[1]) if tokens[r, i] != served[r, i]), None)
                                 for r in range(tokens.shape[0])] if tokens.shape == served.shape else None,
                "shapes_ok": got["prefill_logits"].shape == (BATCH, cfg.vocab_size) and tokens.shape == (BATCH, GEN + 1),
                "finite": bool(torch.isfinite(got["prefill_logits"]).all() and torch.isfinite(got["last_logits"]).all()),
                "in_vocab": bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
                "kernel_shapes": {name: sorted(seen) for name, seen in shapes.items()},
            }  # fmt: skip
            del model, got, inputs
            torch.cuda.empty_cache()
        dist.barrier()
        dist.destroy_process_group()
        (work / f"rank{rank}.json").write_text(json.dumps(out))
    except BaseException:
        (work / f"rank{rank}.err").write_text(traceback.format_exc())
        sys.exit(1)


def held_at_recorded_shape(gen, name: str, shape, tag: str) -> tuple:
    """K1 or K2 held to its plain version at the [kernels] tolerances, and
    timed, at a ``shape`` that ``recorded_kernel_shapes`` recorded, on inputs
    drawn from ``gen``.  Returns (row, None), or (None, why it is not
    covered)."""
    if name == "flash_attention_fwd":
        (q, q_t), (k, k_t), (v, v_t), causal = shape
        if {q_t, k_t, v_t} != {"bfloat16"} or not causal:
            return None, f"K1 given {shape}; the check covers causal bf16 only"
        b, s, h, d = q
        row = attention_at_shape(gen, b, s, h, k[2], d, True, v[3], tag=tag)
        row["shape"] = {"b": b, "s": s, "h": h, "kvh": k[2], "dqk": d, "dv": v[3]}
        return row, None
    (x, x_t), (dt, dt_t), _, (B, B_t), (C, C_t), chunk, fresh = shape
    if (x_t, dt_t, B_t, C_t) != ("bfloat16", "float32", "bfloat16", "bfloat16") or not fresh:
        return None, f"K2 given {shape}; the check covers the serving types from a zero state"
    b, s, h, p = x
    form, err, ms, plain_ms, bound_ms, bound_by = ssd_at_shape(gen, b, s, h, p, B[3], chunk, tag=tag)
    return {"form": form.name, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "shape": {"b": b, "s": s, "h": h, "p": p, "n": B[3], "chunk": chunk}}, None  # fmt: skip


def model_axis_kernels(ranks: list) -> tuple:
    """K1 and K2 held to their plain versions, and timed, at every shape and
    type that a rank's bf16 run handed them (``kernel_shapes``), on inputs
    drawn here; each kernel that a model's prefill launches must have been
    seen.  Returns ({arch: {kernel: row}}, failures)."""
    import torch

    from repro_torch.configs.registry import get_config

    gen = torch.Generator(device=torch.device("cuda")).manual_seed(13)
    rows, failures = {}, []
    for arch in MODEL_ARCHS:
        seen = [r[arch]["bf16"]["kernel_shapes"] for r in ranks]
        for name in sorted(set().union(*seen)):
            shapes = {json.dumps(shape) for by_rank in seen for shape in by_rank.get(name, [])}
            if len(shapes) != 1:
                failures.append(f"{arch}: the ranks handed {name} {len(shapes)} shapes, not one: {sorted(shapes)}")
                continue
            launches = [r[arch]["bf16"]["launches"][name] for r in ranks]
            row, why = held_at_recorded_shape(gen, name, json.loads(shapes.pop()), "[model]")
            if why is not None:
                failures.append(f"{arch}: {why}")
                continue
            rows.setdefault(arch, {})[name] = {"launches": launches, **row}
            print(f"[model] {arch}: {name} held to its plain version at the shape each rank gave it "
                  f"{row['shape']}, launched {launches} times by rank")
        unseen = [name for name, n in expected_launches(get_config(arch)).items() if n and name not in rows.get(arch, {})]
        if unseen:
            failures.append(f"{arch}: no shape recorded for {unseen}")
    return rows, failures


def model_axis_on_one_card(card: str, served_tokens: dict) -> dict:
    """The model phase (see the module note): the float32 references at
    model = 1 through the plain versions here, then the two processes, then
    K1 and K2 at the shapes the ranks gave them; returns each model's
    numbers by rank and the kernels' rows.  Its work directory is gone at the
    end, failed or not, and no process it started outlives it."""
    import shutil
    import uuid

    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_fwd
    from repro_torch.launch.serve import make_inputs, serve
    from repro_torch.models.lm import init_lm
    from repro_torch.serve.decode import CausalLM

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    plain = {"phi4-mini-3.8b": plain_attention, "mamba2-1.3b": plain_ssd_scan, "deepseek-v2-lite-16b": plain_attention}
    work = ROOT / "build" / f"model_phase_{uuid.uuid4().hex[:8]}"
    work.mkdir(parents=True)
    try:
        for arch in MODEL_ARCHS:
            layers, prompt = MODEL_F32[arch]
            cfg = dataclasses.replace(get_config(arch), n_layers=layers, dtype="float32")
            model = CausalLM(cfg, init_lm(torch.Generator(device=dev).manual_seed(0), cfg, torch.float32))
            inputs = make_inputs(cfg, MODEL_F32_BATCH, prompt, torch.Generator(device=dev).manual_seed(1))
            routing = []
            flash_attention_fwd.launches = ssd_scan_fwd.launches = 0
            with eager_launchers(), recorded_routing(routing), plain[arch]():
                got = serve(model, inputs, MODEL_F32_GEN, log=lambda *a: None)
            if flash_attention_fwd.launches or ssd_scan_fwd.launches:
                raise SystemExit(f"[model] {arch}'s plain reference launched a kernel")
            torch.save({"prefill_logits": got["prefill_logits"].cpu(), "last_logits": got["last_logits"].cpu(),
                        "tokens": got["tokens"].cpu(), "routing": [r.cpu() for r in routing]},
                       work / f"ref_{arch}.pt")  # fmt: skip
            torch.save(served_tokens[arch], work / f"bf16_tokens_{arch}.pt")
            del model, got, inputs, routing
            torch.cuda.empty_cache()
        ref_s = time.perf_counter() - t_phase
        ranks = two_ranks_on_one_card(model_axis_rank, work, MODEL_TIMEOUT_S, "[model]")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    print(f"[model] {card}; {MODEL_RANKS} processes on the one card, {{'data': 1, 'model': {MODEL_RANKS}}}: NCCL "
          f"refused them ({ranks[0]['nccl']}), so they run in an explicit {ranks[0]['backend']!r} group over CUDA "
          f"tensors, whose all_reduce is every collective of the path; mesh coordinates "
          f"{[r['coords'] for r in ranks]}")
    failures = []
    for arch in MODEL_ARCHS:
        cfg = get_config(arch)
        want = expected_launches(cfg)
        f32_want = expected_launches(dataclasses.replace(cfg, n_layers=MODEL_F32[arch][0]))
        a = [r[arch]["f32"] for r in ranks]
        b = [r[arch]["bf16"] for r in ranks]
        tol = MODEL_TOL * max(1.0, a[0]["scale"])
        gaps = ", ".join(f"{x['gap']:.3e}" for x in a)
        differ = [x["routing_differ"] for x in a]
        routed = "" if not differ[0][1] else (
            f"; the router's own top-k sets at model = 2 that differ from model = 1's, by rank "
            f"{[f'{d} of {t}' for d, t in differ]} (at most {MODEL_ROUTING_DIFFER:.0%})")
        print(f"[model] {arch} float32 at {a[0]['layers']} layers, {MODEL_F32_BATCH} x {a[0]['prompt']}, "
              f"{MODEL_F32_GEN} eager steps (routing pinned to the model = 1 run's), model = 2 through the kernels "
              f"against model = 1 through the plain versions: logits' largest gap [{gaps}] by rank (tol {tol:.3e}, "
              f"{MODEL_TOL:g} of the largest logit {a[0]['scale']:.2f}), tokens equal "
              f"{[x['tokens_equal'] for x in a]}, kernel launches by rank {[x['launches'] for x in a]}{routed}")
        print(f"[model] {arch} whole ({cfg.n_layers} layers) in bf16 at model = 2, {BATCH} x {PROMPT_LEN}, {GEN} "
              f"eager steps, by rank: params held {[round(x['params_held'] / 1e9, 3) for x in b]} B of "
              f"{cfg.n_params() / 1e9:.3f} B (drawn leaf by leaf in {[round(x['draw_s'], 1) for x in b]} s), "
              f"prefill {[round(x['prefill_s'], 2) for x in b]} s, {[round(x['step_ms'], 1) for x in b]} ms a step, "
              f"peak {[round(x['peak_gib'], 2) for x in b]} GiB, kernel launches {[x['launches'] for x in b]}; "
              f"tokens agree with the model = 1 graph run of the serve phase at {b[0]['agree']:.3f} of "
              f"{BATCH} x {GEN + 1} (first differing step by row {b[0]['first_differ']}; bf16 partial sums round "
              f"otherwise, so this is printed, not checked)")
        for x in a:
            counted = {k: x["launches"][k] for k in ("flash_attention_fwd", "ssd_scan_fwd")}
            d, t = x["routing_differ"]
            if (not (x["gap"] <= tol and x["tokens_equal"]) or counted != {k: f32_want[k] for k in counted}
                    or d > MODEL_ROUTING_DIFFER * t):
                failures.append(f"{arch} float32: gap {x['gap']:.3e} (tol {tol:.3e}), tokens equal "
                                f"{x['tokens_equal']}, launches {counted} (want {f32_want}), routing differs at "
                                f"{d} of {t}")
        for x in b:
            counted = {k: x["launches"][k] for k in ("flash_attention_fwd", "ssd_scan_fwd")}
            if counted != {k: want[k] for k in counted} or not (x["shapes_ok"] and x["finite"] and x["in_vocab"]):
                failures.append(f"{arch} bf16: launches {counted} (want {want}), shapes {x['shapes_ok']}, finite "
                                f"{x['finite']}, tokens in the vocabulary {x['in_vocab']}")
    kernels, kernel_failures = model_axis_kernels(ranks)
    failures += kernel_failures
    phase_s = time.perf_counter() - t_phase
    print(f"[model] two processes time-slicing one card measure correctness and memory, not the speed of tensor "
          f"parallelism; references at model = 1 {ref_s:.1f} s, phase {phase_s:.1f} s")
    if failures:
        raise SystemExit("[model] " + "; ".join(failures))
    return {arch: {"f32": [r[arch]["f32"] for r in ranks], "bf16": [r[arch]["bf16"] for r in ranks]}
            for arch in MODEL_ARCHS} | {"phase_s": phase_s, "nccl": ranks[0]["nccl"], "kernels": kernels}


def model_alone() -> dict:
    """The model phase by itself, its model = 1 bf16 runs served here eagerly
    in place of the serve phase's graph runs (the same tokens: the serve
    phase holds the graph to the eager step token for token):
    ``python3 -c 'import chip_smoke; chip_smoke.model_alone()'``."""
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.compat import card_name_and_power_limit
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.launch.serve import make_inputs, serve
    from repro_torch.models.lm import init_lm
    from repro_torch.serve.decode import CausalLM

    with concurrent.futures.ThreadPoolExecutor() as pool:
        for future in [pool.submit(flash_kernel.build), pool.submit(ssd_kernel.build)]:
            future.result()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    served = {}
    for arch in MODEL_ARCHS:
        cfg = get_config(arch)
        model = CausalLM(cfg, init_lm(torch.Generator(device=dev).manual_seed(0), cfg, torch.bfloat16))
        with eager_launchers():
            served[arch] = serve(model, make_inputs(cfg, BATCH, PROMPT_LEN, torch.Generator(device=dev).manual_seed(1)),
                                 GEN, log=lambda *a: None)["tokens"].cpu()  # fmt: skip
        del model
        torch.cuda.empty_cache()
    return model_axis_on_one_card(card_name_and_power_limit(), served)


# ---------------------------------------------------------------------------
# The mtrain phase: training over the model axis
# ---------------------------------------------------------------------------


def _flat(tree) -> dict:
    """``{path: leaf}`` of a nested dict (paths as tuples of keys; a spec is a leaf)."""
    from repro_torch.parallel.sharding import is_spec, tree_map_with_path

    out = {}
    tree_map_with_path(lambda path, leaf: out.__setitem__(path, leaf), tree, is_leaf=is_spec)
    return out


def mtrain_config(arch: str, dtype=None, layers=None):
    """``arch``'s published config at ``layers`` in ``dtype`` (its own depth and type for None)."""
    from repro_torch.configs.registry import get_config

    cfg = get_config(arch)
    return dataclasses.replace(cfg, n_layers=layers or cfg.n_layers, dtype=dtype or cfg.dtype)


def mtrain_step(cfg, dtype: str, mesh):
    """``make_train_step`` under the train phase's optimizer: scu, remat full, lr ``TRAIN_LR``."""
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.step import TrainConfig, make_train_step

    tcfg = TrainConfig(sync_strategy="scu", remat_policy="full", param_dtype=dtype,
                       opt=OptConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP))  # fmt: skip
    return make_train_step(cfg, tcfg, mesh)


def mtrain_batch(cfg, batch: int, seq: int, edges: int = 0) -> dict:
    """The train phase's batch: ``(batch, seq + 1)`` token ids from seed 1 on
    the card.  With ``edges``, the first and last rows of each of the
    vocabulary's ``edges`` blocks (the split of the embedding and of the
    vocab-parallel cross-entropy over that many model processes) are planted
    at positions 1, 2, ... of every row, so that they are input tokens and
    labels both: the split's boundary rows then carry gradients."""
    import torch

    dev = torch.device("cuda")
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq + 1), generator=torch.Generator(device=dev).manual_seed(1),
                           device=dev)  # fmt: skip
    if edges:
        block = cfg.vocab_size // edges
        ids = sorted({row for i in range(edges) for row in (i * block, (i + 1) * block - 1)})
        tokens[:, 1 : 1 + len(ids)] = torch.tensor(ids, device=dev)
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


def quieter(quiet: dict, grads, rms: dict) -> None:
    """Each entry's smallest |gradient| / ``rms[path]`` of its leaf so far, in
    ``quiet`` ({path: float16 tensor}); ``grads`` a gradient tree."""
    import torch

    for path, g in _flat(grads).items():
        ratio = g.detach().abs().float().div_(max(rms[path], 1e-30)).to(torch.float16)
        quiet[path] = ratio if path not in quiet else torch.minimum(quiet[path], ratio)


def gradient_gap(grads, whole: dict, shardings: dict, coords: dict) -> tuple:
    """(the largest err / the block's largest entry, its leaf): each leaf of
    this rank's gradient tree against its block of ``whole`` ({path: the
    model = 1 gradient})."""
    worst = (0.0, None)
    for path, g in _flat(grads).items():
        want = whole[path][shardings[path].index(tuple(whole[path].shape), coords)].to(g.device)
        gap = ((g - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()
        worst = max(worst, (gap, "/".join(path)), key=lambda w: w[0])
    return worst


def whole_over_model_digests(params, shardings: dict) -> dict:
    """sha256 of the bits of every leaf that ``shardings`` leaves whole over ``model``."""
    import hashlib

    import torch

    return {"/".join(path): hashlib.sha256(t.detach().reshape(-1).view(torch.uint8).cpu().numpy().tobytes()).hexdigest()
            for path, t in _flat(params).items() if "model" not in shardings[path].sharded_axes()}  # fmt: skip


def model_axis_training_rank(rank: int, world: int, workdir: str) -> None:
    """One process of the mtrain phase (see the module note): its results, or
    its traceback, in ``workdir`` as ``rank<r>.json`` / ``rank<r>.err``."""
    import traceback

    sys.path.insert(0, str(ROOT / "src"))
    work = Path(workdir)
    try:
        import torch
        import torch.distributed as dist

        from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd, flash_attention_fwd
        from repro_torch.kernels.ssd_scan.kernel import ssd_scan_fwd
        from repro_torch.models.lm import init_lm
        from repro_torch.train.optimizer import init_opt_state, tree_leaves

        dev = torch.device("cuda", 0)
        out = {"rank": rank}
        mesh = join_two_on_one_card(rank, world, work, out)
        coords = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        counters = {"flash_attention_fwd": flash_attention_fwd, "flash_attention_bwd": flash_attention_bwd,
                    "ssd_scan_fwd": ssd_scan_fwd}  # fmt: skip

        def counted():
            return {name: c.launches for name, c in counters.items()}

        def draw(cfg, dtype):
            step_fn, (in_sh, _), _, _ = mtrain_step(cfg, str(dtype).removeprefix("torch."), mesh)
            params = init_lm(torch.Generator(device=dev).manual_seed(0), cfg, dtype, shardings=in_sh[0])
            return step_fn, in_sh, params, init_opt_state(params, in_sh)

        for arch in MODEL_ARCHS:
            # (a) float32 at a cut depth against model = 1 through the plain versions, routing pinned
            cfg = mtrain_config(arch, "float32", MTRAIN_F32[arch])
            ref = torch.load(work / f"ref_{arch}.pt", mmap=True)
            step_fn, in_sh, params, opt = draw(cfg, torch.float32)
            start = {path: t.clone() for path, t in _flat(params).items()}
            data = mtrain_batch(cfg, MTRAIN_F32_BATCH, MTRAIN_F32_LEN, edges=MODEL_RANKS)
            pins, own, handed, quiet = [r.to(dev) for r in ref["routing"]], [], [], {}
            shardings = _flat(in_sh[0])
            step = torch.zeros((), dtype=torch.int32, device=dev)
            losses, norms, launches, lrs = [], [], [], []
            with pinned_routing(pins, own), handed_gradients(handed):
                for t in range(MTRAIN_STEPS):
                    for c in counters.values():
                        c.launches = 0
                    params, opt, step, metrics = step_fn(params, opt, step, data)
                    launches.append(counted())
                    losses.append(metrics["loss"].item())
                    norms.append(metrics["grad_norm"].item())
                    lrs.append(metrics["lr"].item())
                    grads = handed.pop()
                    if t == 0:
                        grad_gap = gradient_gap(grads, ref["grad0"], shardings, coords)
                    quieter(quiet, grads, {path: r[t] for path, r in ref["rms"].items()})
                    del grads
            most = 2 * sum(lrs)  # AdamW moves an entry by at most 2 lr a step, whatever its gradient
            worst = (0.0, None, 0.0, 0.0)  # (err / allowed, leaf, err, allowed)
            beyond = near = both_quiet = entries = 0  # beyond the allowance, of them quiet; quiet; in all
            loudest = 0.0  # the largest quiet ratio of an entry beyond the allowance, the larger of its two
            farthest = 0.0  # the largest err / (2 x the summed learning rates)
            for path, got in _flat(params).items():
                whole = ref["params"][path]
                index = shardings[path].index(tuple(whole.shape), coords)
                want = whole[index].to(dev)
                allowed = (MTRAIN_TOL * want.abs().max() + MTRAIN_UPDATE_TOL * (want - start[path]).abs().max()).item()
                diff = (got - want).abs()
                ratio = torch.maximum(ref["quiet"][path][index].to(dev), quiet[path]).float()
                outside = diff > allowed
                err = diff.max().item()
                beyond += int(outside.sum())
                near += int((outside & (ratio < MTRAIN_QUIET)).sum())
                both_quiet += int((ratio < MTRAIN_QUIET).sum())
                entries += diff.numel()
                if outside.any():
                    loudest = max(loudest, ratio[outside].max().item())
                if err / max(allowed, 1e-30) >= worst[0]:
                    worst = (err / max(allowed, 1e-30), "/".join(path), err, allowed)
                farthest = max(farthest, err / most)
            out[arch] = {"f32": {"layers": cfg.n_layers, "losses": losses, "grad_norms": norms, "launches": launches,
                                 "grad_gap": list(grad_gap), "params_worst": list(worst),
                                 "params_beyond": [beyond, near, both_quiet, entries],
                                 "params_loudest": loudest, "params_farthest": farthest,
                                 "whole_digests": whole_over_model_digests(params, shardings),
                                 "routing_differ": list(routing_differ(own, pins))}}
            del ref, params, opt, start, data, pins, step_fn, quiet
            torch.cuda.empty_cache()

        for arch, layers, batch, seq in MTRAIN_BF16:
            # (b) bf16 at full width: the train phase's batch and optimizer
            cfg = mtrain_config(arch, None, layers)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step_fn, in_sh, params, opt = draw(cfg, torch.bfloat16)
            torch.cuda.synchronize()
            draw_s = time.perf_counter() - t0
            held = sum(t.numel() for t in tree_leaves(params))
            state = sum(t.numel() for tree in opt.values() for t in tree_leaves(tree))
            data = mtrain_batch(cfg, batch, seq)
            step = torch.zeros((), dtype=torch.int32, device=dev)
            torch.cuda.reset_peak_memory_stats()
            losses, step_ms, launches, handed, shapes = [], [], [], [], {}
            bad = None
            for i in range(MTRAIN_STEPS):
                for c in counters.values():
                    c.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with (handed_gradients(handed) if i == 0 else contextlib.nullcontext()), \
                        (recorded_kernel_shapes(shapes) if i == 0 else contextlib.nullcontext()):
                    params, opt, step, metrics = step_fn(params, opt, step, data)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                launches.append(counted())
                losses.append(metrics["loss"].item())
                if i == 0:
                    bad = zero_gradients(handed[0])
                    handed.clear()
            out[arch]["bf16"] = {
                "layers": cfg.n_layers, "batch": batch, "seq": seq, "draw_s": draw_s, "params_held": held,
                "opt_state_held": state, "losses": losses, "step_ms": step_ms, "launches": launches,
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "zero_or_nonfinite_grads": bad,
                "n_leaves": len(tree_leaves(params)), "kernel_shapes": {k: sorted(v) for k, v in shapes.items()},
                "whole_digests": whole_over_model_digests(params, _flat(in_sh[0])),
            }  # fmt: skip
            del params, opt, data, step_fn
            torch.cuda.empty_cache()
        dist.barrier()
        dist.destroy_process_group()
        (work / f"rank{rank}.json").write_text(json.dumps(out))
    except BaseException:
        (work / f"rank{rank}.err").write_text(traceback.format_exc())
        sys.exit(1)


def reckon_rank_gib(cfg) -> tuple:
    """(parameters a rank holds at model = 2, GiB of its training state):
    bf16 params and gradients, a float32 master and two moments, by the
    parameter specs over ``{"data": 1, "model": 2}``."""
    import math

    import torch

    from repro_torch.parallel.sharding import NamedSharding, param_specs
    from repro_torch.train.step import abstract_params

    grid = {"data": 1, "model": MODEL_RANKS}
    sds = abstract_params(cfg, torch.bfloat16)
    specs = _flat(param_specs(sds, grid, fsdp=False, cfg=cfg))
    held = sum(math.prod(NamedSharding(grid, specs[path]).shard_shape(tuple(t.shape))) for path, t in _flat(sds).items())
    return held, held * (2 + 2 + 3 * 4) / 2**30


def mtrain_kernels(ranks: list) -> tuple:
    """(c): K1's backward and K2's forward held to their plain versions, and
    timed, at the shapes the ranks handed K1 and K2 in (b) (K1's backward
    takes the forward's q, k, v); each shape one on both ranks.  Returns
    ({arch: {kernel: row}}, failures)."""
    import torch

    gen = torch.Generator(device=torch.device("cuda")).manual_seed(19)
    rows, failures = {}, []
    for arch, _, _, _ in MTRAIN_BF16:
        seen = [r[arch]["bf16"]["kernel_shapes"] for r in ranks]
        for name in sorted(set().union(*seen)):
            shapes = {json.dumps(shape) for by_rank in seen for shape in by_rank.get(name, [])}
            if len(shapes) != 1:
                failures.append(f"{arch}: the ranks handed {name} {len(shapes)} shapes, not one: {sorted(shapes)}")
                continue
            shape = json.loads(shapes.pop())
            if name == "flash_attention_fwd":
                (q, q_t), (k, k_t), (v, v_t), causal = shape
                if {q_t, k_t, v_t} != {"bfloat16"} or not causal:
                    failures.append(f"{arch}: K1 given {shape} in training; the check covers causal bf16 only")
                    continue
                b, s, h, d = q
                row = attention_bwd_at_shape(gen, b, s, h, k[2], d, v[3], tag="[mtrain]")
                rows.setdefault(arch, {})["flash_attention_bwd"] = row
            else:
                (x, x_t), (dt, dt_t), _, (B, B_t), (C, C_t), chunk, fresh = shape
                if (x_t, dt_t, B_t, C_t) != ("bfloat16", "float32", "bfloat16", "bfloat16") or not fresh:
                    failures.append(f"{arch}: K2 given {shape} in training; the check covers bf16 from a zero state")
                    continue
                b, s, h, p = x
                form, err, ms, plain_ms, bound_ms, bound_by = ssd_at_shape(gen, b, s, h, p, B[3], chunk, tag="[mtrain]")
                rows.setdefault(arch, {})["ssd_scan_fwd"] = {
                    "form": form.name, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "shape": {"b": b, "s": s, "h": h, "p": p, "n": B[3], "chunk": chunk}}  # fmt: skip
    return rows, failures


def same_bits(by_rank: list) -> tuple:
    """(leaves whole over ``model`` compared, those whose bits differ between
    the ranks) from each rank's ``whole_digests``."""
    digests = [r["whole_digests"] for r in by_rank]
    paths = sorted(set().union(*digests))
    return len(paths), [p for p in paths if len({d.get(p) for d in digests}) != 1]


def model_axis_training(card: str, trained: dict) -> dict:
    """The mtrain phase (see the module note): the float32 yardsticks at
    model = 1 through the plain versions here, the memory reckoned, then the
    two processes, then (c) back here; returns each model's numbers by rank
    and the kernels' rows.  Its work directory is gone at the end, failed or
    not, and no process it started outlives it."""
    import shutil
    import uuid

    import torch

    from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd, flash_attention_fwd
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_fwd
    from repro_torch.models.lm import init_lm
    from repro_torch.train.optimizer import init_opt_state

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    plain = {"phi4-mini-3.8b": plain_attention, "mamba2-1.3b": plain_ssd_scan, "deepseek-v2-lite-16b": plain_attention}
    counters = (flash_attention_fwd, flash_attention_bwd, ssd_scan_fwd)
    work = ROOT / "build" / f"mtrain_phase_{uuid.uuid4().hex[:8]}"
    work.mkdir(parents=True)
    try:
        for arch in MODEL_ARCHS:
            cfg = mtrain_config(arch, "float32", MTRAIN_F32[arch])
            params = init_lm(torch.Generator(device=dev).manual_seed(0), cfg, torch.float32)
            step_fn = mtrain_step(cfg, "float32", {"data": 1, "model": 1})[0]
            opt = init_opt_state(params)
            data = mtrain_batch(cfg, MTRAIN_F32_BATCH, MTRAIN_F32_LEN, edges=MODEL_RANKS)
            step = torch.zeros((), dtype=torch.int32, device=dev)
            routing, losses, norms, handed, quiet, rms, grad0 = [], [], [], [], {}, {}, {}
            for c in counters:
                c.launches = 0
            with recorded_routing(routing), plain[arch](), handed_gradients(handed):
                for _ in range(MTRAIN_STEPS):
                    params, opt, step, metrics = step_fn(params, opt, step, data)
                    losses.append(metrics["loss"].item())
                    norms.append(metrics["grad_norm"].item())
                    grads = handed.pop()
                    if not grad0:
                        grad0 = {path: g.detach().cpu() for path, g in _flat(grads).items()}
                    for path, g in _flat(grads).items():
                        rms.setdefault(path, []).append(g.detach().float().pow(2).mean().sqrt().item())
                    quieter(quiet, grads, {path: r[-1] for path, r in rms.items()})
                    del grads
            if any(c.launches for c in counters):
                raise SystemExit(f"[mtrain] {arch}'s plain yardstick launched a kernel")
            torch.save({"losses": losses, "grad_norms": norms, "routing": [r.cpu() for r in routing], "rms": rms,
                        "quiet": {path: t.cpu() for path, t in quiet.items()}, "grad0": grad0,
                        "params": {path: t.cpu() for path, t in _flat(params).items()}}, work / f"ref_{arch}.pt")
            del params, opt, data, step_fn, routing, quiet, grad0
            torch.cuda.empty_cache()
        ref_s = time.perf_counter() - t_phase
        reckoned = {}
        phi4_run = trained.get("phi4-mini-3.8b")
        beside = f" (the train phase's one-process phi4 peak: {phi4_run['peak_gib']:.2f} GiB)" if phi4_run else ""
        for arch, layers, batch, seq in MTRAIN_BF16:
            cfg = mtrain_config(arch, None, layers)
            held, gib = reckon_rank_gib(cfg)
            reckoned[arch] = gib
            print(f"[mtrain] {card}; reckoned before the call, {arch} at {cfg.n_layers} layers in bf16 at model = "
                  f"{MODEL_RANKS}: {held / 1e9:.3f} B params a rank of {cfg.n_params() / 1e9:.3f} B, {gib:.2f} GiB of "
                  f"state a rank (bf16 params and gradients, float32 master and moments) and "
                  f"{MODEL_RANKS * gib:.2f} GiB for the {MODEL_RANKS} beside the card's 80 GB, before activations"
                  f"{beside}")
        t_ranks = time.perf_counter()
        ranks = two_ranks_on_one_card(model_axis_training_rank, work, MTRAIN_TIMEOUT_S, "[mtrain]")
        ranks_s = time.perf_counter() - t_ranks
        refs = {arch: {key: torch.load(work / f"ref_{arch}.pt", mmap=True)[key] for key in ("losses", "grad_norms")}
                for arch in MODEL_ARCHS}  # fmt: skip
    finally:
        shutil.rmtree(work, ignore_errors=True)

    print(f"[mtrain] {card}; {MODEL_RANKS} processes on the one card, {{'data': 1, 'model': {MODEL_RANKS}}}: NCCL "
          f"refused them ({ranks[0]['nccl']}), so they train in an explicit {ranks[0]['backend']!r} group over "
          f"CUDA tensors; mesh coordinates {[r['coords'] for r in ranks]}")
    failures = []
    for arch in MODEL_ARCHS:
        ref = refs[arch]
        a = [r[arch]["f32"] for r in ranks]
        want = train_expected_launches(mtrain_config(arch, "float32", MTRAIN_F32[arch]))
        loss_err = max(abs(x - y) / abs(y) for r in a for x, y in zip(r["losses"], ref["losses"]))
        norm_err = max(abs(x - y) / abs(y) for r in a for x, y in zip(r["grad_norms"], ref["grad_norms"]))
        differ = [r["routing_differ"] for r in a]
        routed = "" if not differ[0][1] else (
            f"; the router's own top-k sets at model = 2 that differ from model = 1's, by rank "
            f"{[f'{d} of {t}' for d, t in differ]} (at most {MODEL_ROUTING_DIFFER:.0%})")
        print(f"[mtrain] {arch} float32 at {a[0]['layers']} layers, {MTRAIN_F32_BATCH} x {MTRAIN_F32_LEN}, "
              f"{MTRAIN_STEPS} steps (scu, remat full, lr {TRAIN_LR:g}), model = 2 through the kernels against "
              f"model = 1 through the plain versions (routing pinned to its): losses {[round(x, 6) for x in a[0]['losses']]} "
              f"vs {[round(x, 6) for x in ref['losses']]}, largest rel err {loss_err:.2e}; grad norms largest rel err "
              f"{norm_err:.2e} (tol {MTRAIN_TOL:g} each); step-0 gradient blocks by rank, the worst leaf's err / the "
              f"block's largest entry {[f'{r['grad_gap'][0]:.2e} ({r['grad_gap'][1]})' for r in a]} (tol "
              f"{MTRAIN_TOL:g}); parameter blocks by rank: entries beyond the allowance "
              f"({MTRAIN_TOL:g} of the block's largest entry + {MTRAIN_UPDATE_TOL:g} of its largest update), of them "
              f"with a gradient below {MTRAIN_QUIET:g} of its leaf's model = 1 RMS at some step on both sides (must be "
              f"all), entries so quiet, entries {[r['params_beyond'] for r in a]}; the largest such ratio of an entry "
              f"beyond {[f'{r['params_loudest']:.2e}' for r in a]}; the worst entry's err / allowance "
              f"{[f'{r['params_worst'][0]:.3f} ({r['params_worst'][1]}: {r['params_worst'][2]:.2e} of {r['params_worst'][3]:.2e})' for r in a]} "
              f"and its err / (2 x the summed learning rates, AdamW's most) {[round(r['params_farthest'], 4) for r in a]} "
              f"(tol 1); leaves whole over model, the same bits on both ranks: {same_bits(a)}; launches a step "
              f"by rank {[r['launches'][-1] for r in a]}{routed}; with each rank's vocabulary block edges among the "
              f"tokens, the quiet entries by rank {[f'{r['params_beyond'][2] / r['params_beyond'][3]:.1%}' for r in a]} "
              f"(2.9-35 % without them, PERF.md section 6)")
        for r in a:
            d, t = r["routing_differ"]
            beyond, near = r["params_beyond"][:2]
            if not (loss_err <= MTRAIN_TOL and norm_err <= MTRAIN_TOL and r["grad_gap"][0] <= MTRAIN_TOL
                    and beyond == near and r["params_farthest"] <= 1.0
                    and not same_bits(a)[1] and all(x == want for x in r["launches"]) and d <= MODEL_ROUTING_DIFFER * t):
                failures.append(f"{arch} float32: losses {loss_err:.2e}, grad norms {norm_err:.2e}, step-0 gradients "
                                f"{r['grad_gap']}, params "
                                f"{r['params_beyond']} {r['params_worst']} {r['params_farthest']}, leaves whole over "
                                f"model that differ {same_bits(a)[1]}, launches {r['launches']} (want {want}), routing "
                                f"{d} of {t}")
    for arch, layers, batch, seq in MTRAIN_BF16:
        b = [r[arch]["bf16"] for r in ranks]
        cfg = mtrain_config(arch, None, layers)
        want = train_expected_launches(cfg)
        one = trained.get(arch)
        gap = ("no model = 1 run of the train phase at this batch" if not one or (one["batch"], one["seq"]) != (batch, seq)
               else "gap to the train phase's model = 1 losses by rank "
               + str([[round(x - y, 4) for x, y in zip(r["losses"], one["losses"])] for r in b]) + " (printed, not checked)")
        print(f"[mtrain] {card}; {arch} at {cfg.n_layers} layers in bf16 at model = {MODEL_RANKS}, {batch} x {seq}, "
              f"{MTRAIN_STEPS} steps (scu, remat full, lr {TRAIN_LR:g}), by rank: params held "
              f"{[round(r['params_held'] / 1e9, 3) for r in b]} B, optimizer state held "
              f"{[round(r['opt_state_held'] / 1e9, 3) for r in b]} B floats (drawn in "
              f"{[round(r['draw_s'], 1) for r in b]} s); ms a step (host clock) {[[round(t, 1) for t in r['step_ms']] for r in b]}; "
              f"peak {[round(r['peak_gib'], 2) for r in b]} GiB (reckoned state {reckoned[arch]:.2f} GiB a rank); "
              f"losses {[[round(x, 5) for x in r['losses']] for r in b]}; {gap}; launches a step "
              f"{[r['launches'][-1] for r in b]} (expected {want})")
        for r in b:
            finite = all(math.isfinite(x) for x in r["losses"])
            if r["zero_or_nonfinite_grads"] or not finite or not r["losses"][-1] < r["losses"][0] \
                    or any(x != want for x in r["launches"]) or same_bits(b)[1]:
                failures.append(f"{arch} bf16: zero or non-finite gradients {r['zero_or_nonfinite_grads']}, losses "
                                f"{r['losses']}, launches {r['launches']} (want {want}), leaves whole over model "
                                f"that differ {same_bits(b)[1]}")
        print(f"[mtrain] {arch} bf16 step 0: every one of the {b[0]['n_leaves']} parameter leaves of each rank's "
              f"blocks (every group of the stacked ones) has a finite, non-zero gradient: "
              f"{[not r['zero_or_nonfinite_grads'] for r in b]}; after step {MTRAIN_STEPS - 1}, leaves whole over "
              f"model (each rank updates its own copy), the same bits on both ranks: {same_bits(b)}")
    kernels, kernel_failures = mtrain_kernels(ranks)
    failures += kernel_failures
    for arch, by_kernel in kernels.items():
        for name, row in by_kernel.items():
            print(f"[mtrain] {card}; {arch}: {name} at a rank's training shape held to its plain version and timed "
                  f"(above): {row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, library "
                  f"{'none' if row['library_ms'] is None else f'{row['library_ms']:.3f} ms'}, bound {row['bound_ms']:.3f} ms")
    phase_s = time.perf_counter() - t_phase
    print(f"[mtrain] two processes time-slicing one card measure correctness and memory, not the speed of tensor "
          f"parallelism; yardsticks at model = 1 {ref_s:.1f} s, the two processes {ranks_s:.1f} s, phase {phase_s:.1f} s")
    if failures:
        raise SystemExit("[mtrain] " + "; ".join(failures))
    return {arch: {"f32": [r[arch]["f32"] for r in ranks], "bf16": [r[arch]["bf16"] for r in ranks]}
            for arch in MODEL_ARCHS} | {"phase_s": phase_s, "kernels": kernels, "reckoned_gib": reckoned}


def mtrain_alone() -> dict:
    """The mtrain phase by itself, K1 (both sources) and K2 built first:
    ``python3 -c 'import chip_smoke; chip_smoke.mtrain_alone()'``."""
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.compat import card_name_and_power_limit
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel

    with concurrent.futures.ThreadPoolExecutor() as pool:
        for future in [pool.submit(flash_kernel.build), pool.submit(flash_kernel.build_bwd),
                       pool.submit(ssd_kernel.build)]:  # fmt: skip
            future.result()
    torch.backends.cuda.matmul.allow_tf32 = False
    return model_axis_training(card_name_and_power_limit(), {})


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


def check_attention_widths() -> dict:
    """Phase 3 for K1 at the widths beyond its first instances (``WIDTHS``):
    the forward and its backward against their plain versions in float32 and
    bf16 at ``WIDTHS_CHECK``, then each timed in bf16 at ``WIDTHS_TIMED``
    beside SDPA (forward and backward) and the bound.  Returns the rows of
    K1's ``widths`` entry."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd, flash_attention_fwd, kernel_instance
    from repro_torch.kernels.flash_attention.ops import attention_bwd
    from repro_torch.kernels.flash_attention.ref import attention_ref, attention_ref_lse

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)

    def draw(shapes, dtype):
        return [torch.randn(sh, generator=gen, device=dev).to(dtype) for sh in shapes]

    rows = {}
    for dqk, dv in WIDTHS:
        instance = kernel_instance(dqk, dv)
        b, h, kvh, s = WIDTHS_CHECK
        errs = {}
        for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            q, k, v, dout = draw(((b, s, h, dqk), (b, s, kvh, dqk), (b, s, kvh, dv), (b, s, h, dv)), dtype)
            qt, kt, vt, dt = (x.transpose(1, 2) for x in (q, k, v, dout))
            out, lse = flash_attention_fwd(qt, kt, vt, causal=True)
            grads = flash_attention_bwd(qt, kt, vt, out, lse, dt, causal=True)
            torch.cuda.synchronize()
            ref = attention_ref(qt, kt, vt, causal=True)
            fwd_err = (out.float() - ref.float()).abs().max().item()
            lse_err = (lse - attention_ref_lse(qt, kt, causal=True)).abs().max().item()
            want = attention_bwd(q, k, v, out.transpose(1, 2), lse, dout, causal=True)
            bwd_err = max((g.transpose(1, 2).float() - w.float()).abs().max().item() / max(1.0, w.float().abs().max().item())
                          for g, w in zip(grads, want))  # fmt: skip
            errs[name] = {"fwd": fwd_err, "lse": lse_err, "bwd": bwd_err}
            if not (fwd_err <= KERNEL_TOL[name] and lse_err <= 1e-3 and bwd_err <= WIDTH_BWD_TOL[name]):
                raise SystemExit(f"[kernels] K1 at dqk={dqk} dv={dv} {name} (instance {instance}) disagrees with its "
                                 f"plain versions: forward {fwd_err:.3e} (tol {KERNEL_TOL[name]:g}), lse {lse_err:.3e}, "
                                 f"backward {bwd_err:.3e} of the largest gradient (tol {WIDTH_BWD_TOL[name]:g})")
        b, h, kvh, s = WIDTHS_TIMED
        q, k, v, dout = draw(((b, s, h, dqk), (b, s, kvh, dqk), (b, s, kvh, dv), (b, s, h, dv)), torch.bfloat16)
        qt, kt, vt, dt = (x.transpose(1, 2) for x in (q, k, v, dout))
        out, lse = flash_attention_fwd(qt, kt, vt, causal=True)
        row = {"instance": list(instance), "max_abs_err": errs,
               "ms": time_ms(lambda: flash_attention_fwd(qt, kt, vt, causal=True), iters=20),
               "bwd_ms": time_ms(lambda: flash_attention_bwd(qt, kt, vt, out, lse, dt, causal=True), iters=10)}
        row["bound_ms"], row["bound_by"] = attention_bound(b, h, kvh, s, s, dqk, True, "bfloat16", dv)
        row["bwd_bound_ms"], row["bwd_bound_by"] = attention_bwd_bound(b, h, kvh, s, dqk, dv, "bfloat16")
        # the yardsticks, which the port never calls; SDPA refuses some widths
        try:
            row["library_ms"] = time_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True), iters=20)
        except RuntimeError:
            row["library_ms"] = None
        try:
            qs, ks, vs = (x.detach().clone().requires_grad_(True) for x in (qt, kt, vt))
            ref_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)
            row["bwd_library_ms"] = time_ms(lambda: torch.autograd.grad(ref_out, (qs, ks, vs), dt, retain_graph=True),
                                            iters=10)  # fmt: skip
            del ref_out
        except RuntimeError:
            row["bwd_library_ms"] = None

        def against(ms, library):
            return "refused" if library is None else f"{library:.3f} ms (kernel {ms / library:.2f}x)"

        print(f"[kernels] K1 width dqk={dqk} dv={dv} (instance {instance[0]}x{instance[1]}): against the plain "
              f"versions at b={WIDTHS_CHECK[0]} h={WIDTHS_CHECK[1]} kvh={WIDTHS_CHECK[2]} s={WIDTHS_CHECK[3]} causal, "
              + "; ".join(f"{name} forward {e['fwd']:.2e}, lse {e['lse']:.2e}, backward {e['bwd']:.2e} of the largest "
                          f"gradient" for name, e in errs.items())
              + f"; at b={b} h={h} kvh={kvh} s={s} bf16 causal: forward {row['ms']:.3f} ms (bound {row['bound_ms']:.3f} "
              f"by {row['bound_by']}, {row['bound_ms'] / row['ms'] * 100:.0f} %), SDPA {against(row['ms'], row['library_ms'])}; "
              f"backward {row['bwd_ms']:.3f} ms (bound {row['bwd_bound_ms']:.3f} by {row['bwd_bound_by']}, "
              f"{row['bwd_bound_ms'] / row['bwd_ms'] * 100:.0f} %), SDPA's backward "
              f"{against(row['bwd_ms'], row['bwd_library_ms'])}")
        rows[f"{dqk}x{dv}"] = row
        del q, k, v, dout, qt, kt, vt, dt, out, lse
    torch.cuda.empty_cache()
    return rows


def serve_smoke_configs(counters) -> dict:
    """The serve phase's ten smoke configs: each drawn in bf16 on the card and
    served through ``launch.serve.serve`` (a batch of ``SMOKE_BATCH`` prompts of
    ``SMOKE_PROMPT`` tokens prefilled, ``SMOKE_GEN`` tokens decoded through the
    graph), K1 at every smoke head width (16, and deepseek's MLA at (24, 16)).
    Checks that prefill launched K1 once an attention layer and K2 once an SSD
    layer (counts set to 0 just before, read just after), that the logits
    are finite and the tokens in the vocabulary, and holds each kernel to its
    plain version at every shape and type the prefill handed it
    (``recorded_kernel_shapes``; a launched kernel with no shape recorded
    fails).  Returns, by arch, the widths, the launches and those checks."""
    import torch

    from repro_torch.configs.registry import get_smoke_config, list_archs
    from repro_torch.kernels.flash_attention.kernel import kernel_instance
    from repro_torch.launch.serve import make_inputs, serve
    from repro_torch.models.lm import init_lm
    from repro_torch.serve.decode import CausalLM

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)
    out = {}
    t0 = time.perf_counter()
    for arch in list_archs():
        cfg = get_smoke_config(arch)
        model = CausalLM(cfg, init_lm(torch.Generator(device=dev).manual_seed(0), cfg, torch.bfloat16))
        inputs = make_inputs(cfg, SMOKE_BATCH, SMOKE_PROMPT, torch.Generator(device=dev).manual_seed(1))
        shapes = {}
        for counted in counters.values():
            counted.launches = 0
        with recorded_kernel_shapes(shapes):
            got = serve(model, inputs, SMOKE_GEN, log=lambda *a, **k: None)
        torch.cuda.synchronize()
        launches = {name: counters[name].launches for name in ("flash_attention_fwd", "ssd_scan_fwd")}
        want = {name: n for name, n in expected_launches(cfg).items() if name in launches}
        m = cfg.mla
        widths = (None if want["flash_attention_fwd"] == 0 else
                  (m.qk_nope_dim + m.qk_rope_dim, m.v_head_dim) if m is not None else
                  (cfg.resolved_head_dim, cfg.resolved_head_dim))  # fmt: skip
        tokens = got["tokens"]
        fine = (bool(torch.isfinite(got["prefill_logits"]).all() and torch.isfinite(got["last_logits"]).all())
                and tokens.shape == (SMOKE_BATCH, SMOKE_GEN + 1) and int(tokens.min()) >= 0
                and int(tokens.max()) < cfg.vocab_size)  # fmt: skip
        print(f"[serve] smoke {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, K1 head dims "
              f"{widths if widths else 'none'}{f' (instance {kernel_instance(*widths)})' if widths else ''}; prefill "
              f"{SMOKE_BATCH} x {SMOKE_PROMPT} and {SMOKE_GEN} tokens decoded through the graph in "
              f"{got['prefill_s'] + got['decode_s']:.2f} s; prefill launches {launches} (expected {want}); "
              f"tokens {tokens[0, :6].tolist()}")
        if launches != want or not fine:
            raise SystemExit(f"[serve] smoke {arch}: launches {launches} (expected {want}), logits finite and tokens "
                             f"in the vocabulary: {fine}")
        del model, inputs, got
        held = {}
        for name in launches:
            if launches[name] and not shapes.get(name):
                raise SystemExit(f"[serve] smoke {arch}: {name} launched {launches[name]} times, no shape recorded")
            for shape in sorted(shapes.get(name, ())):
                row, why = held_at_recorded_shape(gen, name, shape, f"[serve] smoke {arch}:")
                if why is not None:
                    raise SystemExit(f"[serve] smoke {arch}: {why}")
                held.setdefault(name, []).append({key: row[key] for key in ("shape", "max_abs_err", "ms", "bound_ms")})
        out[arch] = {"head_dims": widths, "launches": launches, "held": held}
    torch.cuda.empty_cache()
    print(f"[serve] the ten smoke configs: {time.perf_counter() - t0:.1f} s")
    return out


def measured_prefill(arch: str, batch: int, seq: int) -> tuple:
    """``make_prefill`` of ``arch`` whole in bf16 on the card at ``batch`` x
    ``seq`` random tokens: (median ms of ``DRYRUN_PREFILLS`` after a warm-up,
    peak GiB of one, the peak's baseline the parameters and the inputs)."""
    import statistics

    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import make_inputs
    from repro_torch.models.lm import init_lm
    from repro_torch.serve.decode import make_prefill

    dev = torch.device("cuda")
    cfg = get_config(arch)
    params = init_lm(torch.Generator(device=dev).manual_seed(0), cfg, torch.bfloat16)
    inputs = make_inputs(cfg, batch, seq, torch.Generator(device=dev).manual_seed(1))
    prefill = make_prefill(cfg, dev, batch, seq)
    prefill(params, inputs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(DRYRUN_PREFILLS):
        t0 = time.perf_counter()
        got = prefill(params, inputs)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        del got
    peak = torch.cuda.max_memory_allocated() / 2**30
    del params, inputs
    torch.cuda.empty_cache()
    return statistics.median(times), peak


def dryrun_on_the_card(trained: dict, counters) -> dict:
    """The dry run (``repro_torch.launch.dryrun``) on the card's own PyTorch
    (fake CUDA tensors): the cells this script measures at ``{"data": 1,
    "model": 1}`` (``DRYRUN_CELLS``) and one production cell, phi4
    ``train_4k`` on the 16 x 16 mesh (a fake group of 256).  Checks that it
    allocated nothing on the card and launched no kernel, and that no process
    group is up before or after.  Then each cell's predicted peak beside the
    ``max_memory_allocated`` of its real run (the train phase's steps; a
    prefill measured here) and the roofline's bound beside the measured time:
    the measured time at or above the bound, the peak within
    ``DRYRUN_PEAK_TOL``."""
    import statistics

    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.roofline import analyze_record

    if dist.is_initialized():
        raise SystemExit("[dryrun] a process group is up after the phases that start one")
    out_dir = ROOT / "build" / "dryrun_torch"
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated()
    launched = {name: c.launches for name, c in counters.items()}
    t0 = time.perf_counter()
    recs = {}
    for arch, kind, batch, seq in DRYRUN_CELLS:
        shape = ShapeConfig(f"{kind}_{batch}x{seq}", seq, batch, kind)
        recs[(arch, kind)] = dryrun.run_cell(arch, shape, {"data": 1, "model": 1}, out_dir)
    production = dryrun.run_cell("phi4-mini-3.8b", "train_4k", "single", out_dir)
    torch.cuda.synchronize()
    traced_s = time.perf_counter() - t0
    after = {name: c.launches for name, c in counters.items()}
    if torch.cuda.memory_allocated() != allocated or after != launched or dist.is_initialized():
        raise SystemExit(f"[dryrun] the dry run touched the card: allocated {allocated} -> "
                         f"{torch.cuda.memory_allocated()} bytes, launches {launched} -> {after}, a group up after it: "
                         f"{dist.is_initialized()}")
    failed = [f"{arch} {kind}: {rec.get('error')}" for (arch, kind), rec in recs.items() if rec["status"] != "ok"]
    if production["status"] != "ok":
        failed.append(f"phi4 train_4k single: {production.get('error')}")
    if failed:
        raise SystemExit(f"[dryrun] cells failed: {failed}")
    print(f"[dryrun] {len(recs) + 1} cells traced on fake CUDA tensors in {traced_s:.1f} s: nothing allocated on the "
          f"card ({allocated} bytes before and after), no kernel launched, no process group before or after")
    row = analyze_record(production)
    print(f"[dryrun] phi4-mini-3.8b train_4k on the 16 x 16 mesh (a fake group of 256, rank 0): per device "
          f"{production['cost']['flops_per_device']:.3e} FLOPs, {production['cost']['bytes_accessed_per_device']:.3e} "
          f"bytes, peak {production['memory']['peak_bytes'] / 2**30:.2f} GiB (arguments "
          f"{production['memory']['argument_bytes'] / 2**30:.2f}); collectives "
          + json.dumps({k: [v["count"], v["wire_bytes"]] for k, v in production["collectives"].items() if v["count"]})
          + f"; roofline compute {row['compute_s'] * 1e3:.1f} ms, memory {row['memory_s'] * 1e3:.1f} ms, collective "
          f"{row['collective_s'] * 1e3:.1f} ms ({row['dominant']}), useful ratio {row['useful_ratio']:.3f}")
    rows, failures = {}, []
    for arch, kind, batch, seq in DRYRUN_CELLS:
        rec = recs[(arch, kind)]
        if kind == "train":  # the train phase's steps after the first, and its peak
            measured_ms = statistics.median(trained[arch]["step_ms"][1:])
            peak = trained[arch]["peak_gib"]
        else:
            measured_ms, peak = measured_prefill(arch, batch, seq)
        r = analyze_record(rec)
        predicted = rec["memory"]["peak_bytes"] / 2**30
        entry = {"bound_ms": r["bound_s"] * 1e3, "dominant": r["dominant"], "compute_ms": r["compute_s"] * 1e3,
                 "memory_ms": r["memory_s"] * 1e3, "measured_ms": measured_ms,
                 "fraction": r["bound_s"] * 1e3 / measured_ms, "predicted_peak_gib": predicted,
                 "measured_peak_gib": peak, "peak_ratio": predicted / peak,
                 "bf16_flops": rec["dispatch_analysis"]["bf16_flops_per_device"],
                 "f32_flops": rec["dispatch_analysis"]["f32_flops_per_device"]}  # fmt: skip
        rows[f"{arch} {rec['shape']}"] = entry
        print(f"[dryrun] {arch} {rec['shape']}: roofline bound {entry['bound_ms']:.1f} ms ({r['dominant']}; compute "
              f"{entry['compute_ms']:.1f} ms from {entry['bf16_flops']:.3e} bf16 and {entry['f32_flops']:.3e} float32 "
              f"FLOPs, memory {entry['memory_ms']:.1f} ms) beside {measured_ms:.1f} ms measured "
              f"({entry['fraction']:.3f} of it); peak predicted {predicted:.2f} GiB beside {peak:.2f} GiB measured "
              f"(max_memory_allocated; ratio {entry['peak_ratio']:.3f})")
        if measured_ms < entry["bound_ms"] or abs(entry["peak_ratio"] - 1) > DRYRUN_PEAK_TOL:
            failures.append(f"{arch} {rec['shape']}: measured {measured_ms:.1f} ms against a bound of "
                            f"{entry['bound_ms']:.1f}, peak ratio {entry['peak_ratio']:.3f}")
    if failures:
        raise SystemExit(f"[dryrun] {failures}")
    return {"cells": rows, "traced_s": traced_s}


def examples_on_the_card() -> dict:
    """The three example twins (``examples/*_torch.py``) on the card, each in
    a process of its own: the quickstart, ``train_100m_torch.py --steps
    EXAMPLE_TRAIN_STEPS`` (its checkpoint under ``build/``, removed after) and
    the batched serve.  Checks that each exits 0; prints its last line and
    seconds."""
    import os
    import shutil
    import subprocess

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    ckpt = ROOT / "build" / "train_100m_ckpt"
    runs = (("quickstart_torch.py", []), ("train_100m_torch.py", ["--steps", str(EXAMPLE_TRAIN_STEPS), "--ckpt", str(ckpt)]),
            ("serve_batch_torch.py", []))  # fmt: skip
    out = {}
    try:
        for name, args in runs:
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, str(ROOT / "examples" / name), *args], cwd=ROOT, env=env,
                                  capture_output=True, text=True, timeout=EXAMPLE_TIMEOUT_S)  # fmt: skip
            seconds = time.perf_counter() - t0
            lines = [x for x in proc.stdout.splitlines() if x.strip()]
            if proc.returncode != 0:
                raise SystemExit(f"[examples] {name} exited {proc.returncode}: {proc.stdout[-1500:]}\n{proc.stderr[-3000:]}")
            print(f"[examples] {name} {' '.join(args)}: exit 0 in {seconds:.1f} s; last line: {lines[-1] if lines else ''}")
            out[name] = {"seconds": seconds, "last": lines[-1] if lines else ""}
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    return out


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
    # every head width the reference takes: the instances' widths and those between them
    widths = check_attention_widths()
    k1["widths"] = {key: {k: row[k] for k in ("instance", "max_abs_err", "ms", "bound_ms", "bound_by", "library_ms")}
                    for key, row in widths.items()}  # fmt: skip
    k1b["widths"] = {key: {"instance": row["instance"], "ms": row["bwd_ms"], "bound_ms": row["bwd_bound_ms"],
                           "bound_by": row["bwd_bound_by"], "library_ms": row["bwd_library_ms"]}
                     for key, row in widths.items()}  # fmt: skip
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
    served_tokens = {}  # the model phase's model = 1 runs
    by_model[phi4.name], graphs[phi4.name] = serve_at_full_width(phi4, counters, plain_attention, 5e-2, 512,
                                                                 tokens_into=served_tokens)  # fmt: skip
    # stablelm whole (32 layers of 32 heads of 80): K1's head dim 80 on the serving path
    by_model[stablelm.name], graphs[stablelm.name] = serve_at_full_width(stablelm, counters, plain_attention, 5e-2,
                                                                         512)  # fmt: skip
    # the SSD chunk must divide the prompt: 255 and 256 are one chunk each (255 the ragged one).
    # 48 layers of random SSD weights in bf16 stray from float32 further than 5 % of the
    # largest logit on either path, so only the plain path bounds the kernel's
    # then one prompt alone, where K2 takes a chunk-parallel form
    by_model[mamba2.name], graphs[mamba2.name] = serve_at_full_width(
        mamba2, counters, plain_ssd_scan, None, 255, lambda model: serve_one_sequence(model, mamba2, counters, k2),
        tokens_into=served_tokens)
    # deepseek (27 layers, 15.7 B) and qwen3-moe (48 layers, 30.5 B) whole; their checks at 4
    # layers (deepseek: the dense prelude and 3 MoE layers).  bf16 routing flips between the
    # two paths move the logits of a random MoE model by more than 5 % of the largest one,
    # so only the plain path bounds the kernel's, as for mamba2.
    for cfg in (deepseek, qwen3):
        by_model[cfg.name], graphs[cfg.name] = serve_at_full_width(cfg, counters, plain_attention, None, 512,
                                                                   check_layers=4, tokens_into=served_tokens)  # fmt: skip
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

    # ---- 4c. the ten smoke configs: K1 at 16 and at deepseek's smoke MLA (24, 16) --------
    smoke = serve_smoke_configs(counters)
    k1["launches_smoke"] = {arch: got["launches"]["flash_attention_fwd"] for arch, got in smoke.items()}
    k1["head_dims_smoke"] = {arch: got["head_dims"] for arch, got in smoke.items()}

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

    # ---- 5c. model -----------------------------------------------------------
    # two processes at model = 2 on the card: each one's K1 and K2 launches in its bf16 request
    model_phase = model_axis_on_one_card(card, served_tokens)
    for entry in (k1, k2):
        entry["model_axis"] = {arch: rows[entry["name"]] for arch, rows in model_phase["kernels"].items()
                               if entry["name"] in rows}  # fmt: skip

    # ---- 5d. mtrain ----------------------------------------------------------
    # training at model = 2, two processes on the card: each model's K1, K1 backward and K2
    # launches a training step by rank, and (c)'s rows at a rank's training shape
    mtrain = model_axis_training(card, trained)
    for entry in (k1, k1b, k2):
        entry["model_axis_training"] = {
            arch: {"layers": got["bf16"][0]["layers"], "batch": got["bf16"][0]["batch"], "seq": got["bf16"][0]["seq"],
                   "launches_per_step_by_rank": [r["launches"][-1][entry["name"]] for r in got["bf16"]],
                   **({"at_rank_shape": mtrain["kernels"][arch][entry["name"]]}
                      if entry["name"] in mtrain["kernels"].get(arch, {}) else {})}
            for arch, got in mtrain.items() if arch in MODEL_ARCHS}  # fmt: skip

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

    # ---- 8b. sim --------------------------------------------------------------
    # the cycle-accurate simulator and its fleet service are host code; they launch none of the kernels
    for counted in counters.values():
        counted.launches = 0
    sim_phase(card)
    if any(counted.launches for counted in counters.values()):
        raise SystemExit(f"[sim] kernels launched in the sim phase: "
                         f"{ {name: counted.launches for name, counted in counters.items()} }")

    # ---- 9. dryrun: after every phase that starts a group --------------------
    dryrun_on_the_card(trained, counters)

    # ---- 10. examples --------------------------------------------------------
    examples_on_the_card()

    # ---- 11. result ----------------------------------------------------------
    print(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [k1, k1b, k2, k3, k4, k5]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
