#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA card and the CUDA
toolkit (``nvcc``). In order, and failing loudly on any phase:

1. the card's name and power limit (``nvidia-smi``) and the toolchain;
2. build of the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. each kernel against its plain PyTorch version, fp32 and bf16: paged
   decode and paged prefill and contiguous decode at head_dim 64/80/96/128
   and the main path's head counts (ragged lengths with a 0 and max_len,
   shuffled page tables, chunks at start > 0 and past the table's end),
   and the paged prefill at the speculative verify's shape (8 slots of
   2, 3 or 5 rows from ragged starts: 0, across a page boundary, past the
   table's end, a freed slot whose table row is zero);
   both decodes again at groups 1/4/7 over 2 kv heads and at lengths
   about their 256-row splits, with exact zeros for a zero length, the
   same bits from a second launch, and the merge's counters left at zero;
   the SSD scan at l 1/2/127/128/129/300/1031/1536 (batch 2) and
   129/1024 (batch 1, the engine's) from a zero and a non-zero state, at
   mamba2-370m's head shape (h 32, p 64, n 128) and jamba-v0.1's (h 128,
   p 64, n 16), with the same bits from a second launch and its hand-off's
   tickets and counts left at zero,
   the GEMM with every tile of each dtype at ragged shapes (1, 127, 4097
   in each dim) and the qwen3-4b MLP shapes, logging the path each ran
   (fp32 on the CUDA cores; bf16 on the tensor cores, the MLP shapes
   through TMA), and the pointer chase (bit-equal) on a permutation, a
   strided chain, past n, a line chain; the timed chase (``pchase_timed``,
   ``ld.global.ca`` and ``.cg``) bit-equal to its plain version in the
   offsets it visits on a permutation, a strided chain from an offset
   start after untimed steps, a line chain, and on a chain of more than
   8 GiB checked on the card (each offset the chain's entry at the one
   before, in the order the addresses were laid out), its walk's total
   cycles no fewer than its loads', and refusing an offset outside its
   chain;
4. times at the main path's shapes: kernel, plain version, one PyTorch
   library call where one computes the same function (a yardstick only;
   none computes an SSD scan or a pointer chase) and the card's bound for
   the same work, with TFLOP/s; for the decodes their splits, GB/s and
   share of the bound, and beside them the device time of the kernel and
   of the library call with the launches queued behind a spin of the
   card; the paged prefill at the verify shape (8 slots of 5 rows from
   starts up to 2043) with its device time, SDPA's and the bound; for the
   SSD scan its device time at l 128/1024/1536 with
   TFLOP/s, share of the bound and launch grid; the GEMM with every tile of its dtype at the qwen3-4b MLP shapes and the tiling example's, bf16 (tensor cores)
   and fp32 (CUDA cores), beside the tile chooser's modelled speedup; the
   pointer chase's nanoseconds per dependent load over footprints from
   16 KiB to 512 MiB; the timed chase at one scan of phase 20's L2
   search; and the paged decode and a 256-row chunk at phi3-mini's
   attention (MHA, head_dim 96) and the SSD scan at jamba-v0.1's shape
   (l 1024, d_state 16), each with its device time, plain version, SDPA
   (none for the scan) and bound;
5. the paged serving engine at the full width of ``qwen3-4b`` (36 layers,
   bf16, random weights from a seeded ``torch.Generator``): 12 requests,
   32 tokens each, launch counters read around the run; run eagerly and
   then graphed (each decode and chunk step one captured CUDA graph), which
   must agree in ticks, steps, buckets, preemptions, holds, trace counts,
   launches by kernel and greedy streams; tok/s, peak memory and the
   capture's seconds and graph memory logged for both;
6. the same engine, graphed, on a squeezed page pool, which must preempt;
7. paged kernel path against plain path on the same weights: logits of
   one prefill chunk and one decode step in fp32 (against a limit that a
   planted one-key fault in each kernel, run here too, must exceed) and
   in bf16 (against the plain path's own bf16 error), and greedy stream
   agreement (eager engines: a captured graph would not see the plain
   path swapped in);
8. the contiguous engine at the full width of ``qwen3-4b``: the same 12
   requests, eager and graphed as in phase 5; the contiguous decode kernel
   runs 36 times a decode step;
9. the contiguous engine at the full width of ``mamba2-370m`` (48 layers,
   bf16): 12 requests, one of them of a prime length, eager and graphed as
   in phase 5; the SSD scan runs 48 times an admission (the prefill stays
   eager);
10. contiguous kernel path against plain path, as in phase 7: one decode
    step of ``qwen3-4b`` (planted fault: decode given ``lengths - 1``),
    and a 300-token prefill and one decode step of ``mamba2-370m`` on its
    first two layers (planted faults: the scan's state not carried across
    chunk boundaries, and its final state dropped); the 48-layer readings
    are logged beside the plain path's own summation-order noise;
11. the paper's probes through their entry points, launch counters read
    around them: the GEMM tiling example at full size
    (``repro_torch.launch.autotune_gemm``: modelled and measured speedup
    of the tuned tile) and the latency dissection
    (``repro_torch.launch.latency``: Table 4.1 by the control-word
    method, dependent op chains as CUDA graphs, the pointer-chase sweep);
12. the full-sequence attention kernel against its plain version, fp32
    and bf16, causal and not, lengths 1/127/300 against 1031/2048, head_dim
    64/80/96/128, groups 1/4/7; then its time at the cache-less forward's
    shape beside the plain version, SDPA and the bound;
13. the cache-less forward of ``qwen3-4b`` at full width (the weights of
    phase 5): ``loss_fn`` on a 2 x 2048-token batch of the synthetic data
    with ``use_flash`` under ``no_grad``, the kernel launched once a layer;
    logits through the kernel against the plain ``sdpa`` in fp32 (against
    the limit of phase 7, which a planted off-by-one causal offset must
    exceed) and in bf16, and the NLL of both;
14. the training launcher (``repro_torch.launch.train``) on ``qwen2-0.5b``
    at full width: 30 steps at batch 4 x 512 with checkpoints every 10,
    no kernel launched; a falling loss; a second run to step 40 that
    resumes from step 30 and ends where a fresh run to 40 does; the
    trained parameters scored through the kernel against the plain path
    as in phase 13; a training step through the kernel refused;
15. sampled decoding: keys folded from a grid of (rid, emitted index),
    a negative rid and indices up to 2**31 - 1 among them, and their
    random bits and uniforms over the vocabulary, bit-equal on the card
    and the CPU; phase 5's engine and requests at temperature 0.8, seed
    0, eager and graphed (identical streams), logging how many requests
    drew the greedy token at each emitted index; then graphed on the
    squeezed pool of phase 6, every request done and no page leaked;
16. speculative decoding (``spec_k`` 4, ``NgramDraft``) on phase 5's
    engine and requests, eager and graphed (the verify step one captured
    graph of 36 paged prefills and no decode), which must agree as in
    phase 5, verify counters included; the paged prefill launched once a
    layer a chunk and a verify step, the decode never; tok/s beside phase
    5's and the accept rate; the squeezed pool (preempts, no page
    leaked); fp32 logits of one verify step (8 slots, width 5, ragged
    starts) against five decode steps over the same rows, within phase
    7's limit, which the verify's attention given ``starts + 1`` or
    ``starts - 1`` must exceed; one ``ModelDraft("self")`` request of 8
    tokens, eager, its rollout through the contiguous decode kernel;
17. prefix caching: 12 requests sharing a 1024-token prefix (64 pages)
    with unique 64-512-token suffixes, request 0 alone until its prefill
    ends: uncached (graphed), then cached eager and graphed, which must
    agree; at least one hit of 64 pages; the index's pages freed by
    ``clear()`` and nothing else held; tok/s and chunk steps cached
    against uncached, and how many bf16 streams are identical; fp32
    logits of a cached admission's first token (its first chunk at row
    1024, through an earlier prompt's pages) against the same prompt
    uncached, within phase 7's limit, which the hit mapped one page off
    must exceed, and whether the K/V rows are bit-equal; then spec with
    the prefix cache on the squeezed pool (every request done, splits
    counted, no page leaked);
18. open-loop overload: 48 bursty arrivals of two classes (chat, priority
    2, and a metered batch tenant) through the speculative engine with
    ``max_queue`` 16, ``max_preemptions`` 3, ``degrade`` and a chunk
    budget of 2 on phase 6's squeezed pool, under the canonical fault
    schedule (pool squeeze, accept collapse, churn storm): eager traced,
    graphed traced and graphed untraced; every request resolved, no page
    leaked, the page events reconciled with the allocator, eager = graphed
    in event trace, counters, outcomes, streams and launches, traced =
    untraced; a shed, a preemption, a forced or capped outcome, a degrade
    enter and exit and a hold all taken; the paged decode launched on the
    degraded ticks and the paged prefill on chunks and verifies, the
    decode and verify graphs 36 of their kernel each; the Chrome trace
    written to ``build/`` and read back; ``summarize``'s numbers logged;
19. the serving cost models and their calibration: every constant of
    ``core.calibrate`` measured on the card into the phase's own tuning
    cache (the page-lookup probe through both decode kernels, a stream
    four times the L2 no faster than the data sheet), each beside its
    assumed value; phase 5's requests served graphed with the chunk the
    calibrated model chooses and with chunk 256 (equal streams, tok/s of
    both); an adaptive speculative engine in fp32 (``spec_k`` 4,
    ``NgramDraft``, the width re-chosen and a trial tick every 4 ticks)
    through an accept-collapse window, eager then graphed: equal to each
    other and to plain decode's streams, ``k_live`` open when the window
    opens, 0 in it and above 0 after it, both the decode and the verify
    graph captured; the drift report's ratios finite and positive under
    the calibrated and the default constants, and ``choose_spec_k`` at
    the accept rate measured beside phase 16's measured spec-over-plain
    ratio;
20. the paper's dissection on the card: ``core.card.dissect_card`` runs
    the ch.3 detectors of ``core.pchase`` on the H100 through the timed
    chase, launch counters read around it, and its Table 3.1 column is
    logged beside the V100 device model's (``core.dissect``): the L1's
    size, line and policy at the stated carveout (its ways and sets, and
    the L2's policy, "not probed", the reasons among the cuts), its size at
    the other carveouts (Table 3.3), the L2's size and line, the latency
    classes in cycles and ns at the SM clock measured in the same run, the
    footprint profile (near and far L2, device memory), the TLB levels or
    "no step found within the bounds", and the phase's seconds; it fails
    unless ``pchase_timed`` was launched, L1 < L2 < memory, the L1 lies
    in (0, 256 KiB], the L2 between the L1 and twice the H100's 50 MB,
    both lines are powers of two, and the V100 device model's report
    matches its published column everywhere, as the reference's test
    asserts;
21. the other model families at their published widths, bf16, random
    weights from a seeded generator, one model on the card at a time with
    its depth cut to fit (``FAMILIES``): granite-3-8b (40 of 40 layers)
    and phi3-mini-3.8b (32 of 32), dbrx-132b (4 of 40; 16 experts, top-4)
    and llama4-maverick (2 of 48: one dense and one MoE layer of 128
    experts, top-1, and a shared expert) on the paged engine, and
    jamba-v0.1 (8 of 32: one period of 7 Mamba layers at d_state 16, one
    attention layer, 4 MoE layers) on the contiguous engine; MoE routing
    by capacity inside the captured graphs. Each serves 8 requests of
    64-512 tokens, 16 new tokens each, eager and then graphed as in phase
    5 (equal schedule, launches and streams; the graphs one decode, and a
    paged prefill, an attention layer); the launches equal attention
    layers times steps (the SSD scan 7 an admission); tok/s eager and
    graphed, peak memory, capture seconds, graph pool, active parameters
    and the share of (token, expert) choices capacity dropped in the
    eager run; then logits of a 300-token prompt's prefill and decode
    step, kernel path against plain path with phase 7's planted faults,
    in fp32 within FP32_LOGIT_TOL (granite, phi3 and dbrx at 2 layers,
    llama4's and jamba's one period whole; jamba's decode step against
    the SSD state's planted fault), and by the bf16 rule over the rows
    whose router made the same choices in every path (a near-tie flips
    one now and then); how many of the router's choices the paths share
    is logged.
22. the encoder-decoder and cross-attention families (``ENCDEC``), bf16,
    random weights from a seeded generator with every leaf that starts at
    zero set to a seeded value (each cross layer's gate near 0.5, the
    qkv biases, the MLP's and LayerNorm's biases), one model on the card
    at a time: first the contiguous decode at each model's decode shape
    (checked in fp32 and bf16) and the full-sequence kernel at its
    scoring shape, timed as in phase 4 beside SDPA and the bound; then
    whisper-medium whole (24 encoder and 24 decoder layers) over 8
    prompts of 256 tokens, each with 1,500 seeded audio frames, and
    llama-3.2-vision-90b at 25 of its 100 layers (5 periods, about 45 GiB
    of bf16 weights) over 4 prompts of 512 tokens, each with 1,601
    seeded patch embeddings, through ``greedy_generate`` (a warm-up call,
    then 32 and 16 new tokens: tok/s, peak memory, and the decode
    launches, which must equal attention layers times decode steps);
    whisper's ``encode`` over its 8 x 1,500 frames timed alone; fp32 and
    bf16 logits of a 300-token prompt (the cache-less forward through
    ``flash_attention`` and a decode step through ``flash_decode``, the
    frontend given) kernel path against plain path with planted faults,
    whisper at full depth and vision at one period (its 5 layers,
    computed in fp32 over the bf16 weights); whisper's logits must not
    move with another frontend (its pattern has no cross layer) and
    vision's must; and whisper-medium trained through the launcher with
    the frontend stub at batch 2 x 448 for 10 steps (finite losses, the
    last below the first, no kernel launched).

Phase 1 also holds the registers the GEMM tile chooser prices each tile
with (``kernels.gemm.REGISTERS``) to this build's ptxas report.

Phase 23 serves qwen3-4b at full width tensor-parallel over two ranks of
a gloo group that share the card (``launch.mesh.run_ranks``; fp32 logits
of a prefill and a decode step within 1e-3 of one rank's, every
``flash_decode`` of the decode step at the gathered shape held to its
plain version, a slot's pages on both ranks, n_pages / 2 a rank, fp32
greedy streams equal to one rank's or different only at a near-tie,
tok/s, peak memory, the gather's bytes, gloo's bandwidth curves, the
launcher at ``--tp 2``), then trains every family: a step's gradients on
the card against the CPU's (mamba2-370m whole, dbrx and jamba smoke) and
mamba2-370m whole for a few steps. ``python3 chip_smoke.py --phase 23``
runs the build and phase 23 alone.

Phase 24 trains over ranks: qwen2-0.5b whole in fp32 on two gloo ranks
sharing the card, (data 2, model 1) under FSDP and (data 1, model 2),
each against one rank's steps in the same call (losses within 1e-4,
first-step gradients within GRAD_TOL, a planted skipped mean caught, a
checkpoint saved under FSDP resumed on (1, 2) to the same step-3 loss),
one bf16 step under FSDP, and GPipe over two stages of 12 blocks with
``flash_attention`` launched in the ranks, against the sequential stack.
``python3 chip_smoke.py --phase 24`` runs the build and phase 24 alone.

Phase 25 puts every family on the model axis: dbrx-132b at its published
widths (2 of 40 layers) served by two gloo ranks sharing the card with
its 16 experts split 8 a rank, against one rank (streams, fp32 logits
within 1e-3 with a planted missing reduce caught, the engine's drops
equal one rank's, run twice, the decode kernel's launches); a "self"
model draft on the two-rank qwen3-4b engine (streams equal the plain
engines', drafts accepted, rank 0 alone drafting); mamba2-370m whole trained
over (data 1, model 2) against one rank (float64 gradients within
GRAD_TOL, three fp32 steps); one step of the dbrx, llama4, jamba and
vision smokes and whisper smoke's ``encode`` over (1, 2) against one
rank. ``python3 chip_smoke.py --phase 25`` runs the build and phase 25
alone.

Phase 26 holds the dry run's accounting (``launch.dryrun``:
``core.op_analysis`` traces, ``core.roofline``) to the card: qwen2-0.5b's
fp32 train step at 4 x 512 and qwen3-4b's bf16 decode at b 8 against a
full 2,048-row cache, traced on the card and on meta (census of the ops
that move data and FLOPs equal, argument bytes within 1 % of what the
build allocated, the measured time no less than 0.95 of the roofline's
overlapped bound; argument + temp against ``max_memory_allocated``
logged); the decode kernel's ``return_lse`` against its plain version
and timed beside the default launch; jamba (one period, 8 of 32 layers,
published widths) decoding over (data 1, model 2) and over (2, 1) with
the cache's rows split over ``data``, and qwen3-4b over (1, 2), on two
gloo ranks of the card, fp32 logits of a prefill and three decode steps
within 1e-3 of one rank's (bf16 logged), each rank's census equal to its
fake-group trace on meta; remat "full" and "dots" against none on
qwen2-0.5b's gradients within 1e-6 (peak memory and time logged).
``python3 chip_smoke.py --phase 26`` runs the build and phase 26 alone.

Phase 27 takes the reference's attention and cache knobs to the card:
qwen2-0.5b whole, bf16 compute, its train step at 4 x 512 with fp32 and
bf16 softmax probabilities (``attn_probs_fp32``) in turns, twice each,
from the same seeded state (losses finite and within 2^-7 of each other,
each mode's census and FLOPs equal to its meta trace, argument + temp
traced within 3 % of ``max_memory_allocated``; step ms, peaks and the
score tensors' bytes logged); qwen3-4b at full width, bf16, one decode
step at b 8 against 2,048 live rows of int8 caches (argument bytes
traced equal to the tensors' and within 0.5 % of the allocator's count,
census equal, ``flash_decode`` once a layer a step and within
``ref.TOLERANCE`` of its plain version on the cast cache, a planted K
row saturating as the reference's cast does); and ``expand_kv`` on
qwen3-4b at full width in fp32 (the cache-less forward and the
contiguous prefill within 1e-5 of the flag off, the contiguous engine's
decode launching ``flash_decode`` once a layer a step, tok/s of both
logged, the paged engine's chunks and decode steps launching the paged
kernels once a layer; ``attn_probs_fp32`` False bit-equal to True).
``python3 chip_smoke.py --phase 27`` runs the build and phase 27 alone.

28. every tile of every attention wrapper: the prefill bodies at their
    instantiated query blocks (16 and 64 rows) and both decodes at their
    split lengths (128, 256 and 512 rows), at qwen3-4b's chunk (b 1, sq
    256 from start 1024), its speculative verify (b 8, sq 5), the graphed
    decode's shape (b 8 over 2,048 rows, paged and contiguous) and
    phi3-mini's MHA decode (head_dim 96), fp32 and bf16: each held to its
    plain version within ``ref.TOLERANCE`` and counted as launched, with
    its device time, the bound (``kernels.cost``), the plain version's
    time, SDPA's device time, the tile chooser's pick
    (``core.autotune.choose_attn_block``, the tile the wrappers launch
    with no tile given, which phases 1-27 ran) and the measured fastest
    tile; one ``tile {...}`` JSON line a tile. ``python3 chip_smoke.py
    --phase 28`` runs the build and phase 28 alone.

29. the SSD scan at each chunk the kernel instantiates (32, 64 and 128
    rows; ``ops.ssd_scan(chunk=)``): (a) every chunk, fp32 and bf16, at
    mamba2-370m's and jamba's head shapes, over phase 3's lengths and
    those either side of one and two chunks, from a zero and a given
    state, held to the plain version at the same chunk within
    ``ref.TOLERANCE``, two launches bit-equal, each launch counted, the
    hand-off's ints left at zero; (b) each chunk's device time at l 1024
    at both shapes, fp32 and bf16, beside its bound (``kernels.cost`` at
    that chunk) and the plain version's time, one ``chunk {...}`` JSON
    line each; (c) mamba2-370m at full width served by the graphed
    contiguous engine with ``MambaConfig.chunk`` at 128, 64 and 32 (the
    scan launched once a layer an admission at each), and its first two
    layers in fp32: the logits of a 1031-row prompt at chunk 64 within
    1e-3 of chunk 128's and of the plain version's, greedy streams at 64
    equal to 128's; (d) a planted fault, the scan run chunk by chunk with
    the state not carried across a chunk boundary (phase 10's), which
    the logits must show past 1e-3. ``python3 chip_smoke.py --phase 29`` runs
    the build and phase 29 alone.

The line before the last holds the kernels' numbers as JSON, and the last
line is ``{"ok": true, "device": {...}}``. Exits non-zero without a card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Main-path shapes: qwen3-4b attention (32 heads, 8 kv heads, head_dim 80)
# served with batch 8, pages of 16 rows, max_len 2048, chunks of 256.
H, KVH, D, PS, B, MAX_LEN, CHUNK = 32, 8, 80, 16, 8, 2048, 256
N_PAGES = 1 + B * MAX_LEN // PS
HBM_BYTES_PER_S = 3.35e12                        # H100 SXM data sheet
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
SPIN_CYCLES = 20_000_000          # about 11 ms at the SM's 1.755 GHz
CSRC = "src/repro_torch/kernels/csrc/"
KERNELS = {   # name: (source, the TPU kernel it replaces)
    "flash_attention": (CSRC + "paged_attention.cu",
                        "src/repro/kernels/flash_attention.py:120"),
    "flash_decode_paged": (CSRC + "paged_attention.cu",
                           "src/repro/kernels/flash_decode.py:162"),
    "flash_attention_paged": (CSRC + "paged_attention.cu",
                              "src/repro/kernels/flash_attention.py:236"),
    "flash_decode": (CSRC + "paged_attention.cu",
                     "src/repro/kernels/flash_decode.py:87"),
    "ssd_scan": (CSRC + "ssd_scan.cu", "src/repro/kernels/ssd_scan.py:62"),
    "gemm": (CSRC + "gemm.cu", "src/repro/kernels/gemm.py:37"),
    "pchase": (CSRC + "pchase.cu", "src/repro/kernels/pchase_probe.py:31"),
    "pchase_timed": (CSRC + "pchase.cu",
                     "src/repro/kernels/pchase_probe.py:31"),
}
# Main-path shapes of the SSD scan: mamba2-370m (32 heads of 64, d_state
# 128) prefilling a batch-1 prompt; the kernel's chunk is 128 rows.
SSD_H, SSD_P, SSD_N, SSD_L, SSD_CHUNK = 32, 64, 128, 1024, 128
# The scan's head shapes (h, p, n): mamba2-370m's, and jamba-v0.1's 128
# heads of 64 at d_state 16 (phase 21).
SSD_SHAPES = ((SSD_H, SSD_P, SSD_N), (128, 64, 16))
# Phases 3, 4 and 12: the head dims the attention kernels take, phi3-mini's
# 96 among them, and phi3-mini's attention (MHA: 32 kv heads of 96).
HEAD_DIMS = (64, 80, 96, 128)
PHI3_H, PHI3_KVH, PHI3_D = 32, 32, 96
# (bt, l) the scan is checked at: one row, one chunk and either side of it,
# ragged lengths, the longest prompt; batch 1 as the engine prefills.
SSD_CASES = ((2, 1), (2, 2), (2, 127), (2, 128), (2, 129), (2, 300),
             (2, 1031), (2, 1536), (1, 129), (1, 1024))
# Phase 29: the mamba2-370m engine at each chunk serves CHUNK_PROMPTS
# prompts of 64-512 tokens and one of 1031 (a prime: ragged at every
# chunk), CHUNK_NEW new tokens each.
CHUNK_PROMPTS, CHUNK_NEW = 3, 16
# Lengths whose device time phase 4 logs: a one-chunk prompt, the timed
# one, and the longest the engine prefills.
SSD_DEVICE_LENGTHS = (128, 1024, 1536)
# GEMM shapes: qwen3-4b's MLP projections over 2048 tokens (d_model 2560,
# d_ff 9728), ragged edges, and the tiling example's problems.
MLP_SHAPES = ((2048, 2560, 9728), (2048, 9728, 2560))
RAGGED = (1, 127, 4097)
# Phase 10 holds mamba2-370m's logits to FP32_LOGIT_TOL on its first two
# layers (the same weights): with random weights the 48-layer stack is
# chaotic, and two plain fp32 runs that differ only in the scan's chunk
# (64 against 128, the order of its sums) give logits 2.15 apart, 0.028 at
# 16 layers, 6.0e-4 at 4 and 8.2e-5 at 2 (CPU, 301-token prompt). The
# full-depth readings are logged beside that noise, not held to a limit.
MAMBA_CHECK_LAYERS = 2
N_REQUESTS, MAX_NEW = 12, 32
# Phases 3, 4 and 16: speculative decoding drafts SPEC_K tokens a slot, so
# the verify step runs the paged prefill kernel at sq = SPEC_K + 1 over B
# slots. Phase 3 checks widths 2, 3 and 5 from these starts (the last slot
# freed); phase 4 times width 5 from starts spread up to MAX_LEN.
SPEC_K = 4
VERIFY_WIDTHS = (2, 3, 5)
# Phase 28: the chunk's start (qwen3-4b's chunk step as phase 4 times it).
TILE_CHUNK_START = 1024
VERIFY_STARTS = [0, 15, 16, 300, 1023, MAX_LEN - 2, 1800, 700]
# Phase 17: 12 requests sharing a 1024-token prefix (64 pages, 4 chunks)
# and unique suffixes of 64-512 tokens.
PREFIX_LEN, SUFFIX_LO, SUFFIX_HI = 1024, 64, 512
# Phases 16-17's squeezed pool, phase 6's.
SQUEEZED_PAGES = 161
SAMPLE_TEMPERATURE = 0.8          # phase 15
# Phase 7, fp32 logits of the kernel path against the plain path: the
# kernels' summation order moves them by far less than this; a planted
# one-key fault in either kernel by far more.
FP32_LOGIT_TOL = 1e-3
# Phase 12-13: the cache-less forward of qwen3-4b over a 2 x 2048-token
# batch (causal, bf16), and the lengths the kernel is checked at.
FLASH_B, FLASH_S = 2, 2048
FLASH_LENGTHS = ((1, 1), (127, 127), (300, 1031), (2048, 2048))
# Phase 14: qwen2-0.5b trained at batch 4 x 512. The warmup spans all 40
# steps, so the learning rate at a step does not depend on --steps (the
# schedule's length) and a run to 30 resumed to 40 meets a fresh run to
# 40; the fresh run saves only at its end.
TRAIN_ARGS = ["--arch", "qwen2-0.5b", "--batch", "4", "--seq", "512",
              "--warmup", "40"]
# Phase 21: the other model families at their published widths, bf16, one
# model on the card at a time, the depth cut to fit 80 GB: arch -> (layers
# served, layers of the fp32 logit check). The checks keep the weights in
# bf16 and compute in fp32, so llama4's and jamba's one period (2 and 8
# layers; 69 and 49 GiB were their weights in fp32) is checked whole.
FAMILIES = {
    "granite-3-8b": (40, 2),
    "phi3-mini-3.8b": (32, 2),
    "dbrx-132b": (4, 2),
    "llama4-maverick-400b-a17b": (2, 2),
    "jamba-v0.1-52b": (8, 8),
}
FAMILY_REQUESTS, FAMILY_NEW, FAMILY_LO, FAMILY_HI = 8, 16, 64, 512
# Phase 22: whisper-medium whole (8 prompts of 256 tokens, 1,500 audio
# frames each, 32 new tokens) and llama-3.2-vision-90b at 5 of its 20
# periods (25 of 100 layers, about 45 GiB of bf16 weights; 4 prompts of
# 512 tokens, 1,601 patch embeddings each, 16 new tokens), served through
# greedy_generate; whisper trained through the launcher at batch 2 x 448
# (its decoder's context). The decode kernel is timed at each model's
# decode shape, (b, h, kvh, d, first and last context), and the
# full-sequence kernel at its scoring shape, (b, s, h, kvh, d).
ENCDEC = {
    "whisper-medium": dict(depth=None, check_depth=None, b=8, prompt=256,
                           new=32),
    "llama-3.2-vision-90b": dict(depth=25, check_depth=5, b=4, prompt=512,
                                 new=16),
}
ENCDEC_DECODE = {"whisper-medium": (8, 16, 16, 64, 256, 288),
                 "llama-3.2-vision-90b": (4, 64, 8, 128, 512, 528)}
ENCDEC_SCORING = {"whisper-medium": (8, 256, 16, 16, 64),
                  "llama-3.2-vision-90b": (4, 512, 64, 8, 128)}
ENCDEC_CHECK_PROMPT = 300
GATE, GATE_NOISE, BIAS_SCALE = 0.5, 0.1, 0.1
WHISPER_TRAIN_ARGS = ["--arch", "whisper-medium", "--batch", "2", "--seq",
                      "448", "--steps", "10", "--warmup", "10",
                      "--log-every", "1", "--ckpt-every", "10"]
# Phase 23 (a): qwen3-4b at full width served tensor-parallel by TP ranks
# of a gloo group sharing the one card (NCCL refuses two ranks on one
# device), eager (gloo's collectives cannot be captured in a CUDA graph):
# TP_B requests of TP_LO..TP_HI tokens, TP_NEW new each, max_len
# TP_MAX_LEN, so the view a decode step gathers is TP_B x 512 rows of 8 kv
# heads a layer. The logit check writes a TP_CHECK_PROMPT-row prompt a
# slot and decodes one step. A differing fp32 greedy token must sit at a
# near-tie: its two candidates within NEAR_TIE of each other in the
# one-rank fp32 logits. (b): every family trains: gradients of a step on
# the card against the CPU's (GRAD_CHECK: arch -> smoke?, batch, seq),
# within GRAD_TOL of each leaf's largest element (mamba2-370m whole in
# float64, GRAD_F64), and mamba2-370m whole trained MAMBA_STEPS steps at
# batch 4 x 512.
TP = 2
TP_B, TP_MAX_LEN, TP_PS, TP_CHUNK, TP_NEW = 4, 512, 16, 128, 16
TP_LO, TP_HI, TP_CHECK_PROMPT = 100, 400, 300
TP_DEADLINE_S, TP_TIMEOUT_S = 420.0, 240.0
TP_SIZES = [2 ** p for p in range(12, 27, 2)]          # 4 KiB .. 64 MiB
NEAR_TIE = 1e-2
GRAD_CHECK = {"mamba2-370m": (False, 1, 32), "dbrx-132b": (True, 2, 16),
              "jamba-v0.1-52b": (True, 2, 16)}
GRAD_TOL = 1e-3
# The configs whose gate runs in float64 on both sides: mamba2-370m's
# random 48-layer stack is ill-conditioned in fp32 (the CPU against
# itself, 1 thread against 8, differed by 9.7 % of a leaf's largest
# element), well conditioned in float64 (``layers.wide``). Its fp32
# reading is logged beside the CPU's own fp32 spread, not gated.
GRAD_F64 = ("mamba2-370m",)
MAMBA_STEPS, MAMBA_BATCH, MAMBA_SEQ = 8, 4, 512
# Phase 24: training over ranks. (a) qwen2-0.5b whole (24 layers, d_model
# 896, 14/2 heads of 64, d_ff 4,864, vocab 151,936, untied lm_head), fp32
# compute and masters, DIST_B x DIST_S tokens a step, DIST_STEPS steps
# from seed 0, on two gloo ranks sharing the card (NCCL refuses two ranks
# on one device): each mesh of DIST_MESHES against one rank's steps in
# the same call. Gates: every step's loss within DIST_LOSS_RTOL of one
# rank's; the first step's averaged gradients, gathered whole, within
# GRAD_TOL of each leaf's largest element; the data-axis mean skipped on
# DIST_FAULT_LEAF must break that gate; a checkpoint saved at step 2 under
# FSDP, restored onto (1, 2), takes step 3 to the uninterrupted run's
# loss within DIST_LOSS_RTOL. (b) GPipe: the 24 blocks in GPIPE_STAGES
# stages, GPIPE_MICRO microbatches of 1 x DIST_S, forward through
# ``flash_attention`` (fp32), against the sequential stack on one rank
# within GPIPE_TOL of the output's largest element.
DIST_ARCH = "qwen2-0.5b"
DIST_B, DIST_S, DIST_STEPS = 4, 512, 3
DIST_MESHES = (("fsdp", (2, 1), True), ("model", (1, 2), False))
DIST_LOSS_RTOL = 1e-4
DIST_FAULT_LEAF = "ln_f/scale"
DIST_LAYERS = 24
GPIPE_STAGES, GPIPE_MICRO, GPIPE_TOL = 2, 4, 1e-4
DIST_DEADLINE_S, DIST_TIMEOUT_S = 900.0, 300.0
# Phase 25: the model axis for every family, on EP gloo ranks sharing the
# card, each against one rank in the same call. (a) dbrx-132b at its
# published widths (d_model 6144, 48/8 heads of 128, 16 experts of d_ff
# 10752, top-4, capacity routing, vocab 100352) cut to EP_LAYERS of 40
# layers, both MoE: bf16 weights (15.5 GB whole, 7.8 GB a rank) and fp32
# compute, the paged engine (capture off) over phase 23's requests (TP_B
# slots of TP_LO..TP_HI tokens, TP_NEW new, max_len TP_MAX_LEN). Gates:
# streams equal; fp32 logits of a prefill and a decode step within
# FP32_LOGIT_TOL of one rank's, which a combine left unreduced on layer 0
# must exceed, routed at capacity factor EP_CHECK_CAPACITY so that the
# capacity path drops, and the drops equal; the engine's drops equal on
# both ranks, one rank's, and one rank's again (a second engine over the
# same requests: garbage rows, of freed slots and padded chunks, route
# too, and read the null page, whose colliding writes keep the last);
# ``flash_decode`` launched attention layers x decode steps a rank. (b) a
# "self" model draft (``spec_k`` SPEC_K) on phase 23's two-rank qwen3-4b
# engine, fp32 compute, TP_B prompts of EP_DRAFT_LO..EP_DRAFT_HI tokens
# and EP_SPEC_NEW new: every context fits the draft's 32-token window,
# so its positions are the target's and its drafts are accepted. Gates:
# streams equal the two-rank plain engine's and one rank's, drafts
# proposed and accepted equal on both ranks and one rank, some accepted,
# and only rank 0 holding a draft. (c) mamba2-370m whole over (data 1, model EP): the first step's
# gradients against one rank's in float64 (GRAD_F64) within GRAD_TOL, the
# fp32 reading logged; then EP_TRAIN_STEPS fp32 steps at MAMBA_BATCH x
# MAMBA_SEQ on both, logged. (d) one fp32 step of each of EP_SMOKES over
# (1, EP) against one rank's: loss within EP_LOSS_RTOL, gradients within
# EP_GRAD_TOL of each leaf's largest element (jamba EP_JAMBA_TOL, its
# fp32 conditioning; a leaf whose gradient is zero up to rounding floored
# at EP_ZERO_GRAD of the whole gradient's largest), the gate and biases
# seeded; whisper smoke's ``encode`` within EP_GRAD_TOL. EP_TARGET_S is
# the phase's budget, logged beside its seconds.
EP = 2
EP_ARCH, EP_LAYERS = "dbrx-132b", 2
EP_SPEC_NEW = 8
EP_DRAFT_LO, EP_DRAFT_HI = 12, 32 - EP_SPEC_NEW
EP_TRAIN_STEPS = 3
EP_SMOKES = (("dbrx-132b", {"moe_impl": "capacity"}),
             ("dbrx-132b", {"moe_impl": "dense_mask"}),
             ("llama4-maverick-400b-a17b", {}), ("jamba-v0.1-52b", {}),
             ("llama-3.2-vision-90b", {}))
EP_LOSS_RTOL, EP_GRAD_TOL, EP_ZERO_GRAD, EP_JAMBA_TOL = 1e-6, 1e-5, 1e-2, 2e-4
EP_CHECK_CAPACITY = 0.5
EP_DEADLINE_S, EP_TIMEOUT_S, EP_TARGET_S = 900.0, 300.0, 180.0


def log(msg: str) -> None:
    print(msg, flush=True)


def require_full_fp32() -> None:
    """fp32 products must stay fp32: a TF32 ``torch.matmul`` would give
    the GEMM's plain version and yardstick three decimal digits."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 is on")


def bound(nbytes: float, n_ops: float, dtype) -> tuple:
    """(ms, "bytes" or "operations"): the least time the card could take,
    bytes over its memory rate against operations over its peak for the
    type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def tflops(n_ops: float, ms: float) -> float:
    return n_ops / ms / 1e9


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_report(build_log: str) -> list:
    """One line a kernel from the compiler's ``-Xptxas -v`` report:
    registers and spills, the tensor-core kernels marked."""
    names, regs, spills, fn = [], {}, {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
            names.append(fn)
        elif fn and "spill stores" in line:
            spills[fn] = line.strip()
        elif fn and "Used" in line and "registers" in line:
            regs[fn] = re.search(r"Used (\d+) registers", line).group(1)
    shown = names
    if shutil.which("c++filt"):
        shown = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True
                               ).stdout.splitlines() or names
    out = []
    for fn, name in zip(names, shown):
        name = re.sub(r"\(anonymous namespace\)::|\(.*\)$", "", name)
        tc = " [tensor cores]" if ("wgmma" in fn or "mma_kernel" in fn) \
            else ""
        out.append(f"{name}{tc}: {regs.get(fn, '?')} registers; "
                   f"{spills.get(fn, '?')}")
    return out


def toolchain(build_mod) -> str:
    rel = subprocess.run([build_mod.nvcc(), "--version"], capture_output=True,
                         text=True, check=True).stdout
    release = next((l.strip() for l in rel.splitlines() if "release" in l),
                   "?")
    cutlass = "/usr/local/cutlass/include"
    return (f"torch {torch.__version__}, torch.version.cuda "
            f"{torch.version.cuda}, nvcc: {release}, CUTLASS headers: "
            f"{cutlass if os.path.isdir(cutlass) else 'absent'}")


# ----------------------------------------------------------------------------
# Kernels against their plain versions
# ----------------------------------------------------------------------------

def _tables(gen, dev, lengths, max_pages):
    """Shuffled tables: each slot maps the pages its rows need to distinct
    pages drawn from a permutation of the pool (a pool after churn)."""
    perm = torch.randperm(N_PAGES - 1, generator=gen, device=dev) + 1
    table = torch.zeros((len(lengths), max_pages), dtype=torch.int32,
                        device=dev)
    at = 0
    for i, n in enumerate(lengths):
        k = min(-(-int(n) // PS), max_pages)
        table[i, :k] = perm[at:at + k].int()
        at += k
    assert at <= N_PAGES - 1, at
    return table


def check_kernels(dev, ops, ref) -> list:
    """Every kernel against its plain version; returns failures."""
    gen = torch.Generator(device=dev).manual_seed(0)
    max_pages = MAX_LEN // PS
    failures = []
    for dtype in (torch.float32, torch.bfloat16):
        for d in HEAD_DIMS:
            rnd = lambda *s: torch.randn(*s, generator=gen, device=dev).to(dtype)  # noqa: E731
            kp, vp = rnd(N_PAGES, PS, KVH, d), rnd(N_PAGES, PS, KVH, d)
            lengths = [0, 1, 15, 16, 17, 700, 1201, 2048]
            table = _tables(gen, dev, lengths, max_pages)
            lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
            q = rnd(B, H, d)
            got = ops.flash_decode_paged(q, kp, vp, table, lens)
            torch.cuda.synchronize()
            ok, err = ref.compare(got, ref.flash_decode_paged(q, kp, vp,
                                                              table, lens))
            tol = ref.TOLERANCE[dtype]
            log(f"  decode  {str(dtype):14s} d={d:3d}: max_abs_err {err:.3e} "
                f"(atol {tol[0]:g} + rtol {tol[1]:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(("flash_decode_paged", dtype, d, err))
            # Chunks at start 0 and later, one running past the table's
            # end (1900 + 256 > 2048: a padded tail), ragged per slot.
            starts = [0, 256, 1024, 1536, 1792, 1900, 100, 17]
            table = _tables(gen, dev, [min(s + CHUNK, MAX_LEN)
                                       for s in starts], max_pages)
            st = torch.tensor(starts, dtype=torch.int32, device=dev)
            qc = rnd(B, CHUNK, H, d)
            got = ops.flash_attention_paged(qc, kp, vp, table, st)
            torch.cuda.synchronize()
            ok, err = ref.compare(got, ref.flash_attention_paged(
                qc, kp, vp, table, st))
            log(f"  prefill {str(dtype):14s} d={d:3d}: max_abs_err {err:.3e} "
                f"(atol {tol[0]:g} + rtol {tol[1]:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(("flash_attention_paged", dtype, d, err))
            # The verify step's shape: B slots of k + 1 rows from ragged
            # starts: 0, across a page boundary, MAX_LEN - 2 (its last
            # rows past the table's end), and a freed slot whose table
            # row is zero (all its rows in the null page).
            table = _tables(gen, dev, [min(s + SPEC_K + 1, MAX_LEN)
                                       for s in VERIFY_STARTS], max_pages)
            table[-1] = 0
            st = torch.tensor(VERIFY_STARTS, dtype=torch.int32, device=dev)
            for sq in VERIFY_WIDTHS:
                qv = rnd(B, sq, H, d)
                got = ops.flash_attention_paged(qv, kp, vp, table, st)
                torch.cuda.synchronize()
                ok, err = ref.compare(got, ref.flash_attention_paged(
                    qv, kp, vp, table, st))
                log(f"  verify  {str(dtype):14s} d={d:3d} sq={sq}: "
                    f"max_abs_err {err:.3e} (starts {VERIFY_STARTS}, the "
                    f"last slot freed) {'ok' if ok else 'FAIL'}")
                if not ok:
                    failures.append(("flash_attention_paged verify", dtype,
                                     d, sq, err))
    return failures


# Phase 3's lengths about the split decode's 256-row boundaries (two
# batches of B slots over a reach of MAX_LEN rows): 0, 1, each boundary's
# neighbours, the reach, and past it (clamped).
SPLIT_LENGTHS = ([0, 1, 255, 256, 257, 511, 512, 513],
                 [767, 768, 769, 1023, 1025, 1791, MAX_LEN, MAX_LEN + 52])
# (h, kvh): the main path's, and groups 1, 4 and 7 over 2 kv heads.
DECODE_HEADS = ((H, KVH), (2, 2), (8, 2), (14, 2))


def check_decode_splits(dev, ops, ref, decode_mod) -> list:
    """Both decodes against their plain versions at DECODE_HEADS and
    SPLIT_LENGTHS, fp32 and bf16, head_dim 64/80/96/128: within
    ``ref.TOLERANCE``, exact zeros for a zero length, the same bits from
    a second launch on the same inputs, and the merge's counters left at
    zero; returns failures."""
    gen = torch.Generator(device=dev).manual_seed(4)
    max_pages = MAX_LEN // PS
    failures = []
    for paged in (True, False):
        run = ops.flash_decode_paged if paged else ops.flash_decode
        plain = ref.flash_decode_paged if paged else ref.flash_decode
        for dtype in (torch.float32, torch.bfloat16):
            rnd = lambda *s: torch.randn(*s, generator=gen, device=dev).to(dtype)  # noqa: E731
            tol = ref.TOLERANCE[dtype]
            for d in HEAD_DIMS:
                worst, bad = 0.0, []
                for h, kvh in DECODE_HEADS:
                    for lengths in SPLIT_LENGTHS:
                        lens = torch.tensor(lengths, dtype=torch.int32,
                                            device=dev)
                        q = rnd(B, h, d)
                        if paged:
                            n_pages = 1 + B * max_pages
                            kv = (rnd(n_pages, PS, kvh, d),
                                  rnd(n_pages, PS, kvh, d))
                            perm = torch.randperm(n_pages - 1, generator=gen,
                                                  device=dev) + 1
                            args = (q, *kv, perm.reshape(B, max_pages).int(),
                                    lens)
                        else:
                            args = (q, rnd(B, MAX_LEN, kvh, d),
                                    rnd(B, MAX_LEN, kvh, d), lens)
                        got, again = run(*args), run(*args)
                        torch.cuda.synchronize()
                        ok, err = ref.compare(got, plain(*args))
                        worst = max(worst, err)
                        zero = lens == 0
                        if not ok:
                            bad.append(("tolerance", h, kvh, lengths, err))
                        if bool(got[zero].any()):
                            bad.append(("zero length not zeros", h, kvh))
                        if not torch.equal(got, again):
                            bad.append(("two launches differ", h, kvh))
                name = "flash_decode_paged" if paged else "flash_decode"
                log(f"  {name} {str(dtype):14s} d={d:3d}: (h, kvh) in "
                    f"{DECODE_HEADS}, lengths about the splits: max_abs_err "
                    f"{worst:.3e} (atol {tol[0]:g} + rtol {tol[1]:g}); zero "
                    f"lengths exact zeros, second launch bit-identical: "
                    f"{'ok' if not bad else bad}")
                failures += [(name, dtype, d, *f) for f in bad]
    left = [c for c in decode_mod._COUNTERS.values() if c.any()]
    log(f"  the merge's counters after these launches: "
        f"{'all zero' if not left else 'NOT ZERO'}")
    if left:
        failures.append(("decode counters left non-zero", left))
    return failures


def ssd_inputs(gen, dev, dtype, bt, l, h0=False, shape=SSD_SHAPES[0]):
    """SSD scan inputs at a head shape (h, p, n), the main path's by
    default. The decays are the model's: a = -softplus(N(0, 1)) *
    linspace(1, 16, h) (dt * A with the reference's A_log
    initialisation). B and C are scaled by 0.3 (0.3 * (128 / n) ** 0.25
    at a smaller d_state) so that C.B is about 1 and y about 1, where an
    absolute tolerance means what it says."""
    h, p, n = shape
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    x = rnd(bt, l, h, p).to(dtype)
    a = -F.softplus(rnd(bt, l, h)) * torch.linspace(1, 16, h, device=dev)
    scale = 0.3 * (SSD_N / n) ** 0.25
    b = (scale * rnd(bt, l, n)).to(dtype)
    c = (scale * rnd(bt, l, n)).to(dtype)
    return x, a, b, c, (0.5 * rnd(bt, h, p, n) if h0 else None)


def check_contiguous_kernels(dev, ops, ref, decode_mod) -> list:
    """The contiguous decode and the SSD scan against their plain
    versions; for the scan also the same bits from a second launch and
    the hand-off's ints left at zero; returns failures."""
    gen = torch.Generator(device=dev).manual_seed(3)
    failures = []
    for dtype in (torch.float32, torch.bfloat16):
        tol = ref.TOLERANCE[dtype]
        rnd = lambda *s: torch.randn(*s, generator=gen, device=dev).to(dtype)  # noqa: E731
        for d in HEAD_DIMS:
            k, v = rnd(B, MAX_LEN, KVH, d), rnd(B, MAX_LEN, KVH, d)
            lens = torch.tensor([0, 1, 63, 64, 65, 700, 1201, MAX_LEN],
                                dtype=torch.int32, device=dev)
            q = rnd(B, H, d)
            got = ops.flash_decode(q, k, v, lens)
            torch.cuda.synchronize()
            ok, err = ref.compare(got, ref.flash_decode(q, k, v, lens))
            log(f"  decode (contiguous) {str(dtype):14s} d={d:3d}: max_abs_err "
                f"{err:.3e} (atol {tol[0]:g} + rtol {tol[1]:g}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(("flash_decode", dtype, d, err))
        for shape in SSD_SHAPES:
            for bt, l in SSD_CASES:
                for h0 in (False, True):
                    x, a, b, c, h = ssd_inputs(gen, dev, dtype, bt, l, h0,
                                               shape)
                    y, st = ops.ssd_scan(x, a, b, c, h0=h)
                    y2, st2 = ops.ssd_scan(x, a, b, c, h0=h)
                    torch.cuda.synchronize()
                    wy, ws = ref.ssd_scan(x, a, b, c, h0=h, chunk=SSD_CHUNK)
                    (ok_y, err_y), (ok_s, err_s) = (
                        ref.compare(y, wy, normwise=True),
                        ref.compare(st, ws, normwise=True))
                    same = torch.equal(y, y2) and torch.equal(st, st2)
                    log(f"  ssd_scan {str(dtype):14s} (h, p, n) {shape} "
                        f"bt={bt} l={l:4d} h0={int(h0)}: max_abs_err y "
                        f"{err_y:.3e} state {err_s:.3e} (max |y| "
                        f"{float(wy.float().abs().max()):.2f}, max |state| "
                        f"{float(ws.abs().max()):.2f}; tolerance scaled by "
                        f"them) {'ok' if ok_y and ok_s else 'FAIL'}; second "
                        f"launch {'bit-identical' if same else 'DIFFERS'}")
                    if not (ok_y and ok_s):
                        failures.append(("ssd_scan", dtype, shape, bt, l, h0,
                                         err_y, err_s))
                    if not same:
                        failures.append(("ssd_scan two launches differ",
                                         dtype, shape, bt, l, h0))
    left = [c for c in decode_mod._COUNTERS.values() if c.any()]
    log(f"  the hand-off's tickets and counts after these launches: "
        f"{'all zero' if not left else 'NOT ZERO'}")
    if left:
        failures.append(("ssd_scan tickets or counts left non-zero", left))
    return failures


# Phase 3: the timed chase's chain of more than 8 GiB (past int32 slot
# indices' reach), visited at BIG_CHAIN_LOADS addresses spread over it.
BIG_CHAIN_BYTES = 9 * 2**30
BIG_CHAIN_LOADS = 4096


def check_timed_chase(dev, ops, ref, simulator) -> list:
    """``pchase_timed`` against its plain version: the offsets it visits
    bit-equal, with ``ld.global.ca`` and ``.cg``; a chain of more than
    8 GiB checked on the card; a bad offset refused. Returns failures."""
    failures = []
    rng = np.random.RandomState(7)
    perm = rng.permutation(4096)
    ring = np.zeros(4096, np.int64)
    ring[perm] = np.roll(perm, -1) * 8
    chains = [("4096-slot permutation", ring, 10_000, 0, 0),
              ("stride 64 over 64 KiB, from 64 after 17 untimed",
               simulator.make_chain(64 * 2**10, 64), 3000, 64, 17),
              ("1 MiB line chain", simulator.make_chain(2**20, 128), 20_000,
               0, 0)]
    for label, chain, steps, start, warm in chains:
        t = torch.from_numpy(chain).to(dev)
        want = ref.pchase_timed(t, steps, start=start, warm=warm)
        for cg in (False, True):
            got, cycles, total = ops.pchase_timed(
                t, steps, start=start, warm=warm, bypass_l1=cg)
            torch.cuda.synchronize()
            same = torch.equal(got, want)
            total, loads = int(total.item()), int(cycles.long().sum())
            log(f"  pchase_timed {'.cg' if cg else '.ca'} {label}, {steps} "
                f"steps: {'bit-equal' if same else 'FAIL: differs'}; cycles "
                f"min {int(cycles.min())} median "
                f"{int(cycles.median())} max {int(cycles.max())}; the "
                f"walk's total {total}, the loads' windows "
                f"{100 * loads / total:.1f} % of it")
            if not same or int(cycles.min()) <= 0 or total < loads:
                failures.append(("pchase_timed", label, cg))
    # More than 8 GiB: the addresses in a random order over the whole
    # chain, each laid out to name the next.
    n_slots = BIG_CHAIN_BYTES // 8
    gap = n_slots // BIG_CHAIN_LOADS
    addrs = ((np.arange(BIG_CHAIN_LOADS) * gap
              + rng.randint(0, gap, BIG_CHAIN_LOADS)) * 8)[
        rng.permutation(BIG_CHAIN_LOADS)]
    big = torch.zeros(n_slots, dtype=torch.int64, device=dev)
    big[torch.from_numpy(addrs // 8).to(dev)] = torch.from_numpy(
        np.roll(addrs, -1)).to(dev)
    steps = 3 * BIG_CHAIN_LOADS
    want = torch.from_numpy(np.resize(np.roll(addrs, -5), steps)).to(dev)
    for cg in (False, True):
        got, _, _ = ops.pchase_timed(big, steps, start=int(addrs[5]),
                                     bypass_l1=cg)
        follows = bool((big[got[:-1] // 8] == got[1:]).all())
        same = torch.equal(got, want)
        log(f"  pchase_timed {'.cg' if cg else '.ca'} over a "
            f"{BIG_CHAIN_BYTES / 2**30:.0f} GiB chain, {steps} steps, "
            f"offsets up to {int(got.max()) / 2**30:.2f} GiB: each the "
            f"chain's entry at the one before "
            f"{'yes' if follows else 'NO'}, the laid-out order "
            f"{'yes' if same else 'NO'}")
        if not (follows and same and int(got.max()) >= 2**33):
            failures.append(("pchase_timed", "9 GiB chain", cg))
    del big
    bad = torch.full((16,), 3, dtype=torch.int64, device=dev)
    try:
        ops.pchase_timed(bad, 4)
        failures.append(("pchase_timed", "bad offset not refused"))
    except ValueError as e:
        log(f"  pchase_timed refuses an unaligned offset: {e}")
    torch.cuda.empty_cache()
    return failures


def perm_chain(n: int, seed: int) -> np.ndarray:
    """One random cycle through n positions: the chain of the reference's
    ``tests/test_kernels.py::test_pchase_kernel_follows_chain`` at n 128,
    seed 4."""
    rng = np.random.RandomState(seed)
    perm = rng.permutation(n).astype(np.int32)
    chain = np.empty(n, np.int32)
    chain[perm] = np.roll(perm, -1)
    return chain


def gemm_path_wanted(dtype, k: int, n: int) -> str:
    """The path a GEMM launch must take: fp32 on the CUDA cores; bf16 on
    the tensor cores, fed by TMA where its rows have 16-byte strides."""
    if dtype == torch.float32:
        return "cuda cores"
    if k > 0 and k % 8 == 0 and n % 8 == 0:
        return "wgmma + TMA"
    return "wgmma + element loads"


def check_probe_kernels(dev, ops, ref, latency, gemm_kernel) -> list:
    """The GEMM with every tile of each dtype and the pointer chase
    against their plain versions; returns failures. The GEMM is compared
    normwise (its outputs grow with sqrt(k)), and each launch must take
    the path its dtype and shape call for (``gemm_path_wanted``)."""
    require_full_fp32()
    gen = torch.Generator(device=dev).manual_seed(5)
    failures = []
    shapes = [(m, k, n) for m in RAGGED for k in RAGGED for n in RAGGED]
    shapes += list(MLP_SHAPES)
    for dtype in (torch.float32, torch.bfloat16):
        tiles = gemm_kernel.TILES[dtype]
        worst = {t: 0.0 for t in tiles}
        paths = {}
        for m, k, n in shapes:
            x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
            y = torch.randn(k, n, generator=gen, device=dev).to(dtype)
            want = ref.gemm(x, y)
            for tile in tiles:
                gemm_kernel.last_path = None
                got = ops.gemm(x, y, block=tile)
                torch.cuda.synchronize()
                ok, err = ref.compare(got, want, normwise=True)
                worst[tile] = max(worst[tile], err)
                if not ok:
                    failures.append(("gemm", dtype, tile, (m, k, n), err))
                if gemm_kernel.last_path != gemm_path_wanted(dtype, k, n):
                    failures.append(("gemm path", dtype, tile, (m, k, n),
                                     gemm_kernel.last_path))
                paths.setdefault(gemm_kernel.last_path, set()).add((m, k, n))
        for path, where in paths.items():
            log(f"  gemm {str(dtype):14s} path {path!r}: {len(where)} shapes"
                + (f", the MLP shapes {MLP_SHAPES} among them"
                   if set(MLP_SHAPES) <= where else ""))
        tol = ref.TOLERANCE[dtype]
        for tile, err in worst.items():
            log(f"  gemm {str(dtype):14s} tile {tile}: {len(shapes)} shapes "
                f"(m, k, n each in {RAGGED}, and {MLP_SHAPES}): max_abs_err "
                f"{err:.3e} (atol {tol[0]:g} x max(1, max |out|) + rtol "
                f"{tol[1]:g})")
    chains = [("128-entry permutation", perm_chain(128, 4), 64),
              ("128-entry permutation, steps past n", perm_chain(128, 4),
               1000),
              ("stride 32 over 4096", (np.arange(4096) + 32) % 4096, 5000),
              ("1 MiB line chain", None, latency.STEPS)]
    for label, chain, steps in chains:
        chain = (latency.line_chain(2**20, device=dev) if chain is None
                 else torch.from_numpy(chain.astype(np.int32)).to(dev))
        got = ops.pchase(chain, steps)
        torch.cuda.synchronize()
        same = torch.equal(got, ref.pchase(chain, steps))
        log(f"  pchase {label}, {steps} steps: "
            f"{'bit-equal' if same else 'FAIL: differs'}")
        if not same:
            failures.append(("pchase", label, steps))
    return failures


# ----------------------------------------------------------------------------
# Times at the main path's shapes
# ----------------------------------------------------------------------------

def time_ms(fn, n_layers: int, iters: int = 50, spin: bool = False) -> float:
    """Mean time of ``fn(layer)`` between CUDA events over ``iters``
    launches cycling through ``n_layers`` distinct pools (as the engine's
    layers do), so that the 50 MB L2 cache does not hold one pool across
    launches. The launches are issued at the host's pace, as a caller
    issues them.

    ``spin=True`` gives the device time instead: the launches are queued
    behind a spin of the card (``torch.cuda._sleep``), so that they run
    back to back however long the host takes to issue each. The spin
    grows until the host has queued every launch before it ends; a
    function that synchronises never gets ahead and is timed at the
    host's pace, and says so."""
    for i in range(3):
        fn(i % n_layers)
    torch.cuda.synchronize()
    cycles = SPIN_CYCLES
    while True:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        if spin:
            torch.cuda._sleep(cycles)
        start.record()
        for i in range(iters):
            fn(i % n_layers)
        end.record()
        ahead = spin and not start.query()   # the card still spinning
        torch.cuda.synchronize()
        if ahead or not spin or cycles >= 16 * SPIN_CYCLES:
            if spin and not ahead:
                log("    (the host could not queue these launches ahead of "
                    "the card: timed at the host's pace)")
            return start.elapsed_time(end) / iters
        cycles *= 4


def ssd_work(l: int, esize: int, shape=SSD_SHAPES[0],
             chunk: int = SSD_CHUNK) -> tuple:
    """(bytes, flops) of a batch-1 SSD scan of l rows at a head shape (h,
    p, n), the main path's by default, from a zero state: x read and y
    written, a_log, B and C read, the fp32 state written. The flops are
    the useful ones per chunk and head: the causal half of C.B^T (n each)
    and of the decayed scores times x (p each), the carried state's term
    and the state update (p * n each per row)."""
    from repro_torch.kernels import cost

    h, p, n = shape
    return cost.ssd_scan(1, l, h, p, n, esize, chunk)


def ssd_grid(bt: int, l: int, shape=SSD_SHAPES[0],
             chunk: int = SSD_CHUNK) -> str:
    from repro_torch.kernels import ssd_scan as ssd_mod
    gx, gy, gz = ssd_mod.grid(bt, l, shape[0], shape[1], chunk)
    return (f"({gx}, {gy}, {gz}) = {gx * gy * gz} CTAs (head x p-block of "
            f"{ssd_mod.P_BLOCK}, chunk of {chunk}, batch row)")


def decode_grid(decode_mod, lengths, max_rows: int, page_size: int,
                h: int = H, kvh: int = KVH, d: int = D,
                dtype=torch.bfloat16) -> str:
    """The split decode's grid at these lengths, in the splits the tile
    chooser picks for the shape: its CTAs, and those with rows to read
    (one query block: a group of up to 16 fits one)."""
    from repro_torch.kernels import ops
    q = torch.empty(len(lengths), h, d, dtype=dtype, device="meta")
    tile = ops.decode_tile(q, kvh, max_rows, page_size)
    rows, n_splits = decode_mod.splits(max_rows, page_size, tile.block_k)
    live = kvh * sum(-(-min(n, max_rows) // rows) for n in lengths)
    return (f"{n_splits} splits of {rows} rows (the chooser's block_k "
            f"{tile.block_k}), {kvh * len(lengths) * n_splits} CTAs, "
            f"{live} with rows")


def time_kernels(dev, ops, ref, decode_mod) -> dict:
    """Kernel, plain and library times and the bound, bf16, main path."""
    from repro_torch.kernels import cost

    dtype = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(1)
    esize = 2
    n_layers = 4                      # 4 x 42 MB of pools > 50 MB of L2
    max_pages = MAX_LEN // PS
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev).to(dtype)  # noqa: E731
    pools = [(rnd(N_PAGES, PS, KVH, D), rnd(N_PAGES, PS, KVH, D))
             for _ in range(n_layers)]
    out = {}

    # Decode: b = 8 slots with contexts spread over 512..2048 rows.
    lengths = [int(x) for x in np.linspace(512, 2048, B)]
    table = _tables(gen, dev, lengths, max_pages)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    q = rnd(B, H, D)
    ok, err = ref.compare(ops.flash_decode_paged(q, *pools[0], table, lens),
                          ref.flash_decode_paged(q, *pools[0], table, lens))
    kv_rows = sum(lengths)
    pages_read = sum(-(-n // PS) for n in lengths)
    nbytes = (2 * q.numel() * esize + 2 * kv_rows * KVH * D * esize
              + 4 * (pages_read + B))
    ops_n = 4 * kv_rows * H * D
    # The library yardstick reads a gathered, padded (b, kvh, 2048, d)
    # view with a length mask; the gather is not timed.
    views = []
    for kp, vp in pools:
        kc, vc = (t.permute(0, 2, 1, 3).contiguous()
                  for t in ref.gather_kv(kp, vp, table))
        views.append((kc, vc))
    mask = (torch.arange(MAX_LEN, device=dev)[None, :]
            < lens[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    out["flash_decode_paged"] = dict(
        max_abs_err=err, ok=ok,
        ms=time_ms(lambda i: ops.flash_decode_paged(q, *pools[i], table,
                                                    lens), n_layers),
        plain_ms=time_ms(lambda i: ref.flash_decode_paged(
            q, *pools[i], table, lens), n_layers, iters=10),
        library_ms=time_ms(lambda i: F.scaled_dot_product_attention(
            q4, views[i][0], views[i][1], attn_mask=mask, enable_gqa=True),
            n_layers),
        device_ms=time_ms(lambda i: ops.flash_decode_paged(
            q, *pools[i], table, lens), n_layers, spin=True),
        library_device_ms=time_ms(lambda i: F.scaled_dot_product_attention(
            q4, views[i][0], views[i][1], attn_mask=mask, enable_gqa=True),
            n_layers, spin=True),
        grid=decode_grid(decode_mod, lengths, MAX_LEN, PS),
        bytes=nbytes, ops=ops_n,
        shape=f"b={B} h={H} kvh={KVH} d={D} page={PS} contexts "
              f"{lengths[0]}..{lengths[-1]} (sum {kv_rows})")
    del views

    # Prefill: one chunk of 256 rows at start 1024 (the engine's batch-1
    # chunk step).
    start = 1024
    n_keys = start + CHUNK
    table = _tables(gen, dev, [n_keys], max_pages)
    st = torch.tensor([start], dtype=torch.int32, device=dev)
    qc = rnd(1, CHUNK, H, D)
    ok, err = ref.compare(
        ops.flash_attention_paged(qc, *pools[0], table, st),
        ref.flash_attention_paged(qc, *pools[0], table, st))
    pairs = sum(start + r + 1 for r in range(CHUNK))
    nbytes = (2 * qc.numel() * esize + 2 * n_keys * KVH * D * esize
              + 4 * (-(-n_keys // PS) + 1))
    ops_n = 4 * pairs * H * D
    views = []
    for kp, vp in pools:
        kc, vc = (t[:, :n_keys].permute(0, 2, 1, 3).contiguous()
                  for t in ref.gather_kv(kp, vp, table))
        views.append((kc, vc))
    cmask = (torch.arange(n_keys, device=dev)[None, :]
             <= start + torch.arange(CHUNK, device=dev)[:, None])
    qt = qc.permute(0, 2, 1, 3).contiguous()
    out["flash_attention_paged"] = dict(
        max_abs_err=err, ok=ok,
        ms=time_ms(lambda i: ops.flash_attention_paged(qc, *pools[i], table,
                                                       st), n_layers),
        plain_ms=time_ms(lambda i: ref.flash_attention_paged(
            qc, *pools[i], table, st), n_layers, iters=10),
        library_ms=time_ms(lambda i: F.scaled_dot_product_attention(
            qt, views[i][0], views[i][1], attn_mask=cmask, enable_gqa=True),
            n_layers),
        bytes=nbytes, ops=ops_n,
        shape=f"b=1 sq={CHUNK} start={start} h={H} kvh={KVH} d={D} "
              f"page={PS}")
    del views

    # The verify step: B slots of SPEC_K + 1 rows from starts spread over
    # 512..MAX_LEN - SPEC_K - 1 (phase 16's shape).
    w = SPEC_K + 1
    starts = [int(x) for x in np.linspace(512, MAX_LEN - w, B)]
    table = _tables(gen, dev, [s + w for s in starts], max_pages)
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    qv = rnd(B, w, H, D)
    ok, err = ref.compare(
        ops.flash_attention_paged(qv, *pools[0], table, st),
        ref.flash_attention_paged(qv, *pools[0], table, st))
    kv_rows = sum(s + w for s in starts)
    pairs = sum(s + r + 1 for s in starts for r in range(w))
    nbytes = (2 * qv.numel() * esize + 2 * kv_rows * KVH * D * esize
              + 4 * (sum(-(-(s + w) // PS) for s in starts) + B))
    ops_n = 4 * pairs * H * D
    views = []
    for kp, vp in pools:
        kc, vc = (t.permute(0, 2, 1, 3).contiguous()
                  for t in ref.gather_kv(kp, vp, table))
        views.append((kc, vc))
    vmask = (torch.arange(MAX_LEN, device=dev)[None, None, :]
             <= (st[:, None] + torch.arange(w, device=dev)[None, :])
             [:, :, None])[:, None]
    qt = qv.permute(0, 2, 1, 3).contiguous()
    verify = dict(
        max_abs_err=err, ok=ok,
        ms=time_ms(lambda i: ops.flash_attention_paged(qv, *pools[i], table,
                                                       st), n_layers),
        device_ms=time_ms(lambda i: ops.flash_attention_paged(
            qv, *pools[i], table, st), n_layers, spin=True),
        plain_ms=time_ms(lambda i: ref.flash_attention_paged(
            qv, *pools[i], table, st), n_layers, iters=10),
        library_ms=time_ms(lambda i: F.scaled_dot_product_attention(
            qt, views[i][0], views[i][1], attn_mask=vmask, enable_gqa=True),
            n_layers),
        library_device_ms=time_ms(lambda i: F.scaled_dot_product_attention(
            qt, views[i][0], views[i][1], attn_mask=vmask, enable_gqa=True),
            n_layers, spin=True),
        bytes=nbytes, ops=ops_n,
        shape=f"b={B} sq={w} starts {starts[0]}..{starts[-1]} h={H} "
              f"kvh={KVH} d={D} page={PS}")
    verify["bound_ms"], verify["bound_by"] = bound(nbytes, ops_n, dtype)
    vq = ops.prefill_tile(qv, max_pages * PS, True).block_q
    log(f"  flash_attention_paged at the verify shape [{verify['shape']}, "
        f"bf16]: kernel {verify['ms']:.4f} ms at the host's pace, device "
        f"time {verify['device_ms']:.4f} ms "
        f"({tflops(ops_n, verify['device_ms']):.2f} TFLOP/s, "
        f"{100 * verify['bound_ms'] / verify['device_ms']:.1f} % of its "
        f"bound), plain {verify['plain_ms']:.4f} ms, SDPA "
        f"{verify['library_ms']:.4f} ms (device time "
        f"{verify['library_device_ms']:.4f} ms), bound "
        f"{verify['bound_ms']:.4f} ms ({verify['bound_by']}: "
        f"{nbytes / 1e6:.2f} MB, {ops_n / 1e9:.3f} GFLOP), grid "
        f"({-(-w // vq)}, {H}, {B}) CTAs of the chooser's {vq}-row query "
        f"block, max_abs_err {err:.3e} {'ok' if ok else 'FAIL'}")
    del views, pools

    # Contiguous decode: the same slots and contexts over a (b, max_len,
    # kvh, d) cache per layer.
    caches = [(rnd(B, MAX_LEN, KVH, D), rnd(B, MAX_LEN, KVH, D))
              for _ in range(n_layers)]
    ok, err = ref.compare(ops.flash_decode(q, *caches[0], lens),
                          ref.flash_decode(q, *caches[0], lens))
    nbytes, decode_ops = cost.flash_decode(B, H, KVH, D, esize, kv_rows)
    # The library yardstick reads a (b, kvh, max_len, d) copy with a
    # length mask; the copy is not timed.
    views = [tuple(t.permute(0, 2, 1, 3).contiguous() for t in kv)
             for kv in caches]
    out["flash_decode"] = dict(
        max_abs_err=err, ok=ok,
        ms=time_ms(lambda i: ops.flash_decode(q, *caches[i], lens),
                   n_layers),
        plain_ms=time_ms(lambda i: ref.flash_decode(q, *caches[i], lens),
                         n_layers, iters=10),
        library_ms=time_ms(lambda i: F.scaled_dot_product_attention(
            q4, views[i][0], views[i][1], attn_mask=mask, enable_gqa=True),
            n_layers),
        device_ms=time_ms(lambda i: ops.flash_decode(q, *caches[i], lens),
                          n_layers, spin=True),
        library_device_ms=time_ms(lambda i: F.scaled_dot_product_attention(
            q4, views[i][0], views[i][1], attn_mask=mask, enable_gqa=True),
            n_layers, spin=True),
        grid=decode_grid(decode_mod, lengths, MAX_LEN, 1),
        bytes=nbytes, ops=decode_ops,
        shape=f"b={B} h={H} kvh={KVH} d={D} max_len={MAX_LEN} contexts "
              f"{lengths[0]}..{lengths[-1]} (sum {kv_rows})")
    del views, caches

    # SSD scan: one batch-1 prompt of SSD_L rows through a layer, from a
    # zero state (the engine's prefill). 12 input sets (56 MB at l 1024)
    # so that L2 does not hold one set across launches.
    sets = {l: [ssd_inputs(gen, dev, dtype, 1, l)[:4] for _ in range(12)]
            for l in SSD_DEVICE_LENGTHS}
    x, a, b, c = sets[SSD_L][0]
    y, st = ops.ssd_scan(x, a, b, c)
    wy, ws = ref.ssd_scan(x, a, b, c, chunk=SSD_CHUNK)
    (ok_y, err_y), (ok_s, err_s) = (ref.compare(y, wy, normwise=True),
                                    ref.compare(st, ws, normwise=True))
    nbytes, ops_n = ssd_work(SSD_L, esize)
    device = {}
    for l, ls in sets.items():
        ms = time_ms(lambda i: ops.ssd_scan(*ls[i]), len(ls), spin=True)
        device[l] = (ms, *ssd_work(l, esize))
    out["ssd_scan"] = dict(
        max_abs_err=max(err_y, err_s), ok=ok_y and ok_s,
        ms=time_ms(lambda i: ops.ssd_scan(*sets[SSD_L][i]), 12),
        plain_ms=time_ms(lambda i: ref.ssd_scan(*sets[SSD_L][i],
                                                chunk=SSD_CHUNK),
                         12, iters=10),
        library_ms=None, ssd_device=device,
        bytes=nbytes, ops=ops_n,
        shape=f"bt=1 l={SSD_L} h={SSD_H} p={SSD_P} n={SSD_N} "
              f"chunk={SSD_CHUNK}; no single PyTorch call computes an SSD "
              f"scan, so no library yardstick")
    del sets

    for name, r in out.items():
        r["bound_ms"], r["bound_by"] = bound(r["bytes"], r["ops"], dtype)
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        log(f"  {name} [{r['shape']}, bf16]: kernel {r['ms']:.4f} ms "
            f"({tflops(r['ops'], r['ms']):.2f} TFLOP/s), plain "
            f"{r['plain_ms']:.4f} ms, library {lib}, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}: "
            f"{r['bytes'] / 1e6:.2f} MB, {r['ops'] / 1e9:.3f} GFLOP), "
            f"max_abs_err {r['max_abs_err']:.3e} {'ok' if r['ok'] else 'FAIL'}")
        for l, (ms, nb, n_ops) in r.get("ssd_device", {}).items():
            b_ms, b_by = bound(nb, n_ops, dtype)
            log(f"    {name} device time (launches queued behind a spin) "
                f"at bt=1 l={l}: {ms:.4f} ms, {tflops(n_ops, ms):.2f} "
                f"TFLOP/s, {100 * b_ms / ms:.1f} % of its bound {b_ms:.4f} "
                f"ms ({b_by}); grid {ssd_grid(1, l)}")
        if "grid" in r:
            rate = lambda ms: (f"{r['bytes'] / ms / 1e6:.1f} GB/s, "  # noqa: E731
                               f"{100 * r['bound_ms'] / ms:.1f} % of its bound")
            log(f"    {name}: {r['grid']}; {rate(r['ms'])}, "
                f"{r['ms'] / r['library_ms']:.2f}x SDPA; device time "
                f"(launches queued behind a spin): kernel "
                f"{r['device_ms']:.4f} ms ({rate(r['device_ms'])}), SDPA "
                f"{r['library_device_ms']:.4f} ms, "
                f"{r['device_ms'] / r['library_device_ms']:.2f}x")
    out["verify"] = verify
    return out


def time_family_shapes(dev, ops, ref, decode_mod) -> dict:
    """The attention kernels at phi3-mini's shape (32 heads, MHA, head_dim
    96: a paged decode of B slots over contexts of 512..2048 rows, one
    256-row chunk at start 1024) and the SSD scan at jamba's (128 heads of
    64, d_state 16, bt 1, l SSD_L), bf16: kernel (host-paced), device
    time, plain version, SDPA (none for the scan) and the bound. Logged,
    and returned for ``PERF.md``; the ``kernels`` line keeps the main
    path's shapes."""
    dtype, esize, n_layers = torch.bfloat16, 2, 4
    gen = torch.Generator(device=dev).manual_seed(21)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev).to(dtype)  # noqa: E731
    h, kvh, d = PHI3_H, PHI3_KVH, PHI3_D
    max_pages = MAX_LEN // PS
    pools = [(rnd(N_PAGES, PS, kvh, d), rnd(N_PAGES, PS, kvh, d))
             for _ in range(n_layers)]
    out = {}
    lengths = [int(x) for x in np.linspace(512, 2048, B)]
    table = _tables(gen, dev, lengths, max_pages)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    q = rnd(B, h, d)
    ok, err = ref.compare(ops.flash_decode_paged(q, *pools[0], table, lens),
                          ref.flash_decode_paged(q, *pools[0], table, lens))
    kv_rows = sum(lengths)
    nbytes = (2 * q.numel() * esize + 2 * kv_rows * kvh * d * esize
              + 4 * (sum(-(-n // PS) for n in lengths) + B))
    views = [tuple(t.permute(0, 2, 1, 3).contiguous()
                   for t in ref.gather_kv(kp, vp, table)) for kp, vp in pools]
    mask = (torch.arange(MAX_LEN, device=dev)[None, :]
            < lens[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    sdpa = lambda i: F.scaled_dot_product_attention(  # noqa: E731
        q4, views[i][0], views[i][1], attn_mask=mask)
    run = lambda i: ops.flash_decode_paged(q, *pools[i], table, lens)  # noqa: E731
    out["flash_decode_paged"] = dict(
        max_abs_err=err, ok=ok, ms=time_ms(run, n_layers),
        device_ms=time_ms(run, n_layers, spin=True),
        plain_ms=time_ms(lambda i: ref.flash_decode_paged(
            q, *pools[i], table, lens), n_layers, iters=10),
        library_ms=time_ms(sdpa, n_layers),
        library_device_ms=time_ms(sdpa, n_layers, spin=True),
        bytes=nbytes, ops=4 * kv_rows * h * d,
        shape=f"b={B} h={h} kvh={kvh} d={d} page={PS} contexts "
              f"{lengths[0]}..{lengths[-1]} (sum {kv_rows}); grid "
              f"{decode_grid(decode_mod, lengths, MAX_LEN, PS, h, kvh, d)}")
    del views
    start = 1024
    n_keys = start + CHUNK
    table = _tables(gen, dev, [n_keys], max_pages)
    st = torch.tensor([start], dtype=torch.int32, device=dev)
    qc = rnd(1, CHUNK, h, d)
    ok, err = ref.compare(
        ops.flash_attention_paged(qc, *pools[0], table, st),
        ref.flash_attention_paged(qc, *pools[0], table, st))
    views = [tuple(t[:, :n_keys].permute(0, 2, 1, 3).contiguous()
                   for t in ref.gather_kv(kp, vp, table)) for kp, vp in pools]
    cmask = (torch.arange(n_keys, device=dev)[None, :]
             <= start + torch.arange(CHUNK, device=dev)[:, None])
    qt = qc.permute(0, 2, 1, 3).contiguous()
    sdpa = lambda i: F.scaled_dot_product_attention(  # noqa: E731
        qt, views[i][0], views[i][1], attn_mask=cmask)
    run = lambda i: ops.flash_attention_paged(qc, *pools[i], table, st)  # noqa: E731
    out["flash_attention_paged"] = dict(
        max_abs_err=err, ok=ok, ms=time_ms(run, n_layers),
        device_ms=time_ms(run, n_layers, spin=True),
        plain_ms=time_ms(lambda i: ref.flash_attention_paged(
            qc, *pools[i], table, st), n_layers, iters=10),
        library_ms=time_ms(sdpa, n_layers),
        library_device_ms=time_ms(sdpa, n_layers, spin=True),
        bytes=(2 * qc.numel() * esize + 2 * n_keys * kvh * d * esize
               + 4 * (-(-n_keys // PS) + 1)),
        ops=4 * sum(start + r + 1 for r in range(CHUNK)) * h * d,
        shape=f"b=1 sq={CHUNK} start={start} h={h} kvh={kvh} d={d} "
              f"page={PS}")
    del views, pools
    shape = SSD_SHAPES[1]
    sets = [ssd_inputs(gen, dev, dtype, 1, SSD_L, shape=shape)[:4]
            for _ in range(12)]
    y, st = ops.ssd_scan(*sets[0])
    wy, ws = ref.ssd_scan(*sets[0], chunk=SSD_CHUNK)
    (ok_y, err_y), (ok_s, err_s) = (ref.compare(y, wy, normwise=True),
                                    ref.compare(st, ws, normwise=True))
    nbytes, ops_n = ssd_work(SSD_L, esize, shape)
    run = lambda i: ops.ssd_scan(*sets[i])  # noqa: E731
    out["ssd_scan"] = dict(
        max_abs_err=max(err_y, err_s), ok=ok_y and ok_s,
        ms=time_ms(run, len(sets)), device_ms=time_ms(run, len(sets),
                                                      spin=True),
        plain_ms=time_ms(lambda i: ref.ssd_scan(*sets[i], chunk=SSD_CHUNK),
                         len(sets), iters=10),
        library_ms=None, library_device_ms=None, bytes=nbytes, ops=ops_n,
        shape=f"bt=1 l={SSD_L} (h, p, n)={shape} chunk={SSD_CHUNK}; grid "
              f"{ssd_grid(1, SSD_L, shape)}")
    del sets
    for name, r in out.items():
        r["bound_ms"], r["bound_by"] = bound(r["bytes"], r["ops"], dtype)
        lib = ("none (no PyTorch call computes it)"
               if r["library_ms"] is None else
               f"{r['library_ms']:.4f} ms, device time "
               f"{r['library_device_ms']:.4f} ms")
        log(f"  {name} [{r['shape']}, bf16]: kernel {r['ms']:.4f} ms at the "
            f"host's pace, device time {r['device_ms']:.4f} ms "
            f"({tflops(r['ops'], r['device_ms']):.2f} TFLOP/s, "
            f"{100 * r['bound_ms'] / r['device_ms']:.1f} % of its bound), "
            f"plain {r['plain_ms']:.4f} ms, SDPA {lib}, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}: "
            f"{r['bytes'] / 1e6:.2f} MB, {r['ops'] / 1e9:.3f} GFLOP), "
            f"max_abs_err {r['max_abs_err']:.3e} {'ok' if r['ok'] else 'FAIL'}")
    return out


def time_probe_kernels(dev, ops, ref, latency, autotune,
                       gemm_kernel) -> dict:
    """GEMM times with every tile of the dtype (the naive and the tuned
    among them) beside the plain version and ``torch.matmul`` (the library
    yardstick, in the input dtype), and the pointer chase's nanoseconds
    per dependent load over the footprints. The JSON rows: the GEMM at the
    first MLP shape in bf16 with the tuned tile; the chase at the largest
    footprint."""
    require_full_fp32()
    gen = torch.Generator(device=dev).manual_seed(6)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        tiles = gemm_kernel.TILES[dtype]
        for m, k, n in MLP_SHAPES + ((512, 512, 512), (1024, 4096, 1024)):
            x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
            y = torch.randn(k, n, generator=gen, device=dev).to(dtype)
            gain = autotune.tuning_gain(autotune.GemmProblem(
                m=m, k=k, n=n, in_bytes=x.element_size()))
            naive, tuned = gain["naive"]["config"], gain["tuned"]["config"]
            ok, err = ref.compare(ops.gemm(x, y, block=tuned), ref.gemm(x, y),
                                  normwise=True)
            ms = {t: time_ms(lambda i, t=t: ops.gemm(x, y, block=t), 1,
                             iters=10) for t in tiles}
            plain_ms = time_ms(lambda i: ref.gemm(x, y), 1, iters=10)
            lib_ms = time_ms(lambda i: torch.matmul(x, y), 1, iters=10)
            nbytes = (m * k + k * n + m * n) * x.element_size()
            n_ops = 2 * m * k * n
            b_ms, b_by = bound(nbytes, n_ops, dtype)
            log(f"  gemm {m}x{k}x{n} {str(dtype):14s} "
                f"({gemm_kernel.last_path}): "
                + ", ".join(f"tile {t} {v:.4f} ms ({tflops(n_ops, v):.1f} "
                            f"TFLOP/s)" for t, v in ms.items())
                + f"; naive {naive}, tuned {tuned} "
                f"(modelled speedup {gain['speedup']:.3f}x, measured "
                f"{ms[naive] / ms[tuned]:.3f}x), plain {plain_ms:.4f} ms, "
                f"torch.matmul {lib_ms:.4f} ms "
                f"({tflops(n_ops, lib_ms):.1f} TFLOP/s), bound {b_ms:.4f} "
                f"ms ({b_by}), max_abs_err {err:.3e} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"gemm {m}x{k}x{n} {dtype} disagrees "
                                   f"with its plain version: {err}")
            if (m, k, n) == MLP_SHAPES[0] and dtype == torch.bfloat16:
                out["gemm"] = dict(
                    max_abs_err=err, ok=ok, ms=ms[tuned], plain_ms=plain_ms,
                    library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
            del x, y

    ns = {}
    for fp in latency.FOOTPRINTS:
        ns[fp] = latency.chase_ns_per_step(fp, device=dev)
        log(f"  pchase {fp / 2**10:8.0f} KiB footprint, "
            f"{latency.LINE_BYTES}-byte lines: {ns[fp]:.2f} ns per "
            f"dependent load ({latency.STEPS} steps, one launch after a "
            f"warm-up walk of the whole cycle)")
    fp = latency.FOOTPRINTS[-1]
    chain = latency.line_chain(fp, device=dev)
    got = ops.pchase(chain, latency.STEPS)
    want = ref.pchase(chain, latency.STEPS)
    err = float((got - want).abs().max())
    # Bytes: each distinct entry the chase reads, and each position it
    # writes; the chase does no arithmetic worth a bound.
    nbytes = 4 * min(latency.STEPS, fp // latency.LINE_BYTES) \
        + 4 * latency.STEPS
    b_ms, b_by = bound(nbytes, 0, torch.float32)
    out["pchase"] = dict(
        max_abs_err=err, ok=err == 0, ms=ns[fp] * latency.STEPS / 1e6,
        plain_ms=time_ms(lambda i: ref.pchase(chain, latency.STEPS), 1,
                         iters=2),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, ns=ns)
    log(f"  pchase [{fp // 2**20} MiB footprint, {latency.STEPS} steps]: "
        f"kernel {out['pchase']['ms']:.4f} ms, plain (host loop, chain "
        f"copied to the host) {out['pchase']['plain_ms']:.4f} ms, library "
        f"none, bound {b_ms:.6f} ms ({b_by}; shown for completeness: the "
        f"chase is latency-bound by design), max_abs_err {err:g}")
    del chain
    return out


# Phase 4 times the timed chase at one scan of phase 20's L2 search: a
# line chain of 4 MiB at 128 bytes through ld.global.cg, offsets kept.
TIMED_FOOTPRINT, TIMED_STRIDE = 4 * 2**20, 128


def time_timed_chase(dev, ops, ref) -> dict:
    """The timed chase beside its plain version (the offsets; the host
    loop, the chain copied to the host), both at the host's pace: the
    wrapper reads the kernel's status after each launch."""
    n = TIMED_FOOTPRINT // TIMED_STRIDE
    chain = np.zeros(TIMED_FOOTPRINT // 8, np.int64)
    chain[::TIMED_STRIDE // 8] = np.roll(np.arange(n) * TIMED_STRIDE, -1)
    t = torch.from_numpy(chain).to(dev)
    got, _, _ = ops.pchase_timed(t, n, bypass_l1=True)
    err = float((got - ref.pchase_timed(t, n)).abs().max())
    ms = time_ms(lambda i: ops.pchase_timed(t, n, bypass_l1=True), 1,
                 iters=10)
    plain_ms = time_ms(lambda i: ref.pchase_timed(t, n), 1, iters=2)
    # Bytes: each slot read once; each step's offset (8) and cycles (4)
    # written, and the walk's total; no arithmetic worth a bound.
    b_ms, b_by = bound(8 * n + 12 * n + 8, 0, torch.float32)
    log(f"  pchase_timed [.cg, {TIMED_FOOTPRINT // 2**20} MiB at "
        f"{TIMED_STRIDE} B, {n} steps]: kernel {ms:.4f} ms ({ms * 1e6 / n:.1f} "
        f"ns a step), plain {plain_ms:.4f} ms, library none, bound "
        f"{b_ms:.6f} ms ({b_by}; latency-bound by design), max_abs_err "
        f"{err:g}")
    return {"pchase_timed": dict(max_abs_err=err, ok=err == 0, ms=ms,
                                 plain_ms=plain_ms, library_ms=None,
                                 bound_ms=b_ms, bound_by=b_by)}


def check_flash_kernel(dev, ops, ref) -> list:
    """The full-sequence kernel against its plain version over dtypes,
    masks, lengths, head dims and GQA groups; returns failures."""
    gen = torch.Generator(device=dev).manual_seed(12)
    failures = []
    for dtype in (torch.float32, torch.bfloat16):
        rnd = lambda *s: torch.randn(*s, generator=gen, device=dev).to(dtype)  # noqa: E731
        tol = ref.TOLERANCE[dtype]
        for causal in (True, False):
            for d in HEAD_DIMS:
                worst = 0.0
                for group in (1, 4, 7):
                    for sq, skv in FLASH_LENGTHS:
                        q = rnd(2, sq, 2 * group, d)
                        k, v = rnd(2, skv, 2, d), rnd(2, skv, 2, d)
                        got = ops.flash_attention(q, k, v, causal=causal)
                        torch.cuda.synchronize()
                        ok, err = ref.compare(got, ref.flash_attention(
                            q, k, v, causal=causal))
                        worst = max(worst, err)
                        if not ok:
                            failures.append(("flash_attention", dtype, causal,
                                             d, group, sq, skv, err))
                log(f"  flash_attention {str(dtype):14s} causal={int(causal)} "
                    f"d={d:3d}: groups 1/4/7 x (sq, skv) {FLASH_LENGTHS}: "
                    f"max_abs_err {worst:.3e} (atol {tol[0]:g} + rtol "
                    f"{tol[1]:g})")
    return failures


def time_flash_kernel(dev, ops, ref) -> dict:
    """The kernel at the cache-less forward's shape (qwen3-4b, 2 x 2048
    tokens, causal, bf16) beside its plain version, SDPA and the bound."""
    from repro_torch.kernels import cost

    dtype = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(13)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev).to(dtype)  # noqa: E731
    n_sets = 4                          # 4 x 52 MB > 50 MB of L2
    sets = [(rnd(FLASH_B, FLASH_S, H, D), rnd(FLASH_B, FLASH_S, KVH, D),
             rnd(FLASH_B, FLASH_S, KVH, D)) for _ in range(n_sets)]
    q, k, v = sets[0]
    ok, err = ref.compare(ops.flash_attention(q, k, v),
                          ref.flash_attention(q, k, v))
    # SDPA reads (b, heads, s, d); the transposed copies are not timed.
    views = [tuple(t.transpose(1, 2).contiguous() for t in s) for s in sets]
    nbytes, flash_ops = cost.flash_attention(FLASH_B, FLASH_S, FLASH_S, H,
                                             KVH, D, 2, True)
    r = dict(
        max_abs_err=err, ok=ok,
        ms=time_ms(lambda i: ops.flash_attention(*sets[i]), n_sets),
        plain_ms=time_ms(lambda i: ref.flash_attention(*sets[i]), n_sets,
                         iters=4),
        library_ms=time_ms(lambda i: F.scaled_dot_product_attention(
            *views[i], is_causal=True, enable_gqa=True), n_sets),
        bytes=nbytes, ops=flash_ops)
    r["bound_ms"], r["bound_by"] = bound(r["bytes"], r["ops"], dtype)
    log(f"  flash_attention [b={FLASH_B} sq=skv={FLASH_S} h={H} kvh={KVH} "
        f"d={D} causal, bf16]: kernel {r['ms']:.4f} ms "
        f"({tflops(r['ops'], r['ms']):.1f} TFLOP/s), plain "
        f"{r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms "
        f"({tflops(r['ops'], r['library_ms']):.1f} TFLOP/s), bound "
        f"{r['bound_ms']:.4f} ms ({r['bound_by']}: {r['bytes'] / 1e6:.2f} MB,"
        f" {r['ops'] / 1e9:.3f} GFLOP), max_abs_err {err:.3e} "
        f"{'ok' if ok else 'FAIL'}")
    return r


def flash_paths(ops) -> dict:
    """Phases 13-14's comparison paths through ``kernel_ops``: the kernel
    with its causal offset off by one (each query sees one key past its
    position: k and v given one extra row at the end)."""
    def shifted(q, k, v, causal=True):
        pad = (0, 0, 0, 0, 0, 1)
        return ops.flash_attention(q, F.pad(k, pad), F.pad(v, pad),
                                   causal=causal)

    return {"flash fault": dict(flash_attention=shifted)}


def cacheless_logits(params, cfg, T, tokens, ops):
    """fp32 logits of the cache-less forward through the kernel
    ("kernel"), the plain ``sdpa`` ("plain") and the planted fault, each a
    one-element tuple (the layout ``check_logits`` reads)."""
    flash = dataclasses.replace(cfg, use_flash=True)

    def run(c):
        with torch.no_grad():
            return (T.forward(params, c, tokens)[0].float(),)

    out = {"kernel": run(flash), "plain": run(cfg)}
    for name, override in flash_paths(ops).items():
        with kernel_ops(ops, **override):
            out[name] = run(flash)
    return out


def check_cacheless(params, cfg, T, steps, batch, ops, label) -> list:
    """Phase 13's and 14's check of the cache-less forward through the
    kernel against the plain path (fp32 and bf16, as ``check_logits``),
    with the NLL of each; returns failures."""
    f32cfg = dataclasses.replace(cfg, compute_dtype="float32")
    f32 = cacheless_logits(params, f32cfg, T, batch["tokens"], ops)
    b16 = cacheless_logits(params, cfg, T, batch["tokens"], ops)
    shape = tuple(batch["tokens"].shape)
    failed = check_logits(f32, b16, [(0, f"{shape[0]} x {shape[1]}-token "
                                         f"forward", "flash fault")], label)
    nll = {f"{p} {dt}": float(steps.cross_entropy(logits[p][0],
                                                  batch["labels"]))
           for dt, logits in (("bf16", b16), ("fp32", f32))
           for p in ("kernel", "plain")}
    log(f"  {label} NLL: " + ", ".join(f"{k} {v:.6f}" for k, v in nll.items()))
    if not all(math.isfinite(v) for v in nll.values()):
        failed.append(f"{label}: NLL not finite: {nll}")
    return failed


# ----------------------------------------------------------------------------
# The engine at full width
# ----------------------------------------------------------------------------

def make_requests(vocab: int, n: int, lo: int = 64, hi: int = 1536):
    rng = np.random.RandomState(0)
    lens = rng.randint(lo, hi + 1, size=n)
    return [rng.randint(2, vocab, size=int(l)).astype(np.int32) for l in lens]


def serve(params, cfg, scfg, prompts, max_new, dev, ops, capture=True,
          stagger=False, during=contextlib.nullcontext):
    """Drive the engine over ``prompts``; launch counts cover this run only,
    the wall time the run only (not the engine's construction, where a
    graphed engine captures its steps). ``stagger``: request 0 alone
    until its prefill ends (its first token), then the rest. ``during()``:
    a context the run (not the construction) goes through."""
    from repro_torch.serve.engine import Request, ServingEngine

    eng = ServingEngine(params, cfg, scfg, device=dev, capture=capture)
    if eng.graphed != capture:
        raise RuntimeError(f"engine graphed={eng.graphed}, asked {capture}")
    reqs = [Request(rid=rid, prompt=p, max_new=max_new)
            for rid, p in enumerate(prompts)]
    for req in reqs[:1] if stagger else reqs:
        eng.submit(req)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    with during():
        if stagger:
            while not reqs[0].generated:
                eng.tick()
            for req in reqs[1:]:
                eng.submit(req)
        finished = eng.run_until_drained()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    return eng, finished, wall, launches


def check_served(eng, finished, prompts, max_new, vocab) -> None:
    if sorted(finished) != list(range(len(prompts))):
        raise RuntimeError(f"finished {sorted(finished)} of {len(prompts)}")
    for rid, toks in finished.items():
        if len(toks) != max_new or eng.outcome[rid] != "done":
            raise RuntimeError(f"request {rid}: {len(toks)} tokens, "
                               f"{eng.outcome[rid]}")
        if not all(0 <= t < vocab for t in toks):
            raise RuntimeError(f"request {rid}: token out of range")
    if eng.pool is None:
        return
    if eng.prefix is not None:
        # Only the index may hold pages after a run: clearing it frees
        # every one.
        cls = eng.pool.page_classes()
        if cls["pages_cached_idle"] != eng.pool.pages_in_use:
            raise RuntimeError(f"pages held past the index after the run: "
                               f"{cls}")
        log(f"  the index held {len(eng.prefix)} pages after the run; clear() "
            f"freed {eng.prefix.clear()}")
    if eng.pool.pages_in_use != 0:
        raise RuntimeError(f"{eng.pool.pages_in_use} pages leaked")


@contextlib.contextmanager
def kernel_ops(ops, **override):
    """The same model with some kernel wrappers replaced by ``override``
    (name -> function): the comparison paths of phases 7 and 10."""
    from repro_torch.models import layers, mamba

    ns = types.SimpleNamespace(**{n: override.get(n, getattr(ops, n))
                                  for n in KERNELS})
    saved = layers.kernel_ops, mamba.kernel_ops
    layers.kernel_ops = mamba.kernel_ops = ns
    try:
        yield
    finally:
        layers.kernel_ops, mamba.kernel_ops = saved


def paged_paths(ops, ref) -> dict:
    """Phase 7's paths: the plain versions, and the kernels with one
    planted fault each. The faults are ones a page walk or a mask can
    make: decode drops each slot's newest key (``lengths - 1``), prefill
    lets each query see one key past its own position (``starts + 1``,
    the causal mask off by one)."""
    return {
        "plain": dict(flash_decode_paged=ref.flash_decode_paged,
                      flash_attention_paged=ref.flash_attention_paged),
        "decode fault": dict(flash_decode_paged=lambda q, kp, vp, t, n:
                             ops.flash_decode_paged(q, kp, vp, t, n - 1)),
        "prefill fault": dict(flash_attention_paged=lambda q, kp, vp, t, s:
                              ops.flash_attention_paged(q, kp, vp, t, s + 1)),
    }


def ssd_no_carry(ops):
    """A planted fault: the SSD scan launched chunk by chunk, the state
    not carried across a chunk boundary (every chunk after the first
    starts from zero)."""
    def scan(x, a_log, b, c, h0=None, chunk=SSD_CHUNK):
        ys, state = [], None
        for t0 in range(0, x.shape[1], chunk):
            part = [t[:, t0:t0 + chunk].contiguous()
                    for t in (x, a_log, b, c)]
            y, state = ops.ssd_scan(*part, h0=h0 if t0 == 0 else None,
                                    chunk=chunk)
            ys.append(y)
        return torch.cat(ys, dim=1), state
    return scan


def contiguous_paths(ops, ref) -> dict:
    """Phase 10's paths: the plain versions, and the kernels with planted
    faults: the contiguous decode given ``lengths - 1`` (each slot's
    newest key dropped); the SSD scan run chunk by chunk with the state not
    carried across a chunk boundary (it shows in the prefill's rows; the
    decays forget the carried state within the last chunk's rows, so the
    decode step barely moves); and the SSD scan returning a zero final
    state (it shows in the decode step, which starts from that state).
    "reorder" is the plain path with the scan's sums in another order
    (chunks of 64): the plain path's own fp32 noise."""
    def ssd_no_state(*args, **kwargs):
        y, state = ops.ssd_scan(*args, **kwargs)
        return y, torch.zeros_like(state)

    return {
        "plain": dict(flash_decode=ref.flash_decode, ssd_scan=ref.ssd_scan),
        "decode fault": dict(flash_decode=lambda q, k, v, n:
                             ops.flash_decode(q, k, v, n - 1)),
        "ssd fault": dict(ssd_scan=ssd_no_carry(ops)),
        "ssd state fault": dict(ssd_scan=ssd_no_state),
        "reorder": dict(ssd_scan=lambda *a, chunk=None, **k:
                        ref.ssd_scan(*a, chunk=64, **k)),
    }


def compare_paths(logits_fn, paths, ops) -> dict:
    """``logits_fn()`` through the kernels and through each path."""
    out = {"kernel": logits_fn()}
    for name, override in paths.items():
        with kernel_ops(ops, **override):
            out[name] = logits_fn()
    return out


def max_diff(a, b) -> float:
    return float((a - b).abs().max())


def check_logits(f32, b16, parts, label, rows=None) -> list:
    """Kernel path against plain path on the same weights; returns
    failures. ``parts``: (index into the logits pair, what it is, the
    planted fault that must show there).

    fp32: the kernels and their plain versions differ only in the order
    of their sums, so a limit far below what a planted fault moves
    (FP32_LOGIT_TOL) separates right from wrong. bf16: the limit is twice
    the plain path's own bf16 error (plain bf16 against plain fp32, same
    weights): kernel and plain path each sit within about that of the
    fp32 logits. ``rows``: part -> a mask of the rows whose router made
    the same choices in the kernel and plain bf16 paths and the plain
    fp32 path (``routed_alike``); the bf16 rule then reads those rows
    only. In bf16 a near-tie of the router flips a choice now and then,
    which moves that row's MoE output (and, through a Mamba layer's state
    or a later attention layer, the rows after it) as a fault would; the
    fp32 comparison, where the paths choose alike, holds every row. At
    least half of a part of several rows must be read."""
    failed = []
    for part, what, fault_name in parts:
        sound = max_diff(f32["kernel"][part], f32["plain"][part])
        fault = max_diff(f32["kernel"][part], f32[fault_name][part])
        scale = float(f32["plain"][part].abs().max())
        log(f"  {label} fp32 {what}: max |logit diff| kernel vs plain "
            f"{sound:.3e}, planted {fault_name} {fault:.3e} (limit "
            f"{FP32_LOGIT_TOL:g}; max |logit| {scale:.3f})")
        if not (math.isfinite(sound) and sound <= FP32_LOGIT_TOL):
            failed.append(f"{label} fp32 {what}: kernel and plain logits "
                          f"differ")
        if not fault > FP32_LOGIT_TOL:
            failed.append(f"{label} fp32 {what}: the planted fault went "
                          f"unseen")
        keep = None if rows is None else rows[part]
        pick = (lambda t: t) if keep is None else (  # noqa: E731
            lambda t: t[keep] if t.dim() > 1 else t[None][keep.reshape(1)])
        fault = max_diff(b16["kernel"][part], b16[fault_name][part])
        agree = float((b16["kernel"][part].argmax(-1)
                       == b16["plain"][part].argmax(-1)).float().mean())
        if keep is not None:
            n_all, n_kept = keep.numel(), int(keep.sum())
            log(f"  {label} bf16 {what}: {n_all - n_kept} of {n_all} rows "
                f"left out, a router choice differing between the paths "
                f"(all-row kernel vs plain "
                f"{max_diff(b16['kernel'][part], b16['plain'][part]):.4f})")
            if n_all > 1 and 2 * n_kept < n_all:
                failed.append(f"{label} bf16 {what}: the router's choices "
                              f"differ on {n_all - n_kept} of {n_all} rows")
            if not n_kept:
                continue
        sound = max_diff(pick(b16["kernel"][part]), pick(b16["plain"][part]))
        noise = max_diff(pick(b16["plain"][part]), pick(f32["plain"][part]))
        log(f"  {label} bf16 {what}: max |logit diff| kernel vs plain "
            f"{sound:.4f}, plain bf16 vs fp32 {noise:.4f} (limit "
            f"{2 * noise:.4f}), planted fault {fault:.4f}, argmax agreement "
            f"{agree:.3f}")
        if not (math.isfinite(sound) and sound <= 2 * noise):
            failed.append(f"{label} bf16 {what}: kernel and plain logits "
                          f"differ")
    return failed


def paged_logits(params, cfg, T, dev, prompt):
    """Logits of the last prefill chunk (valid rows) and of one decode
    step, for one slot served through a fresh paged cache: all of the
    prompt but its last token is prefilled, the last token decoded, so
    every path decodes the same token."""
    n_pages = 1 + MAX_LEN // PS
    caches = T.init_paged_caches(cfg, 1, MAX_LEN, PS, n_pages, device=dev)
    table = (torch.randperm(n_pages - 1, generator=torch.Generator()
                            .manual_seed(2)) + 1).int()[None].to(dev)
    caches = [dict(c, pages=table) for c in caches]
    n = len(prompt) - 1
    out = None
    with torch.no_grad():
        for s0 in range(0, n, CHUNK):
            toks = np.zeros((1, CHUNK), np.int64)
            toks[0, :min(CHUNK, n - s0)] = prompt[s0:min(s0 + CHUNK, n)]
            idx = torch.tensor([s0], dtype=torch.int32, device=dev)
            logits, _ = T.forward(params, cfg, torch.from_numpy(toks).to(dev),
                                  caches=[dict(c, index=idx) for c in caches])
            out = logits[0, :n - s0].float()
        idx = torch.tensor([n], dtype=torch.int32, device=dev)
        step, _ = T.forward(params, cfg,
                            torch.tensor([[int(prompt[n])]], device=dev),
                            caches=[dict(c, index=idx) for c in caches])
    return out, step[0, 0].float()


def contiguous_logits(params, cfg, T, dev, prompt):
    """Logits of a prefill of all of the prompt but its last token, and
    of the decode step of that token, for one slot of a fresh contiguous
    cache (the engine's row cache)."""
    caches = T.init_caches(cfg, 1, MAX_LEN, per_slot_index=True, device=dev)
    toks = torch.from_numpy(prompt.astype(np.int64)).to(dev)[None]
    with torch.no_grad():
        pre, caches = T.forward(params, cfg, toks[:, :-1], caches=caches)
        step, _ = T.forward(params, cfg, toks[:, -1:], caches=caches)
    return pre[0].float(), step[0, 0].float()


def spec_line(eng) -> str:
    return (f"spec_k {eng.spec_k}: {eng.verify_steps} verify steps, "
            f"verify_traces {eng.verify_traces}, {eng.spec_ticks} slot "
            f"verifies, {eng.spec_proposed} drafts proposed, "
            f"{eng.spec_accepted} accepted (accept rate "
            f"{eng.spec_accepted / max(1, eng.spec_proposed):.3f}), "
            f"{eng.spec_emitted} tokens emitted "
            f"({eng.spec_emitted / max(1, eng.spec_ticks):.3f} a slot "
            f"verify)")


def prefix_line(eng) -> str:
    return (f"prefix cache: {eng.prefix_hits} hits, {eng.prefix_misses} "
            f"misses, {eng.prefix_hit_pages} pages mapped, "
            f"{eng.cow_copies} copy-on-write, {eng.prefix_evictions} "
            f"evictions ({eng.prefix.evicted_pages} pages)")


def run_engine(label, params, cfg, scfg, prompts, dev, ops, capture=True,
               stagger=False, max_new=MAX_NEW,
               during=contextlib.nullcontext):
    """Serve ``prompts`` at ``max_new`` tokens each and report; returns the
    engine, the launch counts, the streams and the tok/s of this run."""
    torch.cuda.reset_peak_memory_stats()
    eng, finished, wall, launches = serve(params, cfg, scfg, prompts,
                                          max_new, dev, ops, capture,
                                          stagger, during)
    check_served(eng, finished, prompts, max_new, cfg.vocab)
    toks = sum(len(v) for v in finished.values())
    pools = ", ".join(f"{k} {v / 2**20:.1f}"
                      for k, v in eng.graph_pools.items())
    mode = (f"graphed (captured in {eng.capture_seconds:.3f} s, graph "
            f"pools {eng.graph_bytes / 2**20:.1f} MiB: {pools})"
            if eng.graphed else "eager")
    log(f"  {label}, {mode}: served {len(finished)} requests, {toks} tokens "
        f"in {wall:.2f} s ({toks / wall:.1f} tok/s), {eng.ticks} ticks, "
        f"{eng.chunk_steps} chunk steps, {eng.decode_steps} decode steps, "
        f"prefill buckets {dict(sorted(eng.prefill_buckets.items()))}, "
        f"{eng.preemptions} preemptions, {eng.admission_rejections} holds, "
        f"decode_traces {eng.decode_traces}, prefill_traces "
        f"{dict(sorted(eng.prefill_traces.items()))}, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if eng.spec_k:
        log(f"  {label}: {spec_line(eng)}")
    if eng.prefix is not None:
        log(f"  {label}: {prefix_line(eng)}")
    if eng.graphed:
        log(f"  the port's kernels a replay, read from the captured graphs: "
            f"{eng.graph_nodes}")
    used = {k: v for k, v in launches.items() if v}
    log(f"  launches: {launches} (per tick: "
        + ", ".join(f"{k} {v / eng.ticks:.2f}" for k, v in used.items())
        + ")")
    return eng, launches, finished, toks / wall


def schedule(eng, launches) -> tuple:
    """What a run decided, which must not depend on graphs: ticks, steps,
    buckets, preemptions, holds, trace counts, launches by kernel, the
    speculative counters and the prefix cache's."""
    return (eng.ticks, eng.chunk_steps, eng.decode_steps,
            dict(eng.prefill_buckets), eng.preemptions,
            eng.admission_rejections, eng.decode_traces,
            dict(eng.prefill_traces), dict(launches), eng.verify_steps,
            eng.verify_traces, eng.spec_ticks, eng.spec_proposed,
            eng.spec_accepted, eng.spec_emitted, eng.prefix_hits,
            eng.prefix_misses, eng.prefix_hit_pages, eng.cow_copies,
            eng.prefix_evictions)


def first_difference(a, b):
    """(rid, emitted index) of the first token two runs disagree on."""
    for rid in sorted(a):
        for t, (x, y) in enumerate(zip(a[rid], b[rid])):
            if x != y:
                return rid, t
    return None


def graph_kernels(cfg, scfg) -> dict:
    """The port's kernels each of the engine's graphs must hold a replay:
    one decode an attention layer, one paged prefill an attention layer
    (the chunk step, and the verify step in place of the decode step).
    A Mamba layer's decode step is plain PyTorch (the recurrence)."""
    if all(k != "attn" for k in cfg.pattern):
        return {"decode": {}}
    n = sum(cfg.kind(i) == "attn" for i in range(cfg.n_layers))
    if not scfg.paged:
        return {"decode": {"flash_decode": n}}
    if scfg.spec_k:
        return {"verify": {"flash_attention_paged": n},
                "chunk": {"flash_attention_paged": n}}
    return {"decode": {"flash_decode_paged": n},
            "chunk": {"flash_attention_paged": n}}


def run_eager_and_graphed(label, params, cfg, scfg, prompts, dev, ops,
                          stagger=False, max_new=MAX_NEW,
                          eager_during=contextlib.nullcontext):
    """The engine run eagerly, then graphed, in the same call (both warmed
    up at construction): the same schedule, launches and streams, and
    graphs that hold the kernels the path needs, or a RuntimeError naming
    what differs. ``eager_during()``: a context the eager run goes
    through. Returns the graphed engine, its launches, streams and
    tok/s."""
    eager, e_launches, e_fin, _ = run_engine(label, params, cfg, scfg,
                                             prompts, dev, ops, capture=False,
                                             stagger=stagger, max_new=max_new,
                                             during=eager_during)
    e_sched = schedule(eager, e_launches)
    del eager
    torch.cuda.empty_cache()
    eng, launches, fin, tok_s = run_engine(label, params, cfg, scfg,
                                           prompts, dev, ops, capture=True,
                                           stagger=stagger, max_new=max_new)
    if eng.graph_nodes != graph_kernels(cfg, scfg):
        raise RuntimeError(f"{label}: the graphs hold {eng.graph_nodes}, "
                           f"not {graph_kernels(cfg, scfg)}")
    if schedule(eng, launches) != e_sched:
        raise RuntimeError(f"{label}: graphed schedule "
                           f"{schedule(eng, launches)} != eager {e_sched}")
    if fin != e_fin:
        raise RuntimeError(f"{label}: graphed and eager streams part at "
                           f"(rid, index) {first_difference(fin, e_fin)}")
    log(f"  {label}: graphed = eager in schedule, launches and streams")
    return eng, launches, fin, tok_s


# Phase 15: the (rid, emitted index) grid whose keys and uniform bits the
# card must compute as the CPU does: a negative rid, int32's ends.
KEY_RIDS = (0, 1, 11, -1, -2**31, 2**31 - 1)
KEY_TS = (0, 1, 31, 2**16, 2**31 - 1)


def check_keys_on_card(dev, sampling, vocab) -> None:
    """Keys folded from the (rid, t) grid, and their random bits and
    uniforms over the vocabulary, on the card and on the CPU: bit-equal."""
    rids, ts = (v.flatten() for v in torch.meshgrid(
        torch.tensor(KEY_RIDS), torch.tensor(KEY_TS), indexing="ij"))
    base = sampling.prng_key(0)
    cpu = sampling.fold_row_keys(base, rids, ts)
    card = sampling.fold_row_keys(base.to(dev), rids.to(dev), ts.to(dev))
    same = {"keys": torch.equal(card.cpu(), cpu),
            "bits": torch.equal(sampling.random_bits(card, (vocab,)).cpu(),
                                sampling.random_bits(cpu, (vocab,))),
            "uniform": torch.equal(sampling.uniform(card, (vocab,)).cpu(),
                                   sampling.uniform(cpu, (vocab,)))}
    log(f"  keys and bits of {len(rids)} (rid, t) pairs (rids {KEY_RIDS}, "
        f"t {KEY_TS}) over {vocab} entries, card against CPU: {same}")
    if not all(same.values()):
        raise RuntimeError(f"the card's keys or bits differ: {same}")


def run_sampled(params, cfg, scfg, prompts, greedy, dev, ops) -> float:
    """Phase 15: the paged engine sampled, eager then graphed (identical
    streams), then graphed on the squeezed pool (every request done, no
    page leaked); logs, for each emitted index, how many requests drew the
    greedy run's token. Returns the graphed run's tok/s."""
    eng, _, fin, tok_s = run_eager_and_graphed("paged sampled", params, cfg,
                                               scfg, prompts, dev, ops)
    agree = [sum(int(fin[r][t] == greedy[r][t]) for r in fin)
             for t in range(MAX_NEW)]
    log(f"  sampled tokens equal to the greedy run's, by emitted index "
        f"(of {len(fin)}): {agree}")
    del eng
    torch.cuda.empty_cache()
    squeezed = dataclasses.replace(scfg, n_pages=161)
    eng, s_fin, wall, _ = serve(params, cfg, squeezed, prompts, MAX_NEW,
                                dev, ops)
    check_served(eng, s_fin, prompts, MAX_NEW, cfg.vocab)
    if eng.preemptions < 1:
        raise RuntimeError("squeezed sampled pool ran without a preemption")
    same = sum(int(a == b) for r in fin for a, b in zip(fin[r], s_fin[r]))
    log(f"  squeezed, graphed: {len(s_fin)} requests done in {wall:.2f} s, "
        f"{eng.ticks} ticks, {eng.preemptions} preemptions, "
        f"{eng.admission_rejections} holds, no page leaked; "
        f"{same}/{len(fin) * MAX_NEW} tokens as in the roomy pool")
    return tok_s


# ----------------------------------------------------------------------------
# Phases 16-17: speculative decoding and prefix caching
# ----------------------------------------------------------------------------

# Phase 16's fp32 gate: the verify's B slots start here (a page boundary
# crossed at 300 + 5, the last rows at MAX_LEN - 1).
VERIFY_LOGIT_STARTS = [37, 300, 512, 777, 1024, 1300, 1800, MAX_LEN - 5]


def check_spec_launches(label, eng, launches, n_layers) -> None:
    """A speculative run launches the paged prefill kernel once a layer a
    chunk step and a verify step, and never the paged decode."""
    want = n_layers * (eng.chunk_steps + eng.verify_steps)
    if not (eng.verify_steps > 0 and launches["flash_decode_paged"] == 0
            and launches["flash_attention_paged"] == want):
        raise RuntimeError(f"{label}: launches {launches}, want "
                           f"flash_attention_paged {want} ({eng.chunk_steps} "
                           f"chunk + {eng.verify_steps} verify steps) and no "
                           f"decode")


def verify_paths(params, cfg, T, dev):
    """One verify step of B slots (width SPEC_K + 1) from
    VERIFY_LOGIT_STARTS over contexts prefilled in chunks, and the SPEC_K
    + 1 plain decode steps over the same rows: two functions giving
    (B, width, vocab) fp32 logits."""
    w = SPEC_K + 1
    max_pages = MAX_LEN // PS
    n_pages = 1 + B * max_pages
    caches = T.init_paged_caches(cfg, B, MAX_LEN, PS, n_pages, device=dev)
    table = (torch.randperm(n_pages - 1, generator=torch.Generator()
                            .manual_seed(3)) + 1).int().reshape(B, max_pages)
    table = table.to(dev)
    caches = [dict(c, pages=table) for c in caches]
    ctx = np.random.RandomState(5).randint(2, cfg.vocab, size=(B, MAX_LEN))
    with torch.no_grad():
        for i, n in enumerate(VERIFY_LOGIT_STARTS):
            for s0 in range(0, n, CHUNK):
                toks = np.zeros((1, CHUNK), np.int64)
                m = min(CHUNK, n - s0)
                toks[0, :m] = ctx[i, s0:s0 + m]
                idx = torch.tensor([s0], dtype=torch.int32, device=dev)
                T.forward(params, cfg, torch.from_numpy(toks).to(dev),
                          caches=[dict(c, pages=table[i:i + 1], index=idx)
                                  for c in caches])
    toks = torch.from_numpy(ctx[:, -w:]).to(dev)
    st = torch.tensor(VERIFY_LOGIT_STARTS, dtype=torch.int32, device=dev)

    @torch.no_grad()
    def verify():
        logits, _ = T.forward(params, cfg, toks,
                              caches=[dict(c, index=st) for c in caches])
        return logits.float()

    @torch.no_grad()
    def decode():
        out = []
        for j in range(w):
            logits, _ = T.forward(params, cfg, toks[:, j:j + 1],
                                  caches=[dict(c, index=st + j)
                                          for c in caches])
            out.append(logits[:, 0].float())
        return torch.stack(out, dim=1)

    return verify, decode


def check_verify_logits(params, cfg, T, dev, ops) -> list:
    """Phase 16's gate: one verify step against SPEC_K + 1 plain decode
    steps over the same rows, fp32 within FP32_LOGIT_TOL, which the
    verify's attention given ``starts + 1`` (each query sees the next
    row) or ``starts - 1`` (each query loses its own row) must exceed;
    bf16 logged. Returns failures."""
    failed = []
    for label, c in (("fp32", dataclasses.replace(
            cfg, compute_dtype="float32")), ("bf16", cfg)):
        verify, decode = verify_paths(params, c, T, dev)
        want = decode()
        sound = max_diff(verify(), want)
        faults = {}
        for shift in (1, -1):
            fault = (lambda q, kp, vp, t, s, d=shift:
                     ops.flash_attention_paged(q, kp, vp, t, s + d))
            with kernel_ops(ops, flash_attention_paged=fault):
                faults[shift] = max_diff(verify(), want)
        agree = float((verify().argmax(-1) == want.argmax(-1)).float()
                      .mean())
        log(f"  verify {label} (b={B}, width {SPEC_K + 1}, starts "
            f"{VERIFY_LOGIT_STARTS}): max |logit diff| verify vs {SPEC_K + 1} "
            f"decode steps {sound:.3e}; planted starts + 1 {faults[1]:.3e}, "
            f"starts - 1 {faults[-1]:.3e} (limit {FP32_LOGIT_TOL:g}, fp32 "
            f"only); argmax agreement {agree:.3f}")
        if label == "fp32":
            if not (math.isfinite(sound) and sound <= FP32_LOGIT_TOL):
                failed.append("verify fp32: verify and decode logits differ")
            if not min(faults.values()) > FP32_LOGIT_TOL:
                failed.append("verify fp32: a planted fault went unseen")
        del verify, decode, want
        torch.cuda.empty_cache()
    return failed


def run_spec(params, cfg, scfg, prompts, greedy, plain_tok_s, dev,
             ops, T) -> dict:
    """Phase 16: speculative decoding (NgramDraft, SPEC_K) on the paged
    engine, eager then graphed; the squeezed pool; the fp32 verify gate;
    one ModelDraft("self") request, eager. Returns the readings."""
    spec = dataclasses.replace(scfg, spec_k=SPEC_K)
    eng, launches, fin, tok_s = run_eager_and_graphed(
        "paged spec", params, cfg, spec, prompts, dev, ops)
    check_spec_launches("paged spec", eng, launches, cfg.n_layers)
    same = sum(int(a == b) for r in fin for a, b in zip(fin[r], greedy[r]))
    out = {"tok_s": tok_s, "plain_tok_s": plain_tok_s,
           "verify_steps": eng.verify_steps,
           "verify_launches": cfg.n_layers * eng.verify_steps,
           "accept_rate": eng.spec_accepted / max(1, eng.spec_proposed)}
    log(f"  spec graphed {tok_s:.1f} tok/s against phase 5's plain graphed "
        f"{plain_tok_s:.1f} tok/s ({tok_s / plain_tok_s:.2f}x); accept rate "
        f"{out['accept_rate']:.3f}; the verify graph replayed "
        f"{eng.verify_steps} times ({out['verify_launches']} paged prefill "
        f"launches); {same}/{len(fin) * MAX_NEW} tokens as phase 5's "
        f"greedy streams (bf16, logged)")
    del eng
    torch.cuda.empty_cache()

    squeezed = dataclasses.replace(spec, n_pages=SQUEEZED_PAGES)
    eng, s_fin, wall, s_launches = serve(params, cfg, squeezed, prompts,
                                         MAX_NEW, dev, ops)
    check_served(eng, s_fin, prompts, MAX_NEW, cfg.vocab)
    check_spec_launches("squeezed spec", eng, s_launches, cfg.n_layers)
    if eng.preemptions < 1:
        raise RuntimeError("squeezed spec pool ran without a preemption")
    same = sum(int(a == b) for r in fin for a, b in zip(fin[r], s_fin[r]))
    log(f"  squeezed spec, graphed: {len(s_fin)} requests done in "
        f"{wall:.2f} s, {eng.ticks} ticks, {eng.preemptions} preemptions, "
        f"{eng.admission_rejections} holds, no page leaked; {spec_line(eng)};"
        f" {same}/{len(fin) * MAX_NEW} tokens as in the roomy pool")
    del eng
    torch.cuda.empty_cache()

    failed = check_verify_logits(params, cfg, T, dev, ops)
    if failed:
        raise RuntimeError("; ".join(failed))

    selfdraft = dataclasses.replace(spec, draft="self")
    eng, d_fin, wall, d_launches = serve(params, cfg, selfdraft, prompts[:1],
                                         8, dev, ops, capture=False)
    check_served(eng, d_fin, prompts[:1], 8, cfg.vocab)
    log(f"  ModelDraft('self'), eager: request 0 in {wall:.2f} s, stream "
        f"{d_fin[0]}; {spec_line(eng)}; launches {d_launches}")
    if not (eng.spec_emitted >= eng.spec_ticks > 0
            and eng.spec_accepted <= eng.spec_proposed
            and d_launches["flash_decode"] > 0):
        raise RuntimeError(f"ModelDraft('self'): {spec_line(eng)}; "
                           f"launches {d_launches}")
    del eng
    torch.cuda.empty_cache()
    return out


def prefix_prompts(vocab: int) -> list:
    """N_REQUESTS prompts: one PREFIX_LEN-token prefix and unique suffixes
    of SUFFIX_LO..SUFFIX_HI tokens."""
    rng = np.random.RandomState(7)
    prefix = rng.randint(2, vocab, PREFIX_LEN)
    lens = rng.randint(SUFFIX_LO, SUFFIX_HI + 1, N_REQUESTS)
    return [np.concatenate([prefix, rng.randint(2, vocab, n)])
            .astype(np.int32) for n in lens]


def prefix_paths(params, cfg, T, dev, a, b) -> tuple:
    """Prompt ``a`` prefilled in chunks through its own pages, then prompt
    ``b`` (the same first PREFIX_LEN tokens) three ways: uncached, through
    its own pages; cached, its table mapping ``a``'s prefix pages and its
    first chunk at PREFIX_LEN; and the planted fault, mapped one page off.
    Returns the fp32 logits of ``b``'s last row each way, and whether
    ``b``'s prefix rows and suffix rows are bit-equal cached and
    uncached."""
    max_pages = MAX_LEN // PS
    n_pages = 1 + 4 * max_pages
    caches = T.init_paged_caches(cfg, 1, MAX_LEN, PS, n_pages, device=dev)
    perm = (torch.randperm(n_pages - 1, generator=torch.Generator()
                           .manual_seed(4)) + 1).int().to(dev)
    names = ("a", "uncached", "cached", "fault")
    tables = {n: perm[j * max_pages:(j + 1) * max_pages][None].clone()
              for j, n in enumerate(names)}
    hit = PREFIX_LEN // PS
    tables["cached"][0, :hit] = tables["a"][0, :hit]
    tables["fault"][0, :hit] = tables["a"][0, 1:hit + 1]

    @torch.no_grad()
    def prefill(name, toks, start):
        last = None
        for s0 in range(start, len(toks), CHUNK):
            n = min(CHUNK, len(toks) - s0)
            chunk = np.zeros((1, CHUNK), np.int64)
            chunk[0, :n] = toks[s0:s0 + n]
            idx = torch.tensor([s0], dtype=torch.int32, device=dev)
            logits, _ = T.forward(params, cfg,
                                  torch.from_numpy(chunk).to(dev),
                                  caches=[dict(c, pages=tables[name],
                                               index=idx) for c in caches])
            last = logits[0, n - 1].float()
        return last

    prefill("a", a, 0)
    out = {"uncached": prefill("uncached", b, 0),
           "cached": prefill("cached", b, PREFIX_LEN),
           "fault": prefill("fault", b, PREFIX_LEN)}

    def rows(name, lo, hi):
        return [t[tables[name][0].long()].flatten(0, 1)[lo:hi]
                for c in caches for t in (c["kp"], c["vp"])]

    same = {part: all(torch.equal(x, y) for x, y in
                      zip(rows("cached", lo, hi), rows("uncached", lo, hi)))
            for part, (lo, hi) in (("prefix", (0, PREFIX_LEN)),
                                   ("suffix", (PREFIX_LEN, len(b))))}
    return out, same


def check_prefix_logits(params, cfg, T, dev, prompts) -> list:
    """Phase 17's gate: the first token's logits of a cached admission
    (its first chunk at PREFIX_LEN, through the pages of an earlier
    prompt) against the same prompt uncached, fp32 within FP32_LOGIT_TOL,
    which the hit mapped one page off must exceed; bf16 logged, with
    whether the K/V rows are bit-equal. Returns failures."""
    failed = []
    for label, c in (("fp32", dataclasses.replace(
            cfg, compute_dtype="float32")), ("bf16", cfg)):
        out, same = prefix_paths(params, c, T, dev, prompts[0], prompts[1])
        sound = max_diff(out["cached"], out["uncached"])
        fault = max_diff(out["fault"], out["uncached"])
        log(f"  cached admission {label} ({len(prompts[1])}-token prompt, "
            f"{PREFIX_LEN // PS} pages mapped): max |logit diff| cached vs "
            f"uncached {sound:.3e}, planted one-page-off map {fault:.3e} "
            f"(limit {FP32_LOGIT_TOL:g}, fp32 only); K/V rows bit-equal "
            f"cached and uncached: prefix {same['prefix']}, suffix "
            f"{same['suffix']}")
        if label == "fp32":
            if not (math.isfinite(sound) and sound <= FP32_LOGIT_TOL):
                failed.append("prefix fp32: cached and uncached logits "
                              "differ")
            if not fault > FP32_LOGIT_TOL:
                failed.append("prefix fp32: the planted fault went unseen")
        del out
        torch.cuda.empty_cache()
    return failed


def run_prefix(params, cfg, scfg, dev, ops, T) -> dict:
    """Phase 17: prefix caching on the paged engine, requests sharing a
    PREFIX_LEN-token prefix, request 0 first: uncached (graphed), cached
    eager then graphed; the fp32 gate; spec with the prefix cache on the
    squeezed pool. Returns the readings."""
    prompts = prefix_prompts(cfg.vocab)
    log(f"  prompt lengths: {[len(p) for p in prompts]} (a {PREFIX_LEN}-"
        f"token prefix shared)")
    u_eng, u_launches, u_fin, u_tok_s = run_engine(
        "paged uncached", params, cfg, scfg, prompts, dev, ops, stagger=True)
    u_chunks = u_eng.chunk_steps
    del u_eng
    torch.cuda.empty_cache()
    cached = dataclasses.replace(scfg, prefix_cache=True)
    eng, launches, fin, tok_s = run_eager_and_graphed(
        "paged prefix cache", params, cfg, cached, prompts, dev, ops,
        stagger=True)
    if eng.prefix_hits < 1 or eng.prefix_hit_pages < PREFIX_LEN // PS:
        raise RuntimeError(f"prefix cache: {prefix_line(eng)}")
    same = sum(int(fin[r] == u_fin[r]) for r in fin)
    toks = sum(int(a == b) for r in fin for a, b in zip(fin[r], u_fin[r]))
    out = {"tok_s": tok_s, "uncached_tok_s": u_tok_s,
           "chunk_steps": eng.chunk_steps, "uncached_chunk_steps": u_chunks}
    log(f"  cached graphed {tok_s:.1f} tok/s, {eng.chunk_steps} chunk steps;"
        f" uncached graphed {u_tok_s:.1f} tok/s, {u_chunks} chunk steps "
        f"({tok_s / u_tok_s:.2f}x); bf16 streams identical cached and "
        f"uncached: {same}/{len(fin)} ({toks}/{len(fin) * MAX_NEW} tokens)")
    del eng
    torch.cuda.empty_cache()

    failed = check_prefix_logits(params, cfg, T, dev, prompts)
    if failed:
        raise RuntimeError("; ".join(failed))

    both = dataclasses.replace(cached, spec_k=SPEC_K, n_pages=SQUEEZED_PAGES)
    eng, s_fin, wall, s_launches = serve(params, cfg, both, prompts, MAX_NEW,
                                         dev, ops, stagger=True)
    log(f"  spec_k {SPEC_K} with the prefix cache, squeezed pool, graphed: "
        f"{len(s_fin)} requests in {wall:.2f} s, {eng.ticks} ticks, "
        f"{eng.preemptions} preemptions, {eng.admission_rejections} holds; "
        f"{prefix_line(eng)}; {spec_line(eng)}")
    check_served(eng, s_fin, prompts, MAX_NEW, cfg.vocab)
    check_spec_launches("spec with prefix cache", eng, s_launches,
                        cfg.n_layers)
    out["squeezed_cows"] = eng.cow_copies
    del eng
    torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------------------
# Phase 18: open-loop overload and observability
# ----------------------------------------------------------------------------

# A chat service with a metered batch tenant under a burst, on phase 6's
# squeezed pool, which loses pages to a co-tenant, then its drafts' accept
# rate, then its slots to a churn storm (the canonical fault schedule).
OVERLOAD = dict(max_queue=16, max_preemptions=3, degrade=True,
                prefill_chunks_per_tick=2, trace_capacity=1 << 16)
OVERLOAD_TRAFFIC = dict(process="bursty", rate=0.5, burst_factor=8,
                        n_requests=48, seed=0, max_prompt=1536)
OVERLOAD_FAULTS = dict(t0=6, dwell=10, gap=8)
OVERLOAD_TRACE = os.path.join(ROOT, "build", "overload_trace.json")


def overload_configs(scfg, cfg):
    """Phase 18's engine and traffic configurations."""
    from repro_torch.serve import traffic
    from repro_torch.serve.engine import SLOClass

    classes = (SLOClass("chat", priority=2, ttft_slo=16, tpot_slo=2.0),
               SLOClass("batch", priority=0, rate=256.0))
    ocfg = dataclasses.replace(scfg, n_pages=SQUEEZED_PAGES, spec_k=SPEC_K,
                               classes=classes, **OVERLOAD)
    tcfg = traffic.TrafficConfig(vocab=cfg.vocab, classes=(
        traffic.TrafficClass("chat", weight=0.7, prompt_lo=64, prompt_hi=512,
                             out_lo=16, out_hi=64, ttft_ms=500.0,
                             tpot_ms=50.0),
        traffic.TrafficClass("batch", weight=0.3, prompt_lo=512,
                             prompt_hi=1536, out_lo=32, out_hi=64)),
        **OVERLOAD_TRAFFIC)
    return ocfg, tcfg


def run_overload_once(params, cfg, ocfg, tcfg, dev, ops, capture: bool,
                      telemetry: bool) -> dict:
    """One open-loop run of the overload engine under the fault schedule;
    launch counts and wall time cover the run only (not the engine's
    construction)."""
    from repro_torch.serve import faults, traffic
    from repro_torch.serve.engine import ServingEngine

    eng = ServingEngine(params, cfg, dataclasses.replace(
        ocfg, telemetry=telemetry), device=dev, capture=capture)
    if eng.graphed != capture:
        raise RuntimeError(f"engine graphed={eng.graphed}, asked {capture}")
    arrivals = traffic.TrafficGenerator(tcfg).arrivals()
    inj = faults.FaultInjector(faults.canonical_schedule(**OVERLOAD_FAULTS))
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    res = traffic.run_open_loop(eng, arrivals, injector=inj)
    inj.finish(eng)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    toks = sum(len(v) for v in eng.finished.values())
    return dict(eng=eng, arrivals=arrivals, res=res, inj=inj, wall=wall,
                launches=dict(ops.LAUNCHES), tok_s=toks / wall, toks=toks,
                leaked=eng.pool.pages_in_use,
                phantom=faults.PHANTOM_SLOT in eng.pool.slot_pages)


def overload_trace(eng) -> list:
    """The event trace without its times: (tick, kind, payload)."""
    return [(tick, kind, p) for _, tick, kind, p in eng.telemetry.events]


def check_overload_run(label, run, cfg) -> list:
    """A run's own gates: every request resolved, nothing leaked, the
    page events reconciled with the allocator, the two kernels launched
    as the steps run. Returns failures."""
    eng, failed = run["eng"], []
    if run["res"]["unresolved"]:
        failed.append(f"{label}: unresolved {run['res']['unresolved']}")
    if run["leaked"] or run["phantom"]:
        failed.append(f"{label}: {run['leaked']} pages leaked (phantom held:"
                      f" {run['phantom']})")
    if eng.telemetry.enabled:
        if eng.telemetry.dropped_events:
            failed.append(f"{label}: the ring dropped events")
        tel = eng.telemetry
        net = (sum(p["n"] for *_, p in tel.events_of("page_alloc"))
               - sum(p["n"] for *_, p in tel.events_of("page_free")))
        if net != eng.pool.pages_allocated - eng.pool.pages_freed:
            failed.append(f"{label}: page events net {net}, allocator "
                          f"{eng.pool.pages_allocated - eng.pool.pages_freed}")
    n, launches = cfg.n_layers, run["launches"]
    if not (eng.decode_steps > 0 and eng.verify_steps > 0
            and launches["flash_decode_paged"] == n * eng.decode_steps
            and launches["flash_attention_paged"]
            == n * (eng.chunk_steps + eng.verify_steps)):
        failed.append(f"{label}: launches {launches} for {eng.decode_steps} "
                      f"decode, {eng.verify_steps} verify, {eng.chunk_steps} "
                      f"chunk steps")
    return failed


def overload_report(run, tcfg) -> dict:
    """Log ``summarize``'s numbers, per-class attainment and the spans;
    returns the readings."""
    from repro_torch.serve import traffic

    eng = run["eng"]
    s = traffic.summarize(eng, run["arrivals"], classes=tcfg.classes)
    log(f"  summarize: {s['offered']} offered, {s['done']} done, "
        f"{s['forced']} forced, {s['rejected']} rejected in {s['ticks']} "
        f"ticks; TTFT p50/p99 {s['ttft_p50']:.1f}/{s['ttft_p99']:.1f} ticks "
        f"({s['ttft_ms_p50']:.1f}/{s['ttft_ms_p99']:.1f} ms), TPOT p50/p99 "
        f"{s['tpot_p50']:.3f}/{s['tpot_p99']:.3f} ticks "
        f"({s['tpot_ms_p50']:.2f}/{s['tpot_ms_p99']:.2f} ms); goodput "
        f"{s['goodput_tokens_per_tick']:.3f} tok/tick; shed rate "
        f"{s['shed_rate']:.4f}; {s['preemptions']} preemptions, "
        f"{s['admission_holds']} holds, {s['downshifts']} downshifts, "
        f"{s['degraded_ticks']} degraded ticks; tick wall p50/p99 "
        f"{s['tick_wall_s_p50'] * 1e3:.2f}/{s['tick_wall_s_p99'] * 1e3:.2f} "
        f"ms (mean {s['tick_wall_s_mean'] * 1e3:.2f})")
    for name, c in sorted(s["by_class"].items()):
        att = ", ".join(f"{k} {c[k]:.3f}" for k in (
            "ttft_slo_attainment", "tpot_slo_attainment",
            "ttft_ms_slo_attainment", "tpot_ms_slo_attainment") if k in c)
        log(f"  class {name}: {c['done']}/{c['offered']} done, {c['forced']} "
            f"forced, {c['rejected']} rejected, shed "
            f"{eng.shed_by_class.get(name, 0)}; TTFT p50 {c['ttft_p50']:.1f} "
            f"ticks; attainment: {att or 'no targets'}")
    for name, st in sorted(eng.telemetry.span_stats().items()):
        log(f"  span {name}: n {st['n']}, execute mean "
            f"{st['execute_mean_s'] * 1e3:.3f} ms, first runs "
            f"{st['compile_n']} ({st['compile_s'] * 1e3:.1f} ms)")
    return s


def run_overload(params, cfg, scfg, dev, ops) -> dict:
    """Phase 18: the overload engine eager and traced, graphed and traced,
    graphed and untraced, under the same arrivals and faults; the gates
    of each run, eager = graphed, traced = untraced, the overload paths
    all taken, the graphs' kernels, and the Chrome trace. Returns the
    readings."""
    t_phase = time.perf_counter()
    ocfg, tcfg = overload_configs(scfg, cfg)
    runs, failed = {}, []
    for label, capture, traced in (("eager traced", False, True),
                                   ("graphed traced", True, True),
                                   ("graphed untraced", True, False)):
        run = runs[label] = run_overload_once(params, cfg, ocfg, tcfg, dev,
                                              ops, capture, traced)
        eng = run["eng"]
        pools = ", ".join(f"{k} {v / 2**20:.1f}"
                          for k, v in eng.graph_pools.items())
        log(f"  {label}: {len(eng.finished)} finished, {len(eng.rejected)} "
            f"rejected, {run['toks']} tokens in {run['wall']:.2f} s "
            f"({run['tok_s']:.1f} tok/s), {eng.ticks} ticks, "
            f"{eng.chunk_steps} chunk, {eng.decode_steps} decode, "
            f"{eng.verify_steps} verify steps; faults {run['inj'].injected} "
            f"armed, {run['inj'].cleared} cleared; launches "
            f"{ {k: v for k, v in run['launches'].items() if v} }"
            + (f"; graph pools {eng.graph_bytes / 2**20:.1f} MiB ({pools}),"
               f" captured in {eng.capture_seconds:.3f} s"
               if eng.graphed else ""))
        failed += check_overload_run(label, run, cfg)
        if label != "graphed untraced":
            run["trace"] = overload_trace(eng)
            run["counters"] = dict(eng.telemetry.counters)
        if label == "eager traced":
            run["eng"] = types.SimpleNamespace(
                outcome=eng.outcome, finished=eng.finished, ticks=eng.ticks)
            del eng
            torch.cuda.empty_cache()
    eager, graphed, untraced = (runs[k] for k in (
        "eager traced", "graphed traced", "graphed untraced"))
    g = graphed["eng"]
    for key in ("trace", "counters", "launches"):
        if eager[key] != graphed[key]:
            failed.append(f"eager and graphed {key} differ")
    for key in ("outcome", "finished"):
        if getattr(eager["eng"], key) != getattr(g, key):
            failed.append(f"eager and graphed {key} differ")
    u = untraced["eng"]
    if (u.finished, u.outcome, u.ticks) != (g.finished, g.outcome, g.ticks):
        failed.append("graphed traced and untraced runs differ")
    c = g.telemetry.counters
    outcomes = list(g.outcome.values())
    forced = sum(o.startswith("forced") or o.endswith("preempt_limit")
                 or o.endswith("capacity") for o in outcomes)
    took = {"shed": c.get("shed", 0), "preempt": c.get("preempt", 0),
            "forced or capped": forced,
            "degrade_enter": c.get("degrade_enter", 0),
            "degrade_exit": c.get("degrade_exit", 0),
            "admit_hold": c.get("admit_hold", 0)}
    log(f"  overload paths taken (graphed): {took}; outcomes "
        f"{ {o: outcomes.count(o) for o in sorted(set(outcomes))} }; "
        f"{spec_line(g)}")
    if min(took.values()) < 1:
        failed.append(f"an overload path was not taken: {took}")
    n = cfg.n_layers
    want = {"verify": {"flash_attention_paged": n},
            "decode": {"flash_decode_paged": n},
            "chunk": {"flash_attention_paged": n}}
    if g.graph_nodes != want:
        failed.append(f"the graphs hold {g.graph_nodes}, not {want}")
    os.makedirs(os.path.dirname(OVERLOAD_TRACE), exist_ok=True)
    with open(OVERLOAD_TRACE, "w") as f:
        json.dump(g.telemetry.chrome_trace(), f)
    with open(OVERLOAD_TRACE) as f:
        back = json.load(f)
    tracks = {e["tid"] for e in back["traceEvents"] if "tid" in e}
    phases = {f"phase:{name}" for name in g.telemetry.span_stats()
              if name != "prefill_chunk"}
    slots = {f"slot:{i}" for i in range(g.scfg.batch)}
    log(f"  chrome trace {os.path.relpath(OVERLOAD_TRACE, ROOT)}: "
        f"{len(back['traceEvents'])} events, {os.path.getsize(OVERLOAD_TRACE)}"
        f" bytes, tracks {sorted(tracks)}")
    if not phases | slots <= tracks:
        failed.append(f"chrome trace lacks tracks "
                      f"{sorted((phases | slots) - tracks)}")
    s = overload_report(graphed, tcfg)
    if failed:
        raise RuntimeError("; ".join(failed))
    log(f"  eager = graphed in trace, counters, outcomes, streams and "
        f"launches; traced = untraced in streams, outcomes and ticks; phase "
        f"18 in {time.perf_counter() - t_phase:.1f} s")
    out = {"tok_s": {k: r["tok_s"] for k, r in runs.items()},
           "ticks": g.ticks, "shed": took["shed"],
           "preemptions": took["preempt"], "graph_MiB": {
               k: v / 2**20 for k, v in g.graph_pools.items()},
           "ttft_ms_p50": s["ttft_ms_p50"], "tpot_ms_p50": s["tpot_ms_p50"]}
    del g, u, runs, graphed, untraced
    torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------------------
# Phase 19: the serving cost models and their calibration
# ----------------------------------------------------------------------------

# The phase's own tuning cache (removed before and after), so that no later
# run's engines read what this one measured.
COST_CACHE = os.path.join(ROOT, "build", "chip_smoke_tuning_cache.json")
# The adaptive speculative engine: SPEC_K drafts at most, the width
# re-chosen every ADAPT_EVERY verify ticks, a trial tick every ADAPT_EVERY
# plain ticks once it is 0; drafts corrupted for COLLAPSE_TICKS ticks from
# the first tick at or after COLLAPSE_AFTER at which speculation is open
# (its early windows propose little, so k_live is often 0 there, and where
# it re-opens depends on the constants this run measured). fp32, so that
# its streams can be held to plain decode's (bf16 flips near-ties).
ADAPT_EVERY = 4
COLLAPSE_AFTER, COLLAPSE_TICKS = 24, 12
ADAPT_REQUESTS, ADAPT_NEW = 8, 128


def check_gemm_registers(report: list, gemm_kernel) -> list:
    """The registers ``kernels.gemm.REGISTERS`` prices each tile's
    occupancy with, against ptxas's report of this build."""
    failed = []
    for dtype, tiles in gemm_kernel.REGISTERS.items():
        for (bm, _, bn), regs in tiles.items():
            name = (f"gemm_kernel<float, {bm}, {bn}, true>"
                    if dtype == torch.float32 else
                    f"gemm_wgmma_kernel<{bn}, ")
            got = [int(m.group(1)) for line in report if name in line
                   for m in [re.search(r": (\d+) registers", line)] if m]
            if not got or set(got) != {regs}:
                failed.append(f"{name}: ptxas {got}, REGISTERS {regs}")
    return failed


def adaptive_run(params, cfg, scfg, prompts, dev, ops, capture: bool,
                 faults):
    """Serve ``prompts`` on the adaptive speculative engine, with an
    accept-collapse window scheduled where speculation is open; returns
    the engine, streams, launches, wall, the k_live a tick and the
    window."""
    from repro_torch.serve.engine import Request, ServingEngine

    eng = ServingEngine(params, cfg, scfg, device=dev, capture=capture)
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=p, max_new=ADAPT_NEW))
    inj = faults.FaultInjector([])
    torch.cuda.synchronize()
    ops.reset_launches()
    traj, window = [], None
    t0 = time.perf_counter()
    for _ in range(10_000):
        if window is None and eng.ticks >= COLLAPSE_AFTER and eng.k_live:
            window = (eng.ticks, eng.ticks + COLLAPSE_TICKS)
            inj.schedule.append(faults.Fault(
                kind=faults.FaultInjector.ACCEPT_COLLAPSE, start=window[0],
                stop=window[1]))
        inj.step(eng)
        n = eng.tick()
        traj.append(eng.k_live)
        if n == 0 and not eng.queue:
            break
    inj.finish(eng)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if inj.injected != 1 or inj.cleared != 1:
        raise RuntimeError(f"accept collapse injected {inj.injected}, "
                           f"cleared {inj.cleared} (window {window})")
    return eng, dict(eng.finished), dict(ops.LAUNCHES), wall, traj, window


def collapse_and_reopen(traj: list, window) -> bool:
    """``k_live`` (one entry a tick: ``traj[i]`` after tick i + 1) was
    above 0 when the collapse window [lo, hi) opened (the window is armed
    before tick lo + 1), reached 0 inside it, and was above 0 again after
    the window's end."""
    lo, hi = window
    if len(traj) <= hi or not traj[lo - 1]:
        return False
    off = [i for i in range(lo, hi) if traj[i] == 0]
    return bool(off) and any(traj[hi:])


def drift_lines(label, rep) -> list:
    """Log ``drift_report``'s components; returns the ratios that are not
    finite and positive."""
    bad = []
    for comp in ("decode", "prefill_chunk", "spec_verify"):
        row = rep.get(comp)
        if row is None:
            continue
        log(f"  drift {label} {comp}: measured {row['measured_s'] * 1e3:.4f}"
            f" ms over {row['n_spans']} spans; modelled (calibrated) "
            f"{row['modeled_s'] * 1e3:.4f} ms, ratio {row['ratio']:.3f}; "
            f"modelled (defaults) {row['modeled_default_s'] * 1e3:.4f} ms, "
            f"ratio {row['ratio_default']:.3f}"
            + (f"; mean context {row['mean_context']}, slots "
               f"{row['mean_slots']}" if "mean_context" in row else "")
            + (f"; accept rate {row['accept_rate']:.3f}"
               if "accept_rate" in row else ""))
        for key in ("ratio", "ratio_default"):
            if not (math.isfinite(row[key]) and row[key] > 0):
                bad.append(f"{label} {comp} {key} {row[key]}")
    return bad


def run_costmodels(params, cfg, scfg, dev, ops, spec) -> dict:
    """Phase 19: calibrate every constant on the card into the phase's own
    cache; serve phase 5's requests with the chunk the calibrated model
    chooses and with chunk 256; the adaptive speculative engine through an
    accept collapse, eager then graphed, against plain decode (fp32); the
    drift report; ``choose_spec_k`` at the accept rate measured there.
    Returns the readings."""
    from repro_torch.core import autotune, calibrate
    from repro_torch.models import transformer as T
    from repro_torch.serve import faults, telemetry
    from repro_torch.serve.spec import NgramDraft
    from repro_torch.tree import tree_map

    saved = (autotune.TUNING_CACHE_PATH, autotune._tuning_cache,
             os.environ.pop(autotune.DEFAULT_CONSTANTS_ENV, None))
    if os.path.exists(COST_CACHE):
        os.remove(COST_CACHE)
    autotune.TUNING_CACHE_PATH, autotune._tuning_cache = COST_CACHE, None
    out = {}
    try:
        t0 = time.perf_counter()
        results = calibrate.run_calibration(device=dev)
        assumed = autotune.assumed_constants()
        for name, r in results.items():
            detail = {k: v for k, v in r.detail.items()
                      if k not in ("lookups", "t_paged_s", "t_contig_s")}
            log(f"  calibrated {name}: {r.value:.4e} {r.unit} (assumed "
                f"{assumed[name]:.4e}, drift "
                f"{autotune.drift_ratio(r.value, assumed[name]):.3f}; "
                f"{r.n_trials} trials, spread {r.spread:.3f}); {detail}")
        lk = results["page_lookup_s"].detail
        log(f"  page-lookup sweep (device ms a launch, paged / contiguous):"
            + ", ".join(f" {n} rows {p * 1e3:.4f}/{c * 1e3:.4f}"
                        for n, p, c in zip(lk["tables"], lk["t_paged_s"],
                                           lk["t_contig_s"])))
        bad = [n for n, r in results.items()
               if not (math.isfinite(r.value) and r.value > 0)]
        if bad or set(results) != set(autotune.CALIBRATED_NAMES):
            raise RuntimeError(f"calibration: constants {bad} not finite "
                               f"and positive, or missing")
        if results["hbm_bandwidth"].value > HBM_BYTES_PER_S:
            raise RuntimeError("the stream read faster than the data sheet")
        if min(lk["launches"].values()) <= 0:
            raise RuntimeError(f"page-lookup probe launches {lk['launches']}")
        const = autotune.resolve_constants(backend=dev.type)
        if const.source != "calibrated":
            raise RuntimeError(f"constants after calibration: {const}")
        log(f"  calibration took {time.perf_counter() - t0:.1f} s")
        out["constants"] = {n: r.value for n, r in results.items()}

        # The chunk the calibrated model chooses, against chunk 256.
        prompts = make_requests(cfg.vocab, N_REQUESTS)
        auto = dataclasses.replace(scfg, chunk_size=None)
        default_chunk, _ = autotune.choose_prefill_chunk(
            MAX_LEN, cfg.n_heads, cfg.n_kv_heads, cfg.dhead, PS)
        runs = {}
        for label, c in (("chosen", auto), ("256", scfg)):
            eng, fin, wall, launches = serve(params, cfg, c, prompts,
                                             MAX_NEW, dev, ops)
            check_served(eng, fin, prompts, MAX_NEW, cfg.vocab)
            toks = sum(len(v) for v in fin.values())
            runs[label] = dict(eng=eng, fin=fin, tok_s=toks / wall)
            log(f"  chunk {eng.chunk} ({label}), graphed: {toks} tokens in "
                f"{wall:.2f} s ({toks / wall:.1f} tok/s), {eng.ticks} ticks, "
                f"{eng.chunk_steps} chunk steps, launches {launches}")
        chosen = runs["chosen"]["eng"].chunk
        log(f"  the calibrated model chose chunk {chosen} (the defaults "
            f"choose {default_chunk}); {runs['chosen']['tok_s']:.1f} tok/s "
            f"against chunk 256's {runs['256']['tok_s']:.1f}")
        part = first_difference(runs["chosen"]["fin"], runs["256"]["fin"])
        if part is not None:
            raise RuntimeError(f"chunk {chosen} and chunk 256 streams part "
                               f"at (rid, index) {part}")
        chunk_drift = telemetry.drift_report(runs["chosen"]["eng"])
        out.update(chunk=chosen, default_chunk=default_chunk,
                   chunk_tok_s=runs["chosen"]["tok_s"],
                   chunk256_tok_s=runs["256"]["tok_s"])
        del runs, eng
        torch.cuda.empty_cache()

        # Adaptive speculation through an accept collapse, fp32.
        f32cfg = dataclasses.replace(cfg, compute_dtype="float32")
        f32 = tree_map(lambda t: t.float(), params)   # a second copy
        aprompts = make_requests(cfg.vocab, ADAPT_REQUESTS, lo=64, hi=512)
        plain, p_fin, _, _ = serve(f32, f32cfg, scfg, aprompts, ADAPT_NEW,
                                   dev, ops)
        check_served(plain, p_fin, aprompts, ADAPT_NEW, cfg.vocab)
        del plain
        adapt = dataclasses.replace(
            scfg, spec_k=SPEC_K, draft=NgramDraft(),
            spec_adapt_every=ADAPT_EVERY, spec_probe_every=ADAPT_EVERY)
        seen = {}
        for capture in (False, True):
            eng, fin, launches, wall, traj, window = adaptive_run(
                f32, f32cfg, adapt, aprompts, dev, ops, capture, faults)
            check_served(eng, fin, aprompts, ADAPT_NEW, cfg.vocab)
            mode = "graphed" if capture else "eager"
            log(f"  adaptive spec ({mode}, fp32): {eng.ticks} ticks in "
                f"{wall:.2f} s, collapse over ticks {window}, k_live a "
                f"tick {traj}; {eng.spec_probes} "
                f"trial ticks; {spec_line(eng)}; {eng.decode_steps} decode "
                f"steps, launches {launches}")
            seen[mode] = (fin, traj, eng.spec_probes, launches,
                          schedule(eng, launches), window)
            if capture:
                break
            del eng
            torch.cuda.empty_cache()
        if seen["graphed"][1:] != seen["eager"][1:] or \
                seen["graphed"][0] != seen["eager"][0]:
            raise RuntimeError("adaptive spec: graphed and eager differ in "
                               "streams, k_live, trial ticks or schedule")
        diff = first_difference(seen["graphed"][0], p_fin)
        if diff is not None:
            raise RuntimeError(f"adaptive spec streams part from plain "
                               f"decode at (rid, index) {diff}")
        traj, window = seen["graphed"][1], seen["graphed"][5]
        if window is None or not collapse_and_reopen(traj, window):
            raise RuntimeError(f"k_live was not open at the collapse "
                               f"window {window}, or did not fall to 0 "
                               f"in it and reopen after it: {traj}")
        want = {"verify": {"flash_attention_paged": cfg.n_layers},
                "decode": {"flash_decode_paged": cfg.n_layers},
                "chunk": {"flash_attention_paged": cfg.n_layers}}
        if eng.graph_nodes != want:
            raise RuntimeError(f"adaptive graphs hold {eng.graph_nodes}, "
                               f"not {want}")
        launches = seen["graphed"][3]
        if min(launches["flash_decode_paged"],
               launches["flash_attention_paged"]) <= 0:
            raise RuntimeError(f"adaptive spec launches {launches}")
        log(f"  adaptive spec: graphed = eager, streams = plain decode "
            f"(fp32); the graphs {eng.graph_nodes}")
        out.update(k_live=traj, collapse=window,
                   spec_probes=eng.spec_probes, adaptive_launches=launches)

        # Drift, and choose_spec_k at the accept rate measured here.
        rep = telemetry.drift_report(eng, persist=True)
        bad = drift_lines("adaptive fp32", rep)
        bad += drift_lines("chunk-chooser bf16", chunk_drift)
        cal = rep["calibration"]
        log(f"  drift report constants: {rep['constants']}; calibration "
            f"source {cal['source']}")
        if bad or rep["constants"]["source"] != "calibrated":
            raise RuntimeError(f"drift ratios not finite and positive: "
                               f"{bad}")
        rate = eng.spec_accepted / max(1, eng.spec_proposed)
        c = eng.telemetry.counters
        ctx = max(1, round(c["verify_context_rows"]
                           / max(1, c["verify_slot_ticks"])))
        param_bytes = T.active_param_count(cfg) * 2.0
        k, terms = autotune.choose_spec_k(
            [ctx] * B, cfg.n_heads, cfg.n_kv_heads, cfg.dhead, PS, rate,
            param_bytes, ks=tuple(range(1, SPEC_K + 1)), constants=const)
        at4 = autotune.spec_decode_model(
            [ctx] * B, cfg.n_heads, cfg.n_kv_heads, cfg.dhead, PS, SPEC_K,
            spec["accept_rate"], param_bytes, constants=const)
        log(f"  choose_spec_k (bf16, {B} slots of {ctx} rows, calibrated) at "
            f"the accept rate {rate:.3f} measured here: k {k}, modelled "
            f"speedup {terms['speedup']:.3f}x; at k {SPEC_K} and phase 16's "
            f"accept rate {spec['accept_rate']:.3f} the model says "
            f"{at4['speedup']:.3f}x, where phase 16 measured graphed spec "
            f"over plain {spec['tok_s'] / spec['plain_tok_s']:.3f}x")
        out.update(drift={c: rep[c]["ratio"] for c in
                          ("decode", "prefill_chunk", "spec_verify")
                          if c in rep},
                   chosen_k=k, modelled_speedup=terms["speedup"],
                   modelled_k4=at4["speedup"],
                   measured_k4=spec["tok_s"] / spec["plain_tok_s"])
        del eng, f32
        torch.cuda.empty_cache()
    finally:
        autotune.TUNING_CACHE_PATH, autotune._tuning_cache = saved[:2]
        if saved[2] is not None:
            os.environ[autotune.DEFAULT_CONSTANTS_ENV] = saved[2]
        if os.path.exists(COST_CACHE):
            os.remove(COST_CACHE)
    return out


# ----------------------------------------------------------------------------
# Phase 20: the paper's dissection on the card
# ----------------------------------------------------------------------------

def column(rep, ns) -> dict:
    """Table 3.1's rows of one report, for the log."""
    kib = lambda b: f"{b / 2**10:.1f} KiB"          # noqa: E731
    said = lambda v: "not probed" if v is None else v   # noqa: E731
    out = {"L1 size": kib(rep.l1.size), "L1 line": f"{rep.l1.line} B",
           "L1 ways": said(rep.l1.ways), "L1 sets": said(rep.l1.sets),
           "L1 policy": rep.l1.policy,
           "L1 hit": f"{rep.l1.hit_latency} cyc{ns(rep.l1.hit_latency)}",
           "L2 size": kib(rep.l2.size), "L2 line": f"{rep.l2.line} B",
           "L2 policy": said(rep.l2.policy),
           "L2 hit": f"{rep.l2.hit_latency} cyc{ns(rep.l2.hit_latency)}"}
    for i, t in enumerate(rep.tlbs, 1):
        out[f"L{i} TLB"] = (f"{t.page_entry / 2**20:g} MiB pages, "
                            f"{t.coverage / 2**20:g} MiB")
    return out


def run_dissection(dev, ops, card, dissect, hwmodel) -> dict:
    """Phase 20; returns its summary and the launches it counted."""
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    ops.reset_launches()
    rep = card.dissect_card(dev)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    log(f"  dissect_card: {rep.seconds:.1f} s, launches {launches}, "
        f"flush (evict) {rep.evict_ms:.3f} ms each, SM clock "
        f"{rep.sm_clock_mhz:.1f} MHz (clock64 cycles of one chase's whole "
        f"timed walk over its CUDA-event time)")
    v100 = dissect.dissect(hwmodel.V100)
    ns = lambda c: f" ({rep.ns(c):.1f} ns)"                # noqa: E731
    h, v = column(rep, ns), column(v100, lambda c: "")
    log(f"  Table 3.1: H100 (this card, L1 at carveout {rep.carveout} %, "
        f"nominal {rep.l1_nominal / 2**10:.0f} KiB) | V100 (device model)")
    for row in dict.fromkeys([*h, *v]):
        log(f"    {row:10s} {str(h.get(row, '-')):36s} | "
            f"{v.get(row, '-')}")
    log(f"    TLBs: {rep.tlb_note}")
    log("  Table 3.3 on the card (carveout %: detected L1 / nominal): "
        + ", ".join(f"{cv}: {d / 2**10:.1f}/{n / 2**10:.0f} KiB"
                    for cv, (d, n) in rep.table_3_3.items()))
    log(f"  Fig 3.2 cold scan (64 KiB, .ca): {rep.latency}; its classes "
        f"{rep.cold_classes}")
    log("  steady classes: " + ", ".join(f"{k} {c} cyc{ns(c)}"
                                         for k, c in rep.steady.items()))
    log("  footprint profile (.cg warm, median load): " + ", ".join(
        f"{mib} MiB {c} cyc{ns(c)}" for mib, c in rep.profile.items()))
    log(f"  every class made: {rep.classes}")
    log(f"  bounds {rep.bounds}; cuts {rep.cuts}")
    failed = []
    if launches["pchase_timed"] <= 0:
        failed.append(f"pchase_timed not launched: {launches}")
    s = rep.steady
    if not s["l1_hit"] < s["l2_hit"] < s["memory"]:
        failed.append(f"latency classes do not rise: {s}")
    if not 0 < rep.l1.size <= 256 * 2**10:
        failed.append(f"L1 size {rep.l1.size} outside (0, 256 KiB]")
    if not rep.l1.size < rep.l2.size <= 2 * hwmodel.H100.l2_bytes:
        failed.append(f"L2 size {rep.l2.size} not between the L1's and "
                      f"2 x {hwmodel.H100.l2_bytes}")
    for name, line in (("L1", rep.l1.line), ("L2", rep.l2.line)):
        if line <= 0 or line & (line - 1):
            failed.append(f"{name} line {line} is not a power of two")
    if not (all(v100.matches.values())
            and v100.matches == dissect.compare_to_spec(v100, hwmodel.V100)):
        failed.append(f"V100 device model off its column: {v100.matches}")
    log(f"  V100 device model: {sum(v100.matches.values())}/"
        f"{len(v100.matches)} of compare_to_spec true; phase 20 took "
        f"{time.perf_counter() - t0:.1f} s")
    if failed:
        raise RuntimeError("; ".join(failed))
    return {"launches": launches["pchase_timed"], "seconds": rep.seconds,
            "l1": rep.l1.size, "l2": rep.l2.size, "steady": rep.steady,
            "tlbs": rep.tlb_note}


def init_model(name, configs, T, dev, n_layers=None):
    """Random bf16 weights of ``name``'s full configuration from a seeded
    generator on the card; ``n_layers`` cuts the depth (the widths stay
    the published ones)."""
    cfg = configs.get_config(name)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    torch.cuda.synchronize()
    log(f"  {cfg.name}: {T.tree_param_count(params) / 1e9:.3f} B parameters, "
        f"{cfg.n_layers} layers ({'/'.join(cfg.pattern)}), d_model "
        f"{cfg.d_model}, bf16, initialised in "
        f"{time.perf_counter() - t0:.1f} s")
    return cfg, params


@contextlib.contextmanager
def counting_drops(moe_mod):
    """``moe_apply`` wrapped to add up, on the card, the (token, expert)
    choices each capacity call drops and the choices it routes (a chunk's
    padded rows included): one more routing pass a MoE layer, no wait on
    the host until the caller reads the sum."""
    orig, acc = moe_mod.moe_apply, {"dropped": [], "choices": 0}

    def counted(params, cfg, x):
        if cfg.impl == "capacity":
            acc["dropped"].append(moe_mod.dropped(params, cfg, x))
            acc["choices"] += x.shape[0] * x.shape[1] * cfg.top_k
        return orig(params, cfg, x)

    moe_mod.moe_apply = counted
    try:
        yield acc
    finally:
        moe_mod.moe_apply = orig


@contextlib.contextmanager
def recording_routes(moe_mod):
    """The router's choices of every MoE call, each token's sorted."""
    orig, ids = moe_mod._route, []

    def recorded(params, cfg, x, *split):
        out = orig(params, cfg, x, *split)
        ids.append(out[1].sort(dim=-1).values)
        return out

    moe_mod._route = recorded
    try:
        yield ids
    finally:
        moe_mod._route = orig


def family_logits(params, cfg, T, dev, prompt, paged, paths, ops, moe_mod):
    """Logits of a prefill and a decode step (``paged_logits`` or
    ``contiguous_logits``) through the kernels and through each path, with
    the router's choices of each run."""
    fn = paged_logits if paged else contiguous_logits
    out, routes = {}, {}
    for name, override in [("kernel", {})] + list(paths.items()):
        with kernel_ops(ops, **override), recording_routes(moe_mod) as ids:
            out[name] = fn(params, cfg, T, dev, prompt)
        routes[name] = ids
    return out, routes


def routed_alike(b16_routes, f32_routes, n_moe: int, n_rows: int) -> dict:
    """Part -> mask of the logits rows whose router made the same choices
    (every MoE layer) in the kernel and plain bf16 paths and the plain
    fp32 path: part 0, the last prefill forward's first ``n_rows`` rows;
    part 1, the decode step's row. The calls come ``n_moe`` a forward, in
    order."""
    paths = (b16_routes["kernel"], b16_routes["plain"], f32_routes["plain"])
    masks = {}
    for part, calls, n in ((0, slice(-2 * n_moe, -n_moe), n_rows),
                           (1, slice(-n_moe, None), 1)):
        same = None
        for a, b in zip(paths, paths[1:]):
            for x, y in zip(a[calls], b[calls]):
                eq = (x[:n] == y[:n]).all(dim=-1)
                same = eq if same is None else same & eq
        masks[part] = same if part == 0 else same.reshape(())
    return masks


def route_agreement(routes) -> str:
    """How many (token, expert) choices the kernel path's router makes as
    the plain path's: a flip at a near-tie of the router moves a token's
    MoE output, which the logits then show."""
    if not routes["kernel"]:
        return "no router"
    same = sum(int((a == b).sum()) for a, b in zip(routes["kernel"],
                                                   routes["plain"]))
    total = sum(a.numel() for a in routes["kernel"])
    return f"{same}/{total} (token, expert) choices agree"


def run_families(dev, ops, ref, configs, T, moe_mod) -> dict:
    """Phase 21: each model of FAMILIES at its published widths, bf16,
    random weights from a seeded generator, at its cut depth; served
    eagerly and then graphed (equal schedule, launches and streams; the
    graphs one decode, and paged one prefill, an attention layer); the
    launches per step; then logits of the kernel path against the plain
    path. Returns per model its tok/s, memory and readings."""
    from repro_torch.serve.engine import ServeConfig

    summary = {}
    for name, (depth, check_depth) in FAMILIES.items():
        t_model = time.perf_counter()
        cfg, params = init_model(name, configs, T, dev, n_layers=depth)
        n_attn = T.n_attention_layers(cfg)
        n_mamba = cfg.n_layers - n_attn
        paged = n_mamba == 0
        active = T.active_param_count(cfg)
        log(f"  {name}: {depth} of {configs.get_config(name).n_layers} "
            f"layers, {n_attn} attention, {n_mamba} Mamba, "
            f"{sum(cfg.is_moe(i) for i in range(depth))} MoE "
            f"({cfg.n_experts} experts, top-{cfg.top_k}, {cfg.moe_impl}); "
            f"{active / 1e9:.3f} B active parameters a token; "
            f"{'paged' if paged else 'contiguous'} engine")
        prompts = make_requests(cfg.vocab, FAMILY_REQUESTS, lo=FAMILY_LO,
                                hi=FAMILY_HI)
        log(f"  prompt lengths: {[len(p) for p in prompts]}")
        scfg = (ServeConfig(max_len=MAX_LEN, batch=B, paged=True,
                            page_size=PS, chunk_size=CHUNK, eos_id=-1)
                if paged else ServeConfig(max_len=MAX_LEN, batch=B,
                                          eos_id=-1))
        eager_acc = {}

        @contextlib.contextmanager
        def eager_during():
            with counting_drops(moe_mod) as acc:
                eager_acc["acc"] = acc
                yield

        eng, launches, _, tok_s = run_eager_and_graphed(
            name, params, cfg, scfg, prompts, dev, ops, max_new=FAMILY_NEW,
            eager_during=eager_during)
        steps = eng.decode_steps
        want = ({"flash_decode_paged": n_attn * steps,
                 "flash_attention_paged": n_attn * eng.chunk_steps}
                if paged else
                {"flash_decode": n_attn * steps,
                 "ssd_scan": n_mamba * sum(eng.prefill_buckets.values())})
        if launches != dict(dict.fromkeys(launches, 0), **want):
            raise RuntimeError(f"{name}: launches {launches}, want {want}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        row = dict(tok_s=tok_s, peak_gib=peak,
                   capture_s=eng.capture_seconds,
                   graph_mib=eng.graph_bytes / 2**20, active=active,
                   launches={k: v for k, v in launches.items() if v})
        acc = eager_acc["acc"]
        if acc["choices"]:
            n_dropped = int(sum(t.item() for t in acc["dropped"]))
            row["dropped"] = n_dropped / acc["choices"]
            log(f"  {name}: capacity dropped {n_dropped} of "
                f"{acc['choices']} (token, expert) choices "
                f"({100 * row['dropped']:.2f} %) in the eager run (a "
                f"chunk's padded rows routed too)")
        log(f"  {name}: launches {row['launches']} = {n_attn} attention "
            f"layers x {steps} decode steps"
            + (f", x {eng.chunk_steps} chunk steps" if paged else
               f"; ssd_scan {n_mamba} x "
               f"{sum(eng.prefill_buckets.values())} admissions"))
        del eng
        torch.cuda.empty_cache()

        prompt = make_requests(cfg.vocab, 1, lo=300, hi=300)[0]
        if paged:
            paths = paged_paths(ops, ref)
            parts = [(0, "prefill chunk", "prefill fault"),
                     (1, "decode step", "decode fault")]
        else:
            # One attention layer in eight: the decode kernel's planted
            # fault (one key of 300 dropped) moves these logits by less
            # than the limit, so the decode step holds the SSD state's
            # (phases 7 and 10 hold the decode kernel's).
            paths = {k: v for k, v in contiguous_paths(ops, ref).items()
                     if k in ("plain", "ssd fault", "ssd state fault")}
            parts = [(0, "300-row prefill", "ssd fault"),
                     (1, "decode step", "ssd state fault")]
        n_check = check_depth
        cut = dict(params, blocks=params["blocks"][:n_check])
        b16cfg = dataclasses.replace(cfg, n_layers=n_check)
        f32cfg = dataclasses.replace(b16cfg, compute_dtype="float32")
        f32, f32_routes = family_logits(cut, f32cfg, T, dev, prompt, paged,
                                        paths, ops, moe_mod)
        b16, b16_routes = family_logits(cut, b16cfg, T, dev, prompt, paged,
                                        paths, ops, moe_mod)
        log(f"  {name} first {n_check} layers, router: fp32 "
            f"{route_agreement(f32_routes)}, bf16 "
            f"{route_agreement(b16_routes)} (kernel against plain path)")
        n_moe = sum(b16cfg.is_moe(i) for i in range(n_check))
        rows = (routed_alike(b16_routes, f32_routes, n_moe,
                             b16["plain"][0].shape[0]) if n_moe else None)
        failed = check_logits(f32, b16, parts,
                              f"{name} first {n_check} layers", rows=rows)
        row["fp32_logit_diff"] = max(max_diff(f32["kernel"][i],
                                              f32["plain"][i])
                                     for i, _, _ in parts)
        del f32, b16, cut, params
        torch.cuda.empty_cache()
        if failed:
            raise RuntimeError("; ".join(failed))
        row["seconds"] = time.perf_counter() - t_model
        log(f"  {name}: {row['seconds']:.1f} s in all")
        summary[name] = row
    return summary


def run_training(dev, ops, configs, T, steps) -> dict:
    """Phase 14: the training launcher at full width, resumed, scored
    through the kernel; returns the numbers it reports."""
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.launch import train as train_launch

    cfg = configs.get_config("qwen2-0.5b")
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        run = ["--ckpt", os.path.join(tmp, "run"), "--ckpt-every", "10"]
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        first = train_launch.main(TRAIN_ARGS + run + ["--steps", "30"])
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        resumed = train_launch.main(TRAIN_ARGS + run + ["--steps", "40"])
        fresh = train_launch.main(TRAIN_ARGS + [
            "--ckpt", os.path.join(tmp, "fresh"), "--ckpt-every", "40",
            "--steps", "40"])
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        disk = sum(os.path.getsize(os.path.join(d, f))
                   for d, _, fs in os.walk(tmp) for f in fs)
    losses = [m["loss"] for m in first["metrics"]]
    dts = sorted(m["dt"] for m in first["metrics"] + resumed["metrics"]
                 + fresh["metrics"])
    step_s = dts[len(dts) // 2]
    tokens = 4 * 512
    n_params = T.tree_param_count(fresh["state"]["params"])
    out = {"params_B": round(n_params / 1e9, 4),
           "losses": losses, "step_ms": step_s * 1e3,
           "tokens_per_s": tokens / step_s, "peak_GiB": peak,
           "first_30_steps_s": wall,
           "loss_40": (resumed["metrics"][-1]["loss"],
                       fresh["metrics"][-1]["loss"]),
           "checkpoint_GB_on_disk_at_end": disk / 1e9}
    log(f"  qwen2-0.5b ({out['params_B']} B parameters, fp32 masters, bf16 "
        f"compute), batch 4 x 512: losses {losses} (steps 10/20/30); step "
        f"{out['step_ms']:.1f} ms (median of logged steps), "
        f"{out['tokens_per_s']:.0f} tokens/s; max_memory_allocated "
        f"{peak:.2f} GiB; 30 steps with 3 checkpoints in {wall:.1f} s; "
        f"launches over the three runs {launches}")
    log(f"  resumed 30 -> 40: step-40 loss {out['loss_40'][0]:.6f}, fresh "
        f"run to 40: {out['loss_40'][1]:.6f}")
    failed = []
    if any(launches.values()):
        failed.append(f"training launched a kernel: {launches}")
    if not losses[-1] < losses[0]:
        failed.append(f"loss did not fall: {losses}")
    if [m["step"] for m in resumed["metrics"]] != [40]:
        failed.append(f"the second run did not resume from step 30: "
                      f"{resumed['metrics']}")
    a, b = out["loss_40"]
    if not abs(a - b) <= 1e-4 * abs(b):
        failed.append(f"resumed and fresh step-40 losses differ: {a} {b}")
    del first, resumed
    state = fresh["state"]
    tokens_np, labels_np = SyntheticLMData(DataConfig(
        vocab=cfg.vocab, seq_len=512, global_batch=4)).batch_at(40)
    batch = {"tokens": torch.from_numpy(tokens_np).to(dev),
             "labels": torch.from_numpy(labels_np).to(dev)}
    ops.reset_launches()
    failed += check_cacheless(state["params"], cfg, T, steps, batch, ops,
                              "qwen2-0.5b trained, cache-less")
    if ops.LAUNCHES["flash_attention"] < cfg.n_layers:
        failed.append(f"scoring skipped the kernel: {dict(ops.LAUNCHES)}")
    step = steps.make_train_step(dataclasses.replace(cfg, use_flash=True))
    try:
        step(state, batch)
        failed.append("a training step through the kernel ran")
    except RuntimeError as e:
        if "no backward" not in str(e):
            raise
        log(f"  a training step at use_flash=True raises: {e}")
    if failed:
        raise RuntimeError("; ".join(failed))
    return {k: out[k] for k in ("step_ms", "tokens_per_s", "peak_GiB")}


def nonzero_leaves(params, seed: int) -> None:
    """Set, in place and from a seeded generator, the leaves random init
    leaves at zero, which would hide what they do: each cross layer's
    gate to GATE plus noise (so the cross-attention reaches the logits),
    the qkv biases, the MLP's b_up and LayerNorm's bias to BIAS_SCALE
    times a standard normal."""
    gen = torch.Generator().manual_seed(seed)

    def walk(tree):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for key, leaf in items:
            if isinstance(leaf, (dict, list)):
                walk(leaf)
            elif key == "gate":
                leaf.copy_(GATE + GATE_NOISE * torch.randn(
                    leaf.shape, generator=gen))
            elif key in ("bias", "b_q", "b_k", "b_v", "b_up"):
                leaf.copy_(BIAS_SCALE * torch.randn(leaf.shape,
                                                    generator=gen))

    walk(params)


def time_encdec_shapes(dev, ops, ref) -> dict:
    """The contiguous decode at each phase-22 model's decode shape (its
    greedy_generate's last step: b slots over contexts first..last of a
    cache as long as the last) and the full-sequence kernel at its
    scoring shape (the prompts, causal), bf16, beside their plain
    versions, SDPA and the bound; the decode also checked in fp32.
    Returns rows for PERF.md, keyed "<kernel> <model>"."""
    dtype, esize, n_sets = torch.bfloat16, 2, 8
    gen = torch.Generator(device=dev).manual_seed(22)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev).to(dtype)  # noqa: E731
    out = {}
    for name, (b, h, kvh, d, lo, hi) in ENCDEC_DECODE.items():
        lengths = [int(x) for x in np.linspace(lo, hi, b)]
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        sets = [(rnd(b, hi, kvh, d), rnd(b, hi, kvh, d))
                for _ in range(n_sets)]
        q = rnd(b, h, d)
        ok, err = True, 0.0
        for dt in (torch.float32, torch.bfloat16):
            args = (q.to(dt), sets[0][0].to(dt), sets[0][1].to(dt), lens)
            got = ops.flash_decode(*args)
            torch.cuda.synchronize()
            o, e = ref.compare(got, ref.flash_decode(*args))
            ok, err = ok and o, max(err, e)
            log(f"  flash_decode at {name}'s decode shape, {dt}: "
                f"max_abs_err {e:.3e} {'ok' if o else 'FAIL'}")
        views = [tuple(t.transpose(1, 2).contiguous() for t in kv)
                 for kv in sets]
        mask = (torch.arange(hi, device=dev)[None, :]
                < lens[:, None])[:, None, None, :]
        q4 = q[:, :, None, :]
        sdpa = lambda i: F.scaled_dot_product_attention(  # noqa: E731
            q4, *views[i], attn_mask=mask, enable_gqa=True)
        run = lambda i: ops.flash_decode(q, *sets[i], lens)  # noqa: E731
        kv_rows = sum(lengths)
        out[f"flash_decode {name}"] = dict(
            max_abs_err=err, ok=ok, ms=time_ms(run, n_sets),
            device_ms=time_ms(run, n_sets, spin=True),
            plain_ms=time_ms(lambda i: ref.flash_decode(q, *sets[i], lens),
                             n_sets, iters=10),
            library_ms=time_ms(sdpa, n_sets),
            library_device_ms=time_ms(sdpa, n_sets, spin=True),
            bytes=2 * q.numel() * esize + 2 * kv_rows * kvh * d * esize
            + 4 * b,
            ops=4 * kv_rows * h * d,
            shape=f"b={b} h={h} kvh={kvh} d={d} max_len={hi} contexts "
                  f"{lengths[0]}..{lengths[-1]} (sum {kv_rows})")
        del sets, views
    for name, (b, sq, h, kvh, d) in ENCDEC_SCORING.items():
        sets = [(rnd(b, sq, h, d), rnd(b, sq, kvh, d), rnd(b, sq, kvh, d))
                for _ in range(4)]
        ok, err = ref.compare(ops.flash_attention(*sets[0]),
                              ref.flash_attention(*sets[0]))
        views = [tuple(t.transpose(1, 2).contiguous() for t in st)
                 for st in sets]
        sdpa = lambda i: F.scaled_dot_product_attention(  # noqa: E731
            *views[i], is_causal=True, enable_gqa=True)
        run = lambda i: ops.flash_attention(*sets[i])  # noqa: E731
        q, k = sets[0][:2]
        out[f"flash_attention {name}"] = dict(
            max_abs_err=err, ok=ok, ms=time_ms(run, 4),
            device_ms=time_ms(run, 4, spin=True),
            plain_ms=time_ms(lambda i: ref.flash_attention(*sets[i]), 4,
                             iters=4),
            library_ms=time_ms(sdpa, 4),
            library_device_ms=time_ms(sdpa, 4, spin=True),
            bytes=esize * (2 * q.numel() + 2 * k.numel()),
            ops=4 * b * h * d * sq * (sq + 1) // 2,
            shape=f"b={b} sq=skv={sq} h={h} kvh={kvh} d={d} causal")
        del sets, views
    for key, r in out.items():
        r["bound_ms"], r["bound_by"] = bound(r["bytes"], r["ops"], dtype)
        log(f"  {key} [{r['shape']}, bf16]: kernel {r['ms']:.4f} ms at the "
            f"host's pace, device time {r['device_ms']:.4f} ms "
            f"({100 * r['bound_ms'] / r['device_ms']:.1f} % of its bound), "
            f"plain {r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms, "
            f"device time {r['library_device_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}: "
            f"{r['bytes'] / 1e6:.2f} MB, {r['ops'] / 1e9:.3f} GFLOP), "
            f"max_abs_err {r['max_abs_err']:.3e} "
            f"{'ok' if r['ok'] else 'FAIL'}")
    return out


def encdec_logits(params, cfg, T, dev, prompt, frontend):
    """fp32 logits, with the frontend, of the cache-less forward of
    ``prompt`` at use_flash (``flash_attention``) and of the decode step
    of its last token after a cached prefill of the rest
    (``flash_decode``), one position shared by the cache's rows as in
    greedy_generate."""
    toks = torch.from_numpy(prompt.astype(np.int64)).to(dev)[None]
    caches = T.init_caches(cfg, 1, len(prompt), device=dev)
    with torch.no_grad():
        whole, _ = T.forward(params, dataclasses.replace(cfg, use_flash=True),
                             toks, frontend_embeds=frontend)
        _, caches = T.forward(params, cfg, toks[:, :-1], caches=caches,
                              frontend_embeds=frontend)
        step, _ = T.forward(params, cfg, toks[:, -1:], caches=caches,
                            frontend_embeds=frontend)
    return whole[0].float(), step[0, 0].float()


def encdec_paths(ops, ref) -> dict:
    """The plain versions of both kernels, and one planted fault each:
    the decode given ``lengths - 1`` (the newest key dropped), the
    full-sequence kernel's causal offset one key late."""
    return dict(plain=dict(flash_decode=ref.flash_decode,
                           flash_attention=ref.flash_attention),
                **flash_paths(ops),
                **{"decode fault": dict(flash_decode=lambda q, k, v, n:
                                        ops.flash_decode(q, k, v, n - 1))})


def run_encdec_model(name, spec, dev, ops, ref, configs, T, engine) -> dict:
    """One phase-22 model: greedy_generate with seeded frontends (a
    warm-up call, then the timed one), the decode launches it implies,
    then the fp32 and bf16 logits of the kernel path against the plain
    path with the planted faults, at ``check_depth`` layers."""
    cfg, params = init_model(name, configs, T, dev, n_layers=spec["depth"])
    nonzero_leaves(params, seed=22)
    b, n_new = spec["b"], spec["new"]
    gen = torch.Generator(device=dev).manual_seed(23)
    frontend = torch.randn(b, cfg.n_frontend_tokens, cfg.d_model,
                           generator=gen, device=dev).to(cfg.dtype)
    prompts = make_requests(cfg.vocab, b, lo=spec["prompt"],
                            hi=spec["prompt"])
    tokens = torch.from_numpy(np.stack(prompts).astype(np.int64)).to(dev)
    engine.greedy_generate(params, cfg, tokens, 2, frontend_embeds=frontend)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    ids = engine.greedy_generate(params, cfg, tokens, n_new,
                                 frontend_embeds=frontend)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    n_attn = T.n_attention_layers(cfg)
    want = dict(dict.fromkeys(launches, 0), flash_decode=n_attn * (n_new - 1))
    row = dict(tok_s=b * n_new / wall, wall_s=wall,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches=launches["flash_decode"],
               active=T.active_param_count(cfg))
    log(f"  {name}: greedy_generate of {b} x {spec['prompt']} tokens with "
        f"{cfg.n_frontend_tokens} frontend tokens each, {n_new} new: "
        f"{wall:.3f} s ({row['tok_s']:.1f} tok/s, prefill included), "
        f"max_memory_allocated {row['peak_gib']:.2f} GiB; launches "
        f"{ {k: v for k, v in launches.items() if v} } = {n_attn} attention "
        f"layers x {n_new - 1} decode steps")
    if launches != want:
        raise RuntimeError(f"{name}: launches {launches}, want {want}")
    if tuple(ids.shape) != (b, n_new) or not (
            0 <= int(ids.min()) and int(ids.max()) < cfg.vocab):
        raise RuntimeError(f"{name}: ids of shape {tuple(ids.shape)} in "
                           f"[{int(ids.min())}, {int(ids.max())}]")
    if cfg.encoder is not None:
        with torch.no_grad():
            T.encode(params, cfg, frontend)
            torch.cuda.synchronize()
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                T.encode(params, cfg, frontend)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        row["encode_ms"] = 1e3 * sorted(times)[1]
        log(f"  {name}: encode over {b} x {cfg.n_frontend_tokens} frames "
            f"({cfg.encoder.n_layers} layers, plain sdpa) "
            f"{row['encode_ms']:.2f} ms (median of 3)")

    depth = spec["check_depth"] or cfg.n_layers
    cut = dict(params, blocks=params["blocks"][:depth])
    b16cfg = dataclasses.replace(cfg, n_layers=depth)
    f32cfg = dataclasses.replace(b16cfg, compute_dtype="float32")
    prompt = make_requests(cfg.vocab, 1, lo=ENCDEC_CHECK_PROMPT,
                           hi=ENCDEC_CHECK_PROMPT)[0]
    fe1 = frontend[:1]
    fe2 = torch.randn(fe1.shape, generator=gen, device=dev).to(cfg.dtype)
    paths = encdec_paths(ops, ref)
    f32 = compare_paths(lambda: encdec_logits(cut, f32cfg, T, dev, prompt,
                                              fe1), paths, ops)
    b16 = compare_paths(lambda: encdec_logits(cut, b16cfg, T, dev, prompt,
                                              fe1), paths, ops)
    label = f"{name} first {depth} layers"
    failed = check_logits(
        f32, b16, [(0, f"{ENCDEC_CHECK_PROMPT}-token cache-less forward",
                    "flash fault"), (1, "decode step", "decode fault")],
        label)
    row["fp32_logit_diff"] = max(max_diff(f32["kernel"][i],
                                          f32["plain"][i]) for i in (0, 1))
    other = encdec_logits(cut, f32cfg, T, dev, prompt, fe2)
    moved = max(max_diff(a, c) for a, c in zip(f32["kernel"], other))
    log(f"  {label} fp32: another frontend moves the logits by {moved:.3e}")
    # whisper's pattern reads no frontend (its encoder feeds no layer);
    # vision's cross layers must.
    if ("cross" in cfg.pattern) == (moved == 0.0):
        failed.append(f"{name}: the logits move by {moved} with another "
                      f"frontend")
    del f32, b16, cut, params, other
    torch.cuda.empty_cache()
    if failed:
        raise RuntimeError("; ".join(failed))
    return row


def run_encdec_training(ops, configs, T) -> dict:
    """whisper-medium trained through the launcher with the frontend stub
    (batch 2 x 448, 10 steps, fp32 masters, bf16 compute); every step's
    loss finite and the last below the first, no kernel launched."""
    from repro_torch.launch import train as train_launch

    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        run = train_launch.main(WHISPER_TRAIN_ARGS + ["--ckpt", tmp])
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    losses = [m["loss"] for m in run["metrics"]]
    step_s = sorted(m["dt"] for m in run["metrics"])[len(losses) // 2]
    out = dict(step_ms=1e3 * step_s, tokens_per_s=2 * 448 / step_s,
               peak_gib=peak, losses=losses, wall_s=wall,
               params_B=T.tree_param_count(run["state"]["params"]) / 1e9)
    log(f"  whisper-medium training ({out['params_B']:.4f} B parameters, "
        f"fp32 masters, bf16 compute), batch 2 x 448 with the frontend "
        f"stub: losses {[round(x, 4) for x in losses]}; step "
        f"{out['step_ms']:.1f} ms (median), {out['tokens_per_s']:.0f} "
        f"tokens/s; max_memory_allocated {peak:.2f} GiB; {wall:.1f} s with "
        f"its checkpoint; launches {launches}")
    failed = []
    if len(losses) != 10 or not all(math.isfinite(x) for x in losses):
        failed.append(f"whisper-medium losses {losses}")
    elif not losses[-1] < losses[0]:
        failed.append(f"whisper-medium loss did not fall: {losses}")
    if launches:
        failed.append(f"training launched a kernel: {launches}")
    if failed:
        raise RuntimeError("; ".join(failed))
    return {k: out[k] for k in ("step_ms", "tokens_per_s", "peak_gib")}


def run_encdec(dev, ops, ref, configs, T, engine) -> dict:
    """Phase 22: the kernels at both models' shapes, each model served
    and checked (one on the card at a time), whisper trained."""
    summary = {"kernels": time_encdec_shapes(dev, ops, ref)}
    if not all(r["ok"] for r in summary["kernels"].values()):
        raise RuntimeError("a phase-22 kernel disagrees with its plain "
                           "version")
    torch.cuda.empty_cache()
    for name, spec in ENCDEC.items():
        t0 = time.perf_counter()
        summary[name] = run_encdec_model(name, spec, dev, ops, ref, configs,
                                         T, engine)
        torch.cuda.empty_cache()
        summary[name]["seconds"] = time.perf_counter() - t0
        log(f"  {name}: {summary[name]['seconds']:.1f} s in all")
    for key in ("whisper-medium", "llama-3.2-vision-90b"):
        summary["kernels"][f"flash_decode {key}"]["launches"] = \
            summary[key]["launches"]
    summary["whisper-medium training"] = run_encdec_training(ops, configs, T)
    torch.cuda.empty_cache()
    return summary


# ----------------------------------------------------------------------------
# Phase 23: tensor-parallel serving over two ranks, and every family trains
# ----------------------------------------------------------------------------

def time_gathered_decode(dev, ops, ref, lengths, shape=None,
                         seed: int = 23) -> dict:
    """``flash_decode`` at the shape a rank's decode step hands it under
    phase 23's two-rank mesh: TP_B slots over the gathered view of
    TP_MAX_LEN rows, the rank's 16 of qwen3-4b's 32 q heads over its 4 of
    8 kv heads of 80, contexts ``lengths`` (or ``shape``, (b, h, kvh, d,
    rows), another model's); checked and timed in fp32 and bf16 beside
    its plain version, SDPA and the bound."""
    b, h, kvh, d, rows = shape or (TP_B, H // TP, KVH // TP, D, TP_MAX_LEN)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for dtype, esize in ((torch.float32, 4), (torch.bfloat16, 2)):
        rnd = lambda *s: torch.randn(*s, generator=gen, device=dev).to(dtype)  # noqa: E731
        sets = [(rnd(b, rows, kvh, d), rnd(b, rows, kvh, d))
                for _ in range(8)]
        q = rnd(b, h, d)
        ok, err = ref.compare(ops.flash_decode(q, *sets[0], lens),
                              ref.flash_decode(q, *sets[0], lens))
        views = [tuple(t.transpose(1, 2).contiguous() for t in kv)
                 for kv in sets]
        mask = (torch.arange(rows, device=dev)[None, :]
                < lens[:, None])[:, None, None, :]
        q4 = q[:, :, None, :]
        sdpa = lambda i: F.scaled_dot_product_attention(  # noqa: E731
            q4, *views[i], attn_mask=mask, enable_gqa=True)
        run = lambda i: ops.flash_decode(q, *sets[i], lens)  # noqa: E731
        kv_rows = sum(lengths)
        r = dict(max_abs_err=err, ok=ok, ms=time_ms(run, 8),
                 device_ms=time_ms(run, 8, spin=True),
                 plain_ms=time_ms(lambda i: ref.flash_decode(q, *sets[i],
                                                             lens), 8,
                                  iters=10),
                 library_ms=time_ms(sdpa, 8),
                 library_device_ms=time_ms(sdpa, 8, spin=True),
                 bytes=2 * q.numel() * esize + 2 * kv_rows * kvh * d * esize
                 + 4 * b, ops=4 * kv_rows * h * d)
        r["bound_ms"], r["bound_by"] = bound(r["bytes"], r["ops"], dtype)
        name = "fp32" if dtype == torch.float32 else "bf16"
        log(f"  flash_decode at the gathered shape [b={b} h={h} kvh={kvh} "
            f"d={d} rows={rows} contexts {lengths}, {name}]: kernel "
            f"{r['ms']:.4f} ms at the host's pace, device time "
            f"{r['device_ms']:.4f} ms ({100 * r['bound_ms'] / r['device_ms']:.1f}"
            f" % of its bound), plain {r['plain_ms']:.4f} ms, SDPA "
            f"{r['library_ms']:.4f} ms, device time "
            f"{r['library_device_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}: {r['bytes'] / 1e6:.3f} MB, "
            f"{r['ops'] / 1e9:.4f} GFLOP), max_abs_err {err:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        out[name] = r
        del sets, views
    return out


def tp_rank(rank: int, world: int, prompts) -> dict:
    """Phase 23 (a) on one rank of the group (``launch.mesh.run_ranks``
    spawned it and joined it to the gloo group): the fp32 logits of a
    prefill and a decode step on the two-rank mesh (rank 0 also computes
    them on one rank), every ``flash_decode`` of that decode step held to
    its plain version, the engine over ``prompts`` in fp32 then bf16, and
    the gloo collectives' bandwidth curves. Returns plain values."""
    from repro_torch import configs
    from repro_torch.core import collectives
    from repro_torch.dist import sharding
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import transformer as T
    from repro_torch.serve import dist as serve_dist
    from repro_torch.serve import paged
    from repro_torch.serve.engine import Request, ServeConfig, ServingEngine

    dev = mesh_lib.rank_device(rank, "cuda")
    torch.cuda.set_device(dev)
    mesh = mesh_lib.make_serving_mesh(world)
    rules = serve_dist.serve_ruleset(mesh)
    cfg = configs.get_config("qwen3-4b")
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    out = {"rank": rank}

    # Logits: the check's table spans both ranks (least-loaded placement).
    n_pages = 1 + TP_B * TP_MAX_LEN // TP_PS
    n_pages += -n_pages % world
    pool = paged.PageAllocator(n_pages, TP_PS, n_devices=world)
    table = np.zeros((TP_B, TP_MAX_LEN // TP_PS), np.int32)
    for i in range(TP_B):
        got = pool.alloc(i, paged.pages_for(TP_CHECK_PROMPT + 1, TP_PS))
        table[i, :len(got)] = got
    out["check_spans"] = [sorted({pool.device_of(p)
                                  for p in pool.slot_pages[i]})
                          for i in range(TP_B)]
    toks = torch.from_numpy(np.random.RandomState(23).randint(
        2, cfg.vocab, size=(TP_B, TP_CHECK_PROMPT + 1))).to(dev)

    def fresh():
        caches = T.init_paged_caches(f32, TP_B, TP_MAX_LEN, TP_PS, n_pages,
                                     device=dev)
        caches[0]["pages"].copy_(torch.from_numpy(table))
        return caches

    def logits(p, caches, rs):
        with torch.no_grad(), sharding.use_ruleset(rs):
            pre, caches = T.forward(p, f32, toks[:, :-1], caches=caches)
            step, _ = T.forward(p, f32, toks[:, -1:], caches=caches)
        return pre.float(), step[:, -1].float()

    real_decode = ops.flash_decode
    seen = []

    def checked(q, k, v, lengths):
        got = real_decode(q, k, v, lengths)
        ok, err = ref.compare(got, ref.flash_decode(q, k, v, lengths))
        seen.append((list(q.shape), list(k.shape), ok, err))
        return got

    shard = serve_dist.shard_params(params, mesh, rules)
    ops.reset_launches()
    ops.flash_decode = checked
    try:
        tp_pre, tp_step = logits(shard, serve_dist.shard_caches(fresh(), mesh),
                                 rules)
    finally:
        ops.flash_decode = real_decode
    out["check_decode"] = seen
    out["check_launches"] = ops.LAUNCHES["flash_decode"]
    del shard
    if rank == 0:
        one_pre, one_step = logits(params, fresh(), None)
        out["logit_diff"] = (float((tp_pre - one_pre).abs().max()),
                             float((tp_step - one_step).abs().max()))
        out["logit_scale"] = float(one_pre.abs().max())
        del one_pre, one_step
    del tp_pre, tp_step
    torch.cuda.empty_cache()

    # The engine, fp32 compute then bf16; the gather a decode step makes.
    gathered = []
    real_gather = serve_dist.gather_pages

    def counting(kp, vp, pages, mesh_, axis):
        if pages.shape[0] == TP_B:       # a decode step's (a chunk's is 1)
            gathered.append(2 * pages.numel() * kp[0].numel()
                            * kp.element_size())
        return real_gather(kp, vp, pages, mesh_, axis)

    scfg = ServeConfig(max_len=TP_MAX_LEN, batch=TP_B, paged=True,
                       page_size=TP_PS, chunk_size=TP_CHUNK, eos_id=-1)
    serve_dist.gather_pages = counting
    try:
        for label, c in (("fp32", f32), ("bf16", cfg)):
            torch.cuda.reset_peak_memory_stats(dev)
            eng = ServingEngine(params, c, scfg, device=dev, capture=False,
                                mesh=mesh)
            for rid, p in enumerate(prompts):
                eng.submit(Request(rid=rid, prompt=p.copy(), max_new=TP_NEW))
            spans = {}
            gathered.clear()
            torch.cuda.synchronize(dev)
            ops.reset_launches()
            t0 = time.perf_counter()
            while eng.queue or any(s is not None for s in eng.slots):
                eng.tick()
                for rid, pg in eng.pool.slot_pages.items():
                    spans.setdefault(rid, set()).update(
                        eng.pool.device_of(x) for x in pg)
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
            out[label] = dict(
                streams={k: list(v) for k, v in eng.finished.items()},
                wall=wall, tok_s=TP_B * TP_NEW / wall,
                launches={k: v for k, v in ops.LAUNCHES.items() if v},
                spans={k: sorted(v) for k, v in spans.items()},
                decode_steps=eng.decode_steps, ticks=eng.ticks,
                decode_traces=eng.decode_traces,
                local_pages=int(eng.caches[0]["kp"].shape[0]),
                n_pages=eng.pool.n_pages, graphed=eng.graphed,
                peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
                gather_bytes_per_step=sum(gathered) / max(1,
                                                          eng.decode_steps))
            del eng
    finally:
        serve_dist.gather_pages = real_gather
    del params
    torch.cuda.empty_cache()

    out["curves"] = {
        kind: [(r.payload_bytes, r.wire_bytes, r.measured_time_s,
                r.measured_gbs, r.modeled_time_s)
               for r in collectives.bandwidth_curve(
                   mesh, kind, "model", TP_SIZES, dtype=torch.bfloat16,
                   device=dev, repeats=3)]
        for kind in ("all_reduce", "broadcast")}
    return out


def near_tie(params, cfg, T, dev, prompt, prefix, a: int, b: int) -> float:
    """|logit(a) - logit(b)| at the next position after ``prompt`` and the
    agreed ``prefix`` of a stream, one rank, fp32 compute, cache-less."""
    toks = torch.tensor(np.concatenate([prompt, np.asarray(prefix, np.int64)
                                        ]), device=dev)[None]
    with torch.no_grad():
        logits, _ = T.forward(params, cfg, toks)
    last = logits[0, -1].float()
    return float((last[a] - last[b]).abs())


def run_tp(dev, ops, ref, configs, T) -> dict:
    """Phase 23 (a): the gathered-shape kernel timed; the one-rank engine
    served eager here; the two ranks spawned and checked; the launcher at
    ``--tp 2``."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import serve as serve_launch
    from repro_torch.serve.engine import ServeConfig

    qcfg = configs.get_config("qwen3-4b")
    prompts = make_requests(qcfg.vocab, TP_B, lo=TP_LO, hi=TP_HI)
    log(f"  prompt lengths {[len(p) for p in prompts]}, {TP_NEW} new each, "
        f"max_len {TP_MAX_LEN}, pages of {TP_PS}, chunks of {TP_CHUNK}")
    summary = {"kernel": time_gathered_decode(
        dev, ops, ref, [len(p) + TP_NEW // 2 for p in prompts])}
    cfg, params = init_model("qwen3-4b", configs, T, dev)
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    scfg = ServeConfig(max_len=TP_MAX_LEN, batch=TP_B, paged=True,
                       page_size=TP_PS, chunk_size=TP_CHUNK, eos_id=-1)
    one = {}
    for label, c in (("fp32", f32), ("bf16", cfg)):
        eng, fin, wall, launches = serve(params, c, scfg, prompts, TP_NEW,
                                         dev, ops, capture=False)
        check_served(eng, fin, prompts, TP_NEW, cfg.vocab)
        one[label] = dict(streams={k: list(v) for k, v in fin.items()},
                          tok_s=TP_B * TP_NEW / wall, wall=wall)
        del eng
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = mesh_lib.run_ranks(tp_rank, TP, args=(prompts,),
                               deadline_s=TP_DEADLINE_S,
                               timeout_s=TP_TIMEOUT_S, threads=1)
    summary["ranks_s"] = time.perf_counter() - t0
    r0 = ranks[0]
    failed = []
    pre, step = r0["logit_diff"]
    log(f"  two ranks against one, fp32 compute (bf16 weights), "
        f"{TP_B} slots: {TP_CHECK_PROMPT}-row prefill max |logit diff| "
        f"{pre:.3e}, decode step {step:.3e} (limit {FP32_LOGIT_TOL:g}; max "
        f"|logit| {r0['logit_scale']:.3f}); the check's pages a slot on "
        f"ranks {r0['check_spans']}")
    if not (pre <= FP32_LOGIT_TOL and step <= FP32_LOGIT_TOL):
        failed.append(f"two-rank fp32 logits differ from one rank's: "
                      f"{pre:.3e} {step:.3e}")
    want_shape = [[TP_B, H // TP, D], [TP_B, TP_MAX_LEN, KVH // TP, D]]
    for r in ranks:
        seen = r["check_decode"]
        errs = [e for _, _, _, e in seen]
        log(f"  rank {r['rank']}: flash_decode launched {r['check_launches']}"
            f" times in the decode step, shapes "
            f"{sorted({str(s[:2]) for s in seen})}, max_abs_err against its "
            f"plain version {max(errs) if errs else float('nan'):.3e}")
        if len(seen) != cfg.n_layers or r["check_launches"] != cfg.n_layers \
                or not all(ok for _, _, ok, _ in seen) \
                or any(list(s[:2]) != want_shape for s in seen):
            failed.append(f"rank {r['rank']}: flash_decode at the gathered "
                          f"shape: {seen[:2]} ... ({len(seen)} calls)")
    for label in ("fp32", "bf16"):
        runs = [r[label] for r in ranks]
        a = runs[0]
        span_both = [rid for rid, devs in a["spans"].items()
                     if len(devs) == TP]
        log(f"  {label}: two ranks {a['tok_s']:.2f} tok/s eager ({a['wall']:.2f}"
            f" s, {a['ticks']} ticks, {a['decode_steps']} decode steps; "
            f"rank 1 {runs[1]['tok_s']:.2f}) against one rank "
            f"{one[label]['tok_s']:.2f} tok/s eager; peak memory a rank "
            f"{[round(r['peak_gib'], 2) for r in runs]} GiB; pages a rank "
            f"{[r['local_pages'] for r in runs]} of {a['n_pages']}; slots "
            f"spanning both ranks {span_both}; gather_pages per decode step "
            f"{a['gather_bytes_per_step'] / 1e6:.2f} MB "
            f"({a['gather_bytes_per_step'] / cfg.n_layers / 1e6:.3f} MB a "
            f"layer); launches a rank {[r['launches'] for r in runs]}")
        if any(r["streams"] != a["streams"] for r in runs):
            failed.append(f"{label}: the ranks' streams differ")
        if not span_both:
            failed.append(f"{label}: no slot's pages spanned both ranks")
        if any(2 * r["local_pages"] != a["n_pages"] for r in runs):
            failed.append(f"{label}: a rank does not hold n_pages / 2")
        if a["graphed"] or a["decode_traces"] != 1:
            failed.append(f"{label}: graphed {a['graphed']}, decode_traces "
                          f"{a['decode_traces']}")
        for r in runs:
            want = cfg.n_layers * r["decode_steps"]
            if r["launches"].get("flash_decode") != want or set(
                    r["launches"]) != {"flash_decode"}:
                failed.append(f"{label} rank {runs.index(r)}: launches "
                              f"{r['launches']}, want flash_decode {want}")
        diffs = [(rid, next((j for j, (x, y) in enumerate(zip(
            one[label]["streams"][rid], a["streams"][rid])) if x != y),
            None)) for rid in sorted(a["streams"])]
        diffs = [(rid, j) for rid, j in diffs if j is not None]
        agree = sum(x == y for rid in a["streams"]
                    for x, y in zip(a["streams"][rid],
                                    one[label]["streams"][rid]))
        log(f"  {label} greedy streams: {agree}/{TP_B * TP_NEW} tokens equal "
            f"to one rank's; first differences (request, position) {diffs}")
        if label == "fp32":
            for rid, j in diffs:
                x = one[label]["streams"][rid][j]
                y = a["streams"][rid][j]
                gap = near_tie(params, f32, T, dev, prompts[rid],
                               one[label]["streams"][rid][:j], x, y)
                log(f"    request {rid} position {j}: one rank {x}, two "
                    f"ranks {y}, one-rank fp32 logit gap {gap:.3e} "
                    f"(near-tie limit {NEAR_TIE:g})")
                if not gap <= NEAR_TIE:
                    failed.append(f"fp32 stream {rid} differs at {j} away "
                                  f"from a near-tie ({gap:.3e})")
    summary["tok_s"] = {k: (ranks[0][k]["tok_s"], one[k]["tok_s"])
                        for k in ("fp32", "bf16")}
    summary["peak_gib"] = [r["bf16"]["peak_gib"] for r in ranks]
    summary["launches_per_rank"] = [r["fp32"]["launches"] for r in ranks]
    summary["gather_mb_per_layer"] = \
        ranks[0]["fp32"]["gather_bytes_per_step"] / cfg.n_layers / 1e6
    del params
    torch.cuda.empty_cache()
    for kind, rows in r0["curves"].items():
        log(f"  core.collectives.bandwidth_curve {kind}, bf16 over the gloo "
            f"group of {TP} ranks on one card (gloo through the host, not "
            f"NVLink): " + ", ".join(
                f"{p / 2**10:.0f} KiB {t * 1e3:.3f} ms {g:.3f} GB/s "
                f"(NVLink4 model {m * 1e3:.4f} ms)"
                for p, _, t, g, m in rows))
    summary["curves"] = {k: [(p, t) for p, _, t, _, _ in v]
                         for k, v in r0["curves"].items()}
    t0 = time.perf_counter()
    finished = serve_launch.main(
        ["--arch", "qwen3-4b", "--paged", "--tp", str(TP), "--max-len",
         str(TP_MAX_LEN), "--page-size", str(TP_PS), "--chunk-size",
         str(TP_CHUNK), "--requests", str(TP_B), "--max-new", "4"])
    summary["launcher_s"] = time.perf_counter() - t0
    log(f"  launch/serve.py --tp {TP}: {len(finished)} requests of 4 new "
        f"tokens served in {summary['launcher_s']:.1f} s with its spawn")
    if sorted(finished) != list(range(TP_B)) or any(
            len(v) != 4 for v in finished.values()):
        failed.append(f"the --tp launcher served {finished}")
    if failed:
        raise RuntimeError("; ".join(failed))
    return summary


def run_train_families(dev, ops, configs, T, steps) -> dict:
    """Phase 23 (b): a step's loss and gradients on the card against the
    CPU's for each of GRAD_CHECK (fp32 compute; float64 for GRAD_F64,
    then fp32 logged), then mamba2-370m whole
    trained MAMBA_STEPS steps (fp32 masters, AdamW, bf16 compute) through
    the plain chunked scan, and the MoE memory reckoning logged."""
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.optim import schedule
    from repro_torch.tree import tree_leaves, tree_map

    out, failed = {}, []
    for arch, (smoke, b, s) in GRAD_CHECK.items():
        base = configs.get_smoke(arch) if smoke else configs.get_config(arch)
        params = steps.init_state(base, seed=0, device=dev).params
        tokens, labels = SyntheticLMData(DataConfig(
            vocab=base.vocab, seq_len=s, global_batch=b)).batch_at(0)
        # The gated run first: float64 where fp32 is ill-conditioned
        # (GRAD_F64), whose fp32 reading follows, logged only.
        computes = ("float64", "float32") if arch in GRAD_F64 \
            else ("float32",)
        for compute in computes:
            cfg = dataclasses.replace(base, compute_dtype=compute)

            def grads(device, threads=None):
                if threads is not None:
                    torch.set_num_threads(threads)
                tracked = tree_map(lambda x: x.detach().to(device)
                                   .requires_grad_(), params)
                batch = {"tokens": torch.from_numpy(tokens).to(device),
                         "labels": torch.from_numpy(labels).to(device)}
                loss, parts = steps.loss_fn(tracked, cfg, batch)
                leaves = tree_leaves(tracked)
                gs = torch.autograd.grad(loss, leaves, allow_unused=True)
                return float(loss.detach()), float(parts["aux"]), [
                    (torch.zeros_like(p) if g is None else g).detach().cpu()
                    for g, p in zip(gs, leaves)]

            def worst(a, b):
                return max(float((x - y).abs().max())
                           / max(float(y.abs().max()), 1e-30)
                           for x, y in zip(a, b))

            ops.reset_launches()
            t0 = time.perf_counter()
            gl, ga, gg = grads(dev)
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t0
            launches = {k: v for k, v in ops.LAUNCHES.items() if v}
            threads = torch.get_num_threads()
            t0 = time.perf_counter()
            cl, ca, cg = grads("cpu")
            cpu_s = time.perf_counter() - t0
            card = worst(gg, cg)
            gated = compute == computes[0]
            if gated:
                verdict = f"(limit GRAD_TOL {GRAD_TOL:g})"
            else:
                _, _, c1 = grads("cpu", threads=1)
                torch.set_num_threads(threads)
                verdict = (f"(logged only: the CPU at 1 thread against "
                           f"{threads} {worst(c1, cg):.3e})")
                del c1
            log(f"  {cfg.name} ({T.tree_param_count(params) / 1e9:.4f} B "
                f"parameters, {compute} compute, fp32 masters), batch {b} x "
                f"{s}: loss card {gl:.6f} CPU {cl:.6f}, aux card {ga:.6f} "
                f"CPU {ca:.6f}; gradients, worst leaf's |diff| / its max "
                f"|CPU grad| over {len(gg)} leaves: card against the CPU "
                f"{card:.3e} {verdict}; {card_s:.2f} s on the card, "
                f"{cpu_s:.2f} s on the CPU; launches {launches}")
            if gated and not (abs(gl - cl) <= 1e-4 * abs(cl)
                              and card <= GRAD_TOL):
                failed.append(f"{cfg.name} ({compute}): card and CPU "
                              f"gradients differ ({card:.3e}, limit "
                              f"{GRAD_TOL:g})")
            if launches:
                failed.append(f"{cfg.name}: training launched {launches}")
            out[f"{cfg.name} {compute}"] = card
            del gg, cg
        del params
        torch.cuda.empty_cache()

    cfg = configs.get_config("mamba2-370m")
    sched = schedule.ScheduleConfig(warmup_steps=MAMBA_STEPS,
                                    total_steps=MAMBA_STEPS)
    state = steps.init_state(cfg, seed=0, device=dev).tree()
    state_gb = sum(t.numel() * t.element_size()
                   for t in tree_leaves(state)) / 1e9
    step = steps.make_train_step(cfg, sched=sched)
    data = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=MAMBA_SEQ,
                                      global_batch=MAMBA_BATCH))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    losses, times = [], []
    for i in range(MAMBA_STEPS):
        tokens, labels = data.batch_at(i)
        batch = {"tokens": torch.from_numpy(tokens).to(dev),
                 "labels": torch.from_numpy(labels).to(dev)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        times.append(time.perf_counter() - t0)
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    step_s = sorted(times[1:])[len(times[1:]) // 2]
    out["mamba2-370m"] = dict(
        losses=losses, step_ms=1e3 * step_s, state_gb=state_gb,
        tokens_per_s=MAMBA_BATCH * MAMBA_SEQ / step_s,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    n_params = T.tree_param_count(state["params"])
    log(f"  mamba2-370m whole ({n_params / 1e9:.4f} B "
        f"parameters; fp32 masters and both AdamW moments {state_gb:.2f} GB;"
        f" bf16 compute, the plain chunked scan in fp32), batch "
        f"{MAMBA_BATCH} x {MAMBA_SEQ}: losses {[round(x, 4) for x in losses]}"
        f"; step {1e3 * step_s:.1f} ms (median of steps 2..), "
        f"{MAMBA_BATCH * MAMBA_SEQ / step_s:.0f} tokens/s; "
        f"max_memory_allocated {out['mamba2-370m']['peak_gib']:.2f} GiB; "
        f"launches {launches}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        failed.append(f"mamba2-370m loss did not fall: {losses}")
    if launches:
        failed.append(f"mamba2-370m training launched {launches}")
    del state
    torch.cuda.empty_cache()
    dbrx = configs.get_config("dbrx-132b")
    one = T.param_count(dataclasses.replace(dbrx, n_layers=1))
    experts = dbrx.n_experts * 3 * dbrx.d_model * dbrx.d_ff
    log(f"  full-width MoE training does not fit one 80 GB card: dbrx-132b "
        f"cut to one layer holds {one / 1e9:.2f} B parameters "
        f"({experts / 1e9:.2f} B of them experts); fp32 masters, gradients "
        f"and both AdamW moments at 16 bytes a parameter: "
        f"{16 * one / 1e9:.1f} GB before activations (FSDP, phase 24, "
        f"shards them over ranks, but ranks on one card share its memory)")
    if failed:
        raise RuntimeError("; ".join(failed))
    return out

# ----------------------------------------------------------------------------
# Phase 24: training over ranks
# ----------------------------------------------------------------------------

def time_gpipe_flash(dev, ops, ref) -> dict:
    """``flash_attention`` at a GPipe stage's shape in phase 24 (one
    microbatch of qwen2-0.5b: b 1, s DIST_S, 14/2 heads of 64, causal,
    fp32) against its plain version, timed beside SDPA and the bound."""
    from repro_torch import configs

    cfg = configs.get_config(DIST_ARCH)
    h, kvh, d, s = cfg.n_heads, cfg.n_kv_heads, cfg.dhead, DIST_S
    dtype = torch.float32
    gen = torch.Generator(device=dev).manual_seed(24)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=dev)  # noqa: E731
    n_sets = 8
    sets = [(rnd(1, s, h, d), rnd(1, s, kvh, d), rnd(1, s, kvh, d))
            for _ in range(n_sets)]
    ok, err = ref.compare(ops.flash_attention(*sets[0]),
                          ref.flash_attention(*sets[0]))
    views = [tuple(t.transpose(1, 2).contiguous() for t in x) for x in sets]
    pairs = s * (s + 1) // 2
    sdpa = lambda i: F.scaled_dot_product_attention(  # noqa: E731
        *views[i], is_causal=True, enable_gqa=True)
    run = lambda i: ops.flash_attention(*sets[i])  # noqa: E731
    r = dict(max_abs_err=err, ok=ok, ms=time_ms(run, n_sets),
             device_ms=time_ms(run, n_sets, spin=True),
             plain_ms=time_ms(lambda i: ref.flash_attention(*sets[i]),
                              n_sets, iters=10),
             library_ms=time_ms(sdpa, n_sets),
             library_device_ms=time_ms(sdpa, n_sets, spin=True),
             bytes=4 * (2 * sets[0][0].numel() + 2 * sets[0][1].numel()),
             ops=4 * h * d * pairs)
    r["bound_ms"], r["bound_by"] = bound(r["bytes"], r["ops"], dtype)
    log(f"  flash_attention at a GPipe stage's shape [b=1 sq=skv={s} h={h} "
        f"kvh={kvh} d={d} causal, fp32]: kernel {r['ms']:.4f} ms at the "
        f"host's pace, device time {r['device_ms']:.4f} ms "
        f"({100 * r['bound_ms'] / r['device_ms']:.1f} % of its bound), "
        f"plain {r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms, "
        f"device time {r['library_device_ms']:.4f} ms, bound "
        f"{r['bound_ms']:.4f} ms ({r['bound_by']}: {r['bytes'] / 1e6:.2f} "
        f"MB, {r['ops'] / 1e9:.3f} GFLOP), max_abs_err {err:.3e} "
        f"{'ok' if ok else 'FAIL'}")
    return r


def dist_train_rank(rank: int, world: int, spec: dict) -> dict:
    """Phase 24 on one rank of the group (``launch.mesh.run_ranks``
    spawned it): rank 0 first takes the one-rank steps; then each mesh of
    DIST_MESHES (its first gradient gathered whole against one rank's,
    the planted skipped mean under FSDP, DIST_STEPS steps, the step-2
    checkpoint under FSDP), the resume on (1, 2), one bf16 step under
    FSDP, and GPipe against the sequential stack on rank 0. ``spec``:
    arch, smoke, device, batch, seq, steps, ckpt (the checkpoint
    directory). Returns plain values."""
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.dist import pipeline, sharding
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import layers
    from repro_torch.models import transformer as T
    from repro_torch.optim import schedule
    from repro_torch.train import steps
    from repro_torch.tree import tree_items, tree_map

    dev = mesh_lib.rank_device(rank, spec["device"])
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def peak_gib():
        return torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else 0.0

    def reset_peak():
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)

    base = configs.get_smoke(spec["arch"]) if spec["smoke"] \
        else configs.get_config(spec["arch"])
    cfg = dataclasses.replace(base, compute_dtype="float32")
    n = spec["steps"]
    sched = schedule.ScheduleConfig(warmup_steps=n, total_steps=n)
    data = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=spec["seq"],
                                      global_batch=spec["batch"]))
    batches = []
    for i in range(n):
        tokens, labels = data.batch_at(i)
        batches.append({"tokens": torch.from_numpy(tokens).to(dev),
                        "labels": torch.from_numpy(labels).to(dev)})
    out = {"rank": rank}

    def run_steps(step, state, save=None):
        losses, times, traffic = [], [], []
        for i, b in enumerate(batches):
            sync()
            t0 = time.perf_counter()
            state, m = step(state, b)
            losses.append(float(m["loss"]))
            sync()
            times.append(time.perf_counter() - t0)
            traffic.append(getattr(step, "traffic", None))
            if save is not None and i + 1 == 2:
                save(state)
        return state, dict(losses=losses, step_ms=[1e3 * t for t in times],
                           traffic=traffic)

    def against_one(tree, spec_of, mesh, want):
        """Each leaf gathered whole (every rank), held to ``want`` on rank
        0: (worst |diff| / max |want|, its leaf, worst |diff|, the fault
        leaf's ratio)."""
        worst, key, worst_abs, fault = 0.0, None, 0.0, None
        for path, leaf in tree_items(tree):
            full = sharding.gather_leaf(leaf, spec_of[path], mesh)
            if rank:
                continue
            diff = float((full - want[path]).abs().max())
            ratio = diff / max(float(want[path].abs().max()), 1e-30)
            worst_abs = max(worst_abs, diff)
            if ratio > worst:
                worst, key = ratio, path
            if path == DIST_FAULT_LEAF:
                fault = ratio
            del full
        return dict(worst=worst, leaf=key, worst_abs=worst_abs,
                    fault_leaf=fault)

    # One rank's steps, on rank 0 of the same call.
    one_grads = one_params = None
    if rank == 0:
        reset_peak()
        state = steps.init_state(cfg, 0, dev).tree()
        g = steps.make_grad_fn(cfg)(state["params"], batches[0])[2]
        one_grads = dict(tree_items(g))
        del g
        state, one = run_steps(steps.make_train_step(cfg, sched), state)
        one_params = dict(tree_items(state["params"]))
        one["peak_gib"] = peak_gib()
        out["one"] = one
        del state
    dist.barrier()

    ckpt = CheckpointManager(spec["ckpt"])
    out["meshes"] = {}
    for name, shape, fsdp in DIST_MESHES:
        mesh = mesh_lib.make_mesh(shape, ("data", "model"))
        rs = sharding.Ruleset(mesh=mesh, fsdp=fsdp)
        spec_of = sharding.leaf_specs(T.param_shapes(cfg), rs)
        reset_peak()
        state = steps.init_state(cfg, 0, dev, ruleset=rs).tree()
        grads_fn = steps.make_grad_fn(cfg, 1, rs)
        sync()
        t0 = time.perf_counter()
        _, _, g, tm = grads_fn(state["params"], batches[0])
        sync()
        r = {"grad_s": time.perf_counter() - t0,
             "grad_traffic": dict(tm.traffic),
             "grads": against_one(g, spec_of, mesh, one_grads)}
        del g
        if fsdp:
            # The planted fault: the data-axis mean skipped on one leaf.
            paths = [p for p, _ in tree_items(state["params"])]
            k = paths.index(DIST_FAULT_LEAF)
            average = steps._average_grads

            def skipped(grads, specs, t):
                out_ = average(grads, specs, t)
                out_[k] = grads[k]
                return out_

            steps._average_grads = skipped
            try:
                g = grads_fn(state["params"], batches[0])[2]
            finally:
                steps._average_grads = average
            r["fault"] = against_one(g, spec_of, mesh, one_grads)
            del g

        def save(st):
            sync()
            t0 = time.perf_counter()
            ckpt.save(2, st, ruleset=rs, shapes=steps.state_shapes(cfg))
            r["save_s"] = time.perf_counter() - t0

        state, run = run_steps(steps.make_train_step(cfg, sched, ruleset=rs),
                               state, save=save if fsdp else None)
        r.update(run)
        r["params"] = against_one(state["params"], spec_of, mesh,
                                  one_params)
        r["peak_gib"] = peak_gib()
        r["local_params"] = sum(x.numel() for _, x in
                                tree_items(state["params"]))
        out["meshes"][name] = r
        del state
    one_grads = one_params = None
    reset_peak()

    # The checkpoint saved at step 2 under FSDP, restored onto (1, 2).
    mesh = mesh_lib.make_mesh((1, 2), ("data", "model"))
    rs = sharding.Ruleset(mesh=mesh)
    like = steps.init_state(cfg, 0, dev, ruleset=rs).tree()
    sync()
    t0 = time.perf_counter()
    state, manifest = ckpt.restore(like, step=2, ruleset=rs)
    sync()
    restore_s = time.perf_counter() - t0
    del like
    _, m = steps.make_train_step(cfg, sched, ruleset=rs)(state, batches[2])
    out["resume"] = dict(step=manifest["step"], loss=float(m["loss"]),
                         restore_s=restore_s)
    del state

    # One bf16-compute step under FSDP (logged, not gated).
    mesh = mesh_lib.make_mesh((2, 1), ("data", "model"))
    rs = sharding.Ruleset(mesh=mesh, fsdp=True)
    state = steps.init_state(base, 0, dev, ruleset=rs).tree()
    step = steps.make_train_step(base, sched, ruleset=rs)
    sync()
    t0 = time.perf_counter()
    _, m = step(state, batches[0])
    loss = float(m["loss"])
    sync()
    out["bf16"] = dict(loss=loss, step_ms=1e3 * (time.perf_counter() - t0))
    del state, step

    # GPipe: the blocks in GPIPE_STAGES stages, forward through the kernel.
    gcfg = dataclasses.replace(cfg, use_flash=True)
    params = T.init_params(gcfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev, dtype=torch.float32)
    per = gcfg.n_layers // world
    weights = [tree_map(lambda *ls: torch.stack(ls),
                        *[params["blocks"][st * per + j]
                          for st in range(world)]) for j in range(per)]

    def stage(w, x):
        for block in w:
            x = T._layer_apply(block, gcfg, "attn", x)[0]
        return x

    mesh = mesh_lib.make_mesh((world,), ("stage",))
    fn = pipeline.gpipe(stage, mesh, axis="stage")
    with torch.no_grad():
        x = layers.embed(params["embed"], batches[0]["tokens"][:GPIPE_MICRO],
                         gcfg.dtype)[:, None]
        ops.reset_launches()
        sync()
        t0 = time.perf_counter()
        y = fn(weights, x)
        sync()
        gp = dict(ms=1e3 * (time.perf_counter() - t0),
                  launches=ops.LAUNCHES["flash_attention"],
                  bubble=pipeline.bubble_fraction(world, GPIPE_MICRO))
        if rank == 0:
            ops.reset_launches()
            sync()
            t0 = time.perf_counter()
            seq = torch.stack([stage(params["blocks"], x[m])
                               for m in range(GPIPE_MICRO)])
            sync()
            gp.update(seq_ms=1e3 * (time.perf_counter() - t0),
                      seq_launches=ops.LAUNCHES["flash_attention"],
                      err=float((y - seq).abs().max())
                      / float(seq.abs().max()))
    out["gpipe"] = gp
    return out


def run_train_dist(dev, ops, ref) -> dict:
    """Phase 24: the kernel at a GPipe stage's shape, then the ranks
    (``dist_train_rank``); gates and logs their results."""
    from repro_torch.launch import mesh as mesh_lib

    summary = {"kernel": time_gpipe_flash(dev, ops, ref)}
    failed = [] if summary["kernel"]["ok"] else [
        "flash_attention at the GPipe shape disagrees with its plain "
        "version"]
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        spec = dict(arch=DIST_ARCH, smoke=False, device="cuda", batch=DIST_B,
                    seq=DIST_S, steps=DIST_STEPS, ckpt=tmp)
        t0 = time.perf_counter()
        ranks = mesh_lib.run_ranks(dist_train_rank, 2, args=(spec,),
                                   deadline_s=DIST_DEADLINE_S,
                                   timeout_s=DIST_TIMEOUT_S, threads=1)
        summary["ranks_s"] = time.perf_counter() - t0
    failed += dist_verdicts(ranks, summary)
    if failed:
        raise RuntimeError("; ".join(failed))
    return summary


def dist_verdicts(ranks, summary) -> list:
    """Phase 24's gates and log lines over the ranks' results; fills
    ``summary``; returns the failures."""
    failed = []
    r0 = ranks[0]
    one = r0["one"]
    tokens = DIST_B * DIST_S
    one_ms = sorted(one["step_ms"][1:] or one["step_ms"])[0]
    log(f"  one rank: losses {one['losses']}, step {one['step_ms']} ms "
        f"({tokens / one_ms * 1e3:.0f} tokens/s at the fastest), peak "
        f"{one['peak_gib']:.2f} GiB")
    summary["one"] = dict(step_ms=one_ms, tokens_per_s=tokens / one_ms * 1e3,
                          peak_gib=one["peak_gib"])
    for name, shape, fsdp in DIST_MESHES:
        runs = [r["meshes"][name] for r in ranks]
        a = runs[0]
        ms = max(sorted(r["step_ms"][1:] or r["step_ms"])[0] for r in runs)
        traffic = a["traffic"][-1]
        rel = [abs(x - y) / abs(y) for x, y in zip(a["losses"],
                                                     one["losses"])]
        g = a["grads"]
        log(f"  {name} {dict(zip(('data', 'model'), shape))}: losses "
            f"{a['losses']} (|diff| / one rank's: "
            f"{[f'{x:.2e}' for x in rel]}, limit {DIST_LOSS_RTOL:g}); "
            f"first-step gradients gathered whole, worst leaf "
            f"{g['leaf']} {g['worst']:.3e} of its largest element (limit "
            f"GRAD_TOL {GRAD_TOL:g}); step {[f'{x:.1f}' for x in a['step_ms']]}"
            f" ms on rank 0 ({tokens / ms * 1e3:.0f} tokens/s at the slower "
            f"rank's fastest, {one_ms / ms:.3f}x one rank); "
            f"{traffic['collectives']} collectives and "
            f"{traffic['bytes'] / 1e9:.3f} GB a step; peak a rank "
            f"{[round(r['peak_gib'], 2) for r in runs]} GiB; parameters a "
            f"rank {a['local_params'] / 1e9:.4f} B; largest parameter "
            f"difference from one rank after {DIST_STEPS} steps "
            f"{a['params']['worst_abs']:.3e} ({a['params']['leaf']})")
        if max(rel) > DIST_LOSS_RTOL:
            failed.append(f"{name}: losses {a['losses']} against one rank's "
                          f"{one['losses']}")
        if not g["worst"] <= GRAD_TOL:
            failed.append(f"{name}: first-step gradient {g['leaf']} "
                          f"{g['worst']:.3e} off")
        if any(r["losses"] != a["losses"] for r in runs):
            failed.append(f"{name}: the ranks logged different losses")
        if fsdp:
            f = a["fault"]
            log(f"  planted fault (the data-axis mean skipped on "
                f"{DIST_FAULT_LEAF}): that leaf {f['fault_leaf']:.3e} of its "
                f"largest element, worst {f['leaf']} {f['worst']:.3e} "
                f"(must exceed GRAD_TOL); checkpoint at step 2 saved in "
                f"{a['save_s']:.1f} s")
            if not f["worst"] > GRAD_TOL:
                failed.append(f"the planted skipped mean was not caught: "
                              f"{f}")
        summary[name] = dict(step_ms=ms, tokens_per_s=tokens / ms * 1e3,
                             peak_gib=max(r["peak_gib"] for r in runs),
                             collectives=traffic["collectives"],
                             bytes=traffic["bytes"],
                             grad_worst=g["worst"],
                             param_diff=a["params"]["worst_abs"])
    fresh = r0["meshes"]["fsdp"]["losses"][2]
    res = r0["resume"]
    rel = abs(res["loss"] - fresh) / abs(fresh)
    log(f"  resumed: the step-{res['step']} checkpoint saved under FSDP "
        f"restored onto (1, 2) in {res['restore_s']:.1f} s; step 3 loss "
        f"{res['loss']:.6f} against the uninterrupted run's {fresh:.6f} "
        f"({rel:.2e}, limit {DIST_LOSS_RTOL:g})")
    if res["step"] != 2 or rel > DIST_LOSS_RTOL:
        failed.append(f"resumed step 3 loss {res['loss']} against {fresh}")
    summary["resume_rel"] = rel
    log(f"  one bf16-compute step under FSDP (logged): loss "
        f"{r0['bf16']['loss']:.6f} in {r0['bf16']['step_ms']:.1f} ms")
    gp = r0["gpipe"]
    want = GPIPE_MICRO * (DIST_LAYERS // GPIPE_STAGES)
    log(f"  GPipe, {GPIPE_STAGES} stages x {DIST_LAYERS // GPIPE_STAGES} "
        f"blocks, {GPIPE_MICRO} microbatches of 1 x {DIST_S}, fp32: "
        f"{gp['ms']:.1f} ms a sweep against the sequential stack's "
        f"{gp['seq_ms']:.1f} ms on one rank; bubble fraction "
        f"{gp['bubble']:.3f}; |diff| / max |sequential| {gp['err']:.3e} "
        f"(limit {GPIPE_TOL:g}); flash_attention launches a rank "
        f"{[r['gpipe']['launches'] for r in ranks]} (the sequential "
        f"stack {gp['seq_launches']})")
    if not gp["err"] <= GPIPE_TOL:
        failed.append(f"GPipe differs from the sequential stack: "
                      f"{gp['err']:.3e}")
    if any(r["gpipe"]["launches"] != want for r in ranks):
        failed.append(f"GPipe ranks launched flash_attention "
                      f"{[r['gpipe']['launches'] for r in ranks]} times, "
                      f"want {want}")
    summary["gpipe"] = dict(ms=gp["ms"], seq_ms=gp["seq_ms"], err=gp["err"],
                            launches=gp["launches"])
    return failed


# ----------------------------------------------------------------------------
# Phase 25: the model axis for every family
# ----------------------------------------------------------------------------

@contextlib.contextmanager
def counting_collectives():
    """Every ``all_reduce`` and ``broadcast`` this process issues through
    ``torch.distributed`` counted with its bytes (the serving and
    training collectives reach gloo only through these two)."""
    import torch.distributed as dist

    real = dist.all_reduce, dist.broadcast
    acc = {"collectives": 0, "bytes": 0}

    def counted(fn):
        def wrapped(t, *args, **kwargs):
            acc["collectives"] += 1
            acc["bytes"] += t.numel() * t.element_size()
            return fn(t, *args, **kwargs)
        return wrapped

    dist.all_reduce, dist.broadcast = (counted(f) for f in real)
    try:
        yield acc
    finally:
        dist.all_reduce, dist.broadcast = real


def ep_serve_rank(dev, mesh, prompts) -> dict:
    """Phase 25 (a) on one rank: dbrx-132b at its published widths cut to
    EP_LAYERS layers (bf16 weights, fp32 compute). Rank 0 first takes the
    fp32 logits of a prefill and a decode step with the whole tree; the
    engine is built from the whole tree (each rank keeps its shard of 8
    experts), and its shard gives the same logits on the mesh (every
    ``flash_decode`` held to its plain version, the decode step's
    collectives counted), then with a combine left unreduced on layer 0
    (the planted fault); then the engine serves ``prompts``."""
    from repro_torch import configs
    from repro_torch.dist import sharding
    from repro_torch.kernels import ops, ref
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as T
    from repro_torch.serve import paged
    from repro_torch.serve.engine import Request, ServeConfig, ServingEngine

    rank, world = mesh.index("model"), mesh.shape["model"]
    cfg = dataclasses.replace(configs.get_config(EP_ARCH),
                              n_layers=EP_LAYERS)
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    # The logit check routes at a squeezed capacity, so that it drops.
    squeezed = dataclasses.replace(f32,
                                   moe_capacity_factor=EP_CHECK_CAPACITY)
    torch.cuda.reset_peak_memory_stats(dev)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    out = {}
    n_pages = 1 + TP_B * TP_MAX_LEN // TP_PS
    n_pages += -n_pages % world
    pool = paged.PageAllocator(n_pages, TP_PS, n_devices=world)
    table = np.zeros((TP_B, TP_MAX_LEN // TP_PS), np.int32)
    for i in range(TP_B):
        got = pool.alloc(i, paged.pages_for(TP_CHECK_PROMPT + 1, TP_PS))
        table[i, :len(got)] = got
    toks = torch.from_numpy(np.random.RandomState(25).randint(
        2, cfg.vocab, size=(TP_B, TP_CHECK_PROMPT + 1))).to(dev)

    def fresh():
        caches = T.init_paged_caches(f32, TP_B, TP_MAX_LEN, TP_PS, n_pages,
                                     device=dev)
        caches[0]["pages"].copy_(torch.from_numpy(table))
        return caches

    def logits(p, caches, rs, during=contextlib.nullcontext):
        with torch.no_grad(), sharding.use_ruleset(rs), \
                counting_drops(moe_mod) as drops:
            pre, caches = T.forward(p, squeezed, toks[:, :-1],
                                    caches=caches)
            with during() as step_traffic:
                step, _ = T.forward(p, squeezed, toks[:, -1:],
                                    caches=caches)
        return (pre.float(), step[:, -1].float(),
                sum(int(d) for d in drops["dropped"]), step_traffic)

    if rank == 0:
        one_pre, one_step, out["one_check_drops"], _ = logits(
            params, fresh(), None)
        out["logit_scale"] = float(one_pre.abs().max())
    scfg = ServeConfig(max_len=TP_MAX_LEN, batch=TP_B, paged=True,
                       page_size=TP_PS, chunk_size=TP_CHUNK, eos_id=-1)
    eng = ServingEngine(params, f32, scfg, device=dev, capture=False,
                        mesh=mesh)
    del params
    torch.cuda.empty_cache()
    # What the rank keeps once the whole tree is freed: its shard (and,
    # on rank 0, one rank's check logits).
    out["resident_gib"] = torch.cuda.memory_allocated(dev) / 2**30
    shard = eng.params
    out["local_experts"] = int(shard["blocks"][0]["moe"]["expert_gate"]
                               .shape[0])
    rules = eng._ruleset

    real_decode, seen = ops.flash_decode, []

    def checked(q, k, v, lengths):
        got = real_decode(q, k, v, lengths)
        ok, err = ref.compare(got, ref.flash_decode(q, k, v, lengths))
        seen.append((list(q.shape), list(k.shape), ok, err))
        return got

    ops.flash_decode = checked
    try:
        tp_pre, tp_step, out["check_drops"], traffic = logits(
            shard, fresh(), rules, counting_collectives)
    finally:
        ops.flash_decode = real_decode
    out["check_decode"] = seen
    out["decode_traffic"] = dict(traffic)

    real_reduce, calls = moe_mod._ModelSplit.reduce, []

    def unreduced_once(self, x):
        calls.append(1)
        return x if len(calls) == 1 else real_reduce(self, x)

    moe_mod._ModelSplit.reduce = unreduced_once
    try:
        bad_pre, bad_step, _, _ = logits(shard, fresh(), rules)
    finally:
        moe_mod._ModelSplit.reduce = real_reduce
    if rank == 0:
        out["logit_diff"] = (float((tp_pre - one_pre).abs().max()),
                             float((tp_step - one_step).abs().max()))
        out["fault_diff"] = (float((bad_pre - one_pre).abs().max()),
                             float((bad_step - one_step).abs().max()))
        del one_pre, one_step
    del tp_pre, tp_step, bad_pre, bad_step
    torch.cuda.empty_cache()

    for rid, p in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=p.copy(), max_new=TP_NEW))
    torch.cuda.synchronize(dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    with counting_drops(moe_mod) as drops, counting_collectives() as total:
        eng.run_until_drained()
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    out["engine"] = dict(
        streams={k: list(v) for k, v in eng.finished.items()},
        wall=wall, tok_s=TP_B * TP_NEW / wall,
        launches={k: v for k, v in ops.LAUNCHES.items() if v},
        decode_steps=eng.decode_steps, ticks=eng.ticks,
        drops=sum(int(d) for d in drops["dropped"]),
        choices=drops["choices"], traffic=dict(total),
        peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
    del eng, shard
    torch.cuda.empty_cache()
    return out


def ep_draft_rank(dev, mesh, prompts) -> dict:
    """Phase 25 (b) on one rank: qwen3-4b at full width (bf16 weights,
    fp32 compute) on the two-rank mesh, the plain engine and then the
    speculative one with a ``"self"`` model draft (``SPEC_K``), each over
    ``prompts`` for EP_SPEC_NEW tokens."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import Request, ServeConfig, ServingEngine

    cfg = configs.get_config("qwen3-4b")
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    base = ServeConfig(max_len=TP_MAX_LEN, batch=TP_B, paged=True,
                       page_size=TP_PS, chunk_size=TP_CHUNK, eos_id=-1)
    out = {}
    for label, scfg in (("plain", base), ("spec", dataclasses.replace(
            base, spec_k=SPEC_K, draft="self"))):
        torch.cuda.reset_peak_memory_stats(dev)
        eng = ServingEngine(params, f32, scfg, device=dev, capture=False,
                            mesh=mesh)
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=p.copy(),
                               max_new=EP_SPEC_NEW))
        torch.cuda.synchronize(dev)
        ops.reset_launches()
        t0 = time.perf_counter()
        eng.run_until_drained()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        out[label] = dict(
            streams={k: list(v) for k, v in eng.finished.items()},
            tok_s=TP_B * EP_SPEC_NEW / wall, wall=wall,
            proposed=eng.spec_proposed, accepted=eng.spec_accepted,
            verify_steps=eng.verify_steps, decode_steps=eng.decode_steps,
            drafts_here=eng.draft is not None,
            launches={k: v for k, v in ops.LAUNCHES.items() if v},
            peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
        del eng
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return out


def grads_against_one(tm_grads, spec_of, mesh, one, tol, floor_frac,
                      rank) -> dict:
    """The mesh's gradients gathered whole (every rank), held on rank 0
    to ``one`` (the one-rank gradients by path): the worst leaf's
    |diff| over its largest element (floored at ``floor_frac`` of the
    whole gradient's largest) and whether every leaf is within ``tol``."""
    from repro_torch.dist import sharding
    from repro_torch.tree import tree_items

    whole = {path: sharding.gather_leaf(g, spec_of[path], mesh)
             for path, g in tree_items(tm_grads)}
    if rank:
        return {}
    top = max(float(w.abs().max()) for w in one.values())
    worst, leaf = 0.0, None
    for path, w in one.items():
        scale = max(float(w.abs().max()), floor_frac * top)
        ratio = float((whole[path] - w).abs().max()) / max(scale, 1e-30)
        if ratio > worst:
            worst, leaf = ratio, path
    return dict(worst=worst, leaf=leaf, ok=worst <= tol)


def ep_train_rank(dev, rank) -> dict:
    """Phase 25 (c) and (d) on one rank of a (data 1, model 2) mesh:
    mamba2-370m whole (its first step's gradients against one rank's in
    float64, then fp32; then EP_TRAIN_STEPS fp32 steps on one rank and on
    the mesh) and one fp32 step of each of EP_SMOKES, and whisper
    smoke's ``encode``, against one rank's. Rank 0 takes the one-rank
    runs."""
    from repro_torch import configs
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.dist import sharding
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import transformer as T
    from repro_torch.optim import schedule
    from repro_torch.train import dist as train_dist
    from repro_torch.train import steps
    from repro_torch.tree import tree_items

    mesh = mesh_lib.make_mesh((1, EP), ("data", "model"))
    rs = sharding.Ruleset(mesh=mesh)
    out = {"grads": {}, "smokes": {}}

    def batch_of(cfg, b, s, seed=0):
        tokens, labels = SyntheticLMData(DataConfig(
            vocab=cfg.vocab, seq_len=s, global_batch=b)).batch_at(seed)
        batch = {"tokens": torch.from_numpy(tokens).to(dev),
                 "labels": torch.from_numpy(labels).to(dev)}
        if cfg.n_frontend_tokens:
            batch["frontend"] = torch.from_numpy(np.random.RandomState(
                seed).randn(b, cfg.n_frontend_tokens, cfg.d_model).astype(
                np.float32)).to(dev)
        return batch

    def step_pair(cfg, params, batch, tol, floor_frac):
        """One rank's loss and gradients (rank 0), then the mesh's, held
        to them."""
        spec_of = sharding.leaf_specs(T.param_shapes(cfg), rs)
        one = None
        if rank == 0:
            loss1, _, g1, _ = steps.make_grad_fn(cfg)(params, batch)
            one = (float(loss1), {k: v for k, v in tree_items(g1)})
        shard = sharding.shard_tree(params, mesh, rs)
        with counting_collectives() as traffic:
            loss2, _, g2, _ = steps.make_grad_fn(cfg, 1, rs)(shard, batch)
        r = grads_against_one(g2, spec_of, mesh, one[1] if one else None,
                              tol, floor_frac, rank)
        if rank == 0:
            r.update(loss_one=one[0], loss=float(loss2),
                     loss_rel=abs(float(loss2) / one[0] - 1))
        r["traffic"] = dict(traffic)
        return r

    # (c) mamba2-370m whole: float64 gated, fp32 logged (GRAD_CHECK's
    # batch); then EP_TRAIN_STEPS fp32 steps at MAMBA_BATCH x MAMBA_SEQ.
    base = configs.get_config("mamba2-370m")
    smoke, b, s = GRAD_CHECK["mamba2-370m"]
    for compute in ("float64", "float32"):
        cfg = dataclasses.replace(base, compute_dtype=compute)
        params = steps.init_state(cfg, 0, dev).params
        ops.reset_launches()
        out["grads"][compute] = step_pair(cfg, params, batch_of(cfg, b, s),
                                          GRAD_TOL, 0.0)
        out["grads"][compute]["launches"] = {
            k: v for k, v in ops.LAUNCHES.items() if v}
        del params
    cfg = dataclasses.replace(base, compute_dtype="float32")
    sched = schedule.ScheduleConfig(warmup_steps=EP_TRAIN_STEPS,
                                    total_steps=EP_TRAIN_STEPS)
    batches = [batch_of(cfg, MAMBA_BATCH, MAMBA_SEQ, i)
               for i in range(EP_TRAIN_STEPS)]

    def run(ruleset):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        state = steps.init_state(cfg, 0, dev, ruleset=ruleset).tree()
        step = steps.make_train_step(cfg, sched, ruleset=ruleset)
        losses, ms = [], []
        for batch in batches:
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize(dev)
            ms.append(1e3 * (time.perf_counter() - t0))
        r = dict(losses=losses, step_ms=ms, traffic=step.traffic,
                 peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
                 local_params=sum(x.numel() for _, x in
                                  tree_items(state["params"])))
        del state, step
        torch.cuda.empty_cache()
        return r

    if rank == 0:
        out["mamba_one"] = run(None)
    out["mamba_mesh"] = run(rs)

    # (d) the smoke families, fp32, one step against one rank's.
    for arch, fields in EP_SMOKES:
        cfg = dataclasses.replace(configs.get_smoke(arch), **fields)
        params = steps.init_state(cfg, 0, dev).params
        nonzero_leaves(params, seed=25)
        tol = EP_JAMBA_TOL if arch == "jamba-v0.1-52b" else EP_GRAD_TOL
        key = f"{cfg.name} {cfg.moe_impl}" if cfg.n_experts else cfg.name
        out["smokes"][key] = step_pair(cfg, params, batch_of(cfg, 4, 16),
                                       tol, EP_ZERO_GRAD)
    cfg = configs.get_smoke("whisper-medium")
    params = steps.init_state(cfg, 0, dev).params
    nonzero_leaves(params, seed=25)
    frontend = batch_of(cfg, 4, 16)["frontend"]
    shard = sharding.shard_tree(params, mesh, rs)
    with torch.no_grad():
        with train_dist.use_mesh(train_dist.TrainMesh(rs)):
            y = T.encode(shard, cfg, frontend)
        if rank == 0:
            want = T.encode(params, cfg, frontend)
            out["encode"] = float((y - want).abs().max()) / float(
                want.abs().max())
    return out


def ep_rank(rank: int, world: int, spec: dict) -> dict:
    """Phase 25 on one rank of the group (``launch.mesh.run_ranks``):
    (a) ``ep_serve_rank``, (b) ``ep_draft_rank``, then (c) and (d)
    ``ep_train_rank``; seconds of each."""
    from repro_torch.launch import mesh as mesh_lib

    dev = mesh_lib.rank_device(rank, "cuda")
    torch.cuda.set_device(dev)
    mesh = mesh_lib.make_serving_mesh(world)
    out, seconds = {"rank": rank}, {}
    for name, fn in (("serve", lambda: ep_serve_rank(dev, mesh,
                                                     spec["dbrx_prompts"])),
                     ("draft", lambda: ep_draft_rank(dev, mesh,
                                                     spec["qwen_prompts"])),
                     ("train", lambda: ep_train_rank(dev, rank))):
        t0 = time.perf_counter()
        out[name] = fn()
        torch.cuda.synchronize(dev)
        seconds[name] = time.perf_counter() - t0
    out["seconds"] = seconds
    return out


def run_ep(dev, ops, ref, configs, T, moe_mod) -> dict:
    """Phase 25: ``flash_decode`` at dbrx's gathered per-rank shape; the
    one-rank engines of (a) and (b) here, each freed before the next;
    the ranks (``ep_rank``); gates and log lines (``ep_verdicts``)."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.serve.engine import ServeConfig

    t_phase = time.perf_counter()
    dcfg = dataclasses.replace(configs.get_config(EP_ARCH),
                               n_layers=EP_LAYERS)
    dbrx_prompts = make_requests(dcfg.vocab, TP_B, lo=TP_LO, hi=TP_HI)
    qcfg = configs.get_config("qwen3-4b")
    qwen_prompts = make_requests(qcfg.vocab, TP_B, lo=EP_DRAFT_LO,
                                 hi=EP_DRAFT_HI)
    log(f"  dbrx prompt lengths {[len(p) for p in dbrx_prompts]}, {TP_NEW} "
        f"new each; qwen3-4b {[len(p) for p in qwen_prompts]}, "
        f"{EP_SPEC_NEW} new each; max_len {TP_MAX_LEN}, pages of {TP_PS}, "
        f"chunks of {TP_CHUNK}")
    summary = {"kernel": time_gathered_decode(
        dev, ops, ref, [len(p) + TP_NEW // 2 for p in dbrx_prompts],
        shape=(TP_B, dcfg.n_heads // EP, dcfg.n_kv_heads // EP, dcfg.dhead,
               TP_MAX_LEN), seed=25)}
    scfg = ServeConfig(max_len=TP_MAX_LEN, batch=TP_B, paged=True,
                       page_size=TP_PS, chunk_size=TP_CHUNK, eos_id=-1)
    one, drops = {}, {}

    @contextlib.contextmanager
    def run_drops():
        # The run's drops only: not the steps the engine's construction
        # runs once on its empty slots.
        with counting_drops(moe_mod) as acc:
            drops["run"] = acc
            yield

    cfg, params = init_model(EP_ARCH, configs, T, dev, n_layers=EP_LAYERS)
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    # Twice, each a new engine: a drop count that moved between the two
    # would be a race in the run, not a difference of the mesh.
    for key in ("dbrx", "dbrx_again"):
        torch.cuda.reset_peak_memory_stats()
        eng, fin, wall, launches = serve(params, f32, scfg, dbrx_prompts,
                                         TP_NEW, dev, ops, capture=False,
                                         during=run_drops)
        check_served(eng, fin, dbrx_prompts, TP_NEW, cfg.vocab)
        one[key] = dict(streams={k: list(v) for k, v in fin.items()},
                        tok_s=TP_B * TP_NEW / wall, wall=wall,
                        drops=sum(int(d) for d in drops["run"]["dropped"]),
                        choices=drops["run"]["choices"],
                        launches={k: v for k, v in launches.items() if v},
                        peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        del eng
    del params
    torch.cuda.empty_cache()
    cfg, params = init_model("qwen3-4b", configs, T, dev)
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    for label, c in (("plain", scfg), ("spec", dataclasses.replace(
            scfg, spec_k=SPEC_K, draft="self"))):
        eng, fin, wall, _ = serve(params, f32, c, qwen_prompts, EP_SPEC_NEW,
                                  dev, ops, capture=False)
        check_served(eng, fin, qwen_prompts, EP_SPEC_NEW, cfg.vocab)
        one[f"qwen_{label}"] = dict(
            streams={k: list(v) for k, v in fin.items()},
            tok_s=TP_B * EP_SPEC_NEW / wall, proposed=eng.spec_proposed,
            accepted=eng.spec_accepted)
        del eng
    del params
    torch.cuda.empty_cache()
    summary["one_s"] = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    ranks = mesh_lib.run_ranks(
        ep_rank, EP, args=(dict(dbrx_prompts=dbrx_prompts,
                                qwen_prompts=qwen_prompts),),
        deadline_s=EP_DEADLINE_S, timeout_s=EP_TIMEOUT_S, threads=1)
    summary["ranks_s"] = time.perf_counter() - t0
    # flash_decode's (q, cache) shapes a rank: its q heads over the kv
    # heads they read in the gathered view.
    want_shape = [[TP_B, dcfg.n_heads // EP, dcfg.dhead],
                  [TP_B, TP_MAX_LEN, dcfg.n_kv_heads // EP, dcfg.dhead]]
    failed = ep_verdicts(ranks, one, summary, want_shape)
    summary["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 25's seconds: {summary['phase_s']:.1f} (one-rank engines "
        f"{summary['one_s']:.1f}, ranks {summary['ranks_s']:.1f}: "
        f"{ranks[0]['seconds']}; target {EP_TARGET_S:g})")
    if failed:
        raise RuntimeError("; ".join(failed))
    return summary


def ep_verdicts(ranks, one, summary, want_shape) -> list:
    """Phase 25's gates and log lines over the ranks' results; fills
    ``summary``; returns the failures."""
    failed = []
    k = summary["kernel"]
    if not (k["fp32"]["ok"] and k["bf16"]["ok"]):
        failed.append("flash_decode at dbrx's gathered shape disagrees "
                      "with its plain version")
    r0 = ranks[0]["serve"]
    a = [r["serve"] for r in ranks]
    pre, step = r0["logit_diff"]
    fpre, fstep = r0["fault_diff"]
    log(f"  (a) {EP_ARCH} at its published widths, {EP_LAYERS} of 40 layers,"
        f" {r0['local_experts']} experts a rank: two ranks against one, fp32 "
        f"compute (bf16 weights), {TP_B} slots: {TP_CHECK_PROMPT}-row "
        f"prefill max |logit diff| {pre:.3e}, decode step {step:.3e} (limit "
        f"{FP32_LOGIT_TOL:g}; max |logit| {r0['logit_scale']:.3f}); a "
        f"combine left unreduced on layer 0: {fpre:.3e}, {fstep:.3e} (must "
        f"exceed the limit); the check, routed at capacity factor "
        f"{EP_CHECK_CAPACITY:g}, dropped {r0['check_drops']} choices, one "
        f"rank {r0['one_check_drops']}")
    if not (pre <= FP32_LOGIT_TOL and step <= FP32_LOGIT_TOL):
        failed.append(f"(a) two-rank fp32 logits differ from one rank's: "
                      f"{pre:.3e} {step:.3e}")
    if not max(fpre, fstep) > FP32_LOGIT_TOL:
        failed.append(f"(a) the unreduced combine was not caught: "
                      f"{fpre:.3e} {fstep:.3e}")
    if r0["check_drops"] != r0["one_check_drops"] or not r0["check_drops"]:
        failed.append(f"(a) the check's drops: {r0['check_drops']} against "
                      f"{r0['one_check_drops']}")
    for r in a:
        seen = r["check_decode"]
        if len(seen) != EP_LAYERS or not all(ok for _, _, ok, _ in seen) \
                or any(list(x[:2]) != want_shape for x in seen):
            failed.append(f"(a) flash_decode at the gathered shape: {seen}")
    e = [r["engine"] for r in a]
    d, d2 = one["dbrx"], one["dbrx_again"]
    traffic = r0["decode_traffic"]
    log(f"  (a) engine: two ranks {e[0]['tok_s']:.2f} tok/s eager "
        f"({e[0]['wall']:.2f} s, {e[0]['ticks']} ticks, "
        f"{e[0]['decode_steps']} decode steps) against one rank "
        f"{d['tok_s']:.2f} tok/s eager; drops two ranks "
        f"{[x['drops'] for x in e]} of {e[0]['choices']} choices, one rank "
        f"{d['drops']} of {d['choices']}, again {d2['drops']}; a decode "
        f"step's collectives "
        f"{traffic['collectives']} carrying {traffic['bytes'] / 1e6:.3f} MB "
        f"(the whole run {e[0]['traffic']['collectives']}, "
        f"{e[0]['traffic']['bytes'] / 1e9:.3f} GB); peak a rank "
        f"{[round(x['peak_gib'], 2) for x in e]} GiB (one rank "
        f"{d['peak_gib']:.2f} GiB), held once the whole tree is freed "
        f"{[round(x['resident_gib'], 2) for x in a]} GiB; launches a rank "
        f"{[x['launches'] for x in e]}, one rank {d['launches']}")
    if (d2["drops"], d2["streams"]) != (d["drops"], d["streams"]):
        failed.append(f"(a) one rank's engine run twice dropped "
                      f"{d['drops']} and {d2['drops']}")
    for i, x in enumerate(e):
        if x["streams"] != d["streams"]:
            failed.append(f"(a) rank {i}'s streams differ from one rank's")
        if x["drops"] != d["drops"]:
            failed.append(f"(a) rank {i} dropped {x['drops']}, one rank "
                          f"{d['drops']}")
        want = EP_LAYERS * x["decode_steps"]
        if x["launches"] != {"flash_decode": want}:
            failed.append(f"(a) rank {i} launched {x['launches']}, want "
                          f"flash_decode {want}")
    summary["dbrx"] = dict(
        tok_s=(e[0]["tok_s"], d["tok_s"]), logit_diff=(pre, step),
        fault_diff=(fpre, fstep),
        drops=(e[0]["drops"], d["drops"], d2["drops"]),
        decode_collectives=traffic["collectives"],
        decode_bytes=traffic["bytes"],
        peak_gib=[x["peak_gib"] for x in e], one_peak_gib=d["peak_gib"],
        resident_gib=[x["resident_gib"] for x in a],
        launches=e[0]["launches"])

    b = [r["draft"] for r in ranks]
    q, qs = one["qwen_plain"], one["qwen_spec"]
    sp = b[0]["spec"]
    rate = sp["accepted"] / max(sp["proposed"], 1)
    log(f"  (b) qwen3-4b, a \"self\" model draft (spec_k {SPEC_K}) on two "
        f"ranks: {sp['tok_s']:.2f} tok/s against the plain two-rank engine's "
        f"{b[0]['plain']['tok_s']:.2f}, one rank's spec {qs['tok_s']:.2f} "
        f"and plain {q['tok_s']:.2f} (eager, fp32); drafts "
        f"proposed/accepted a rank "
        f"{[(x['spec']['proposed'], x['spec']['accepted']) for x in b]}, "
        f"one rank ({qs['proposed']}, {qs['accepted']}) (accept rate "
        f"{rate:.3f}), {sp['verify_steps']} verify steps; peak a rank "
        f"{[round(x['spec']['peak_gib'], 2) for x in b]} GiB; launches a "
        f"rank {[x['spec']['launches'] for x in b]}")
    for i, x in enumerate(b):
        if not (x["spec"]["streams"] == x["plain"]["streams"]
                == q["streams"] == qs["streams"]):
            failed.append(f"(b) rank {i}: spec, plain two-rank and one-rank "
                          f"streams differ")
        if (x["spec"]["proposed"], x["spec"]["accepted"]) != (
                qs["proposed"], qs["accepted"]):
            failed.append(f"(b) rank {i}'s draft counters differ from one "
                          f"rank's")
    if not sp["accepted"]:
        failed.append(f"(b) no draft was accepted ({sp['proposed']} "
                      f"proposed)")
    if [x["spec"]["drafts_here"] for x in b] != [i == 0 for i in range(EP)]:
        failed.append("(b) a rank other than 0 holds a draft source")
    summary["draft"] = dict(tok_s=sp["tok_s"], plain_tok_s=(
        b[0]["plain"]["tok_s"], q["tok_s"]), one_spec_tok_s=qs["tok_s"],
        accept_rate=rate)

    t = ranks[0]["train"]
    g64, g32 = t["grads"]["float64"], t["grads"]["float32"]
    log(f"  (c) mamba2-370m whole over (data 1, model {EP}), 32 SSM heads, "
        f"16 a rank: first-step gradients two ranks against one, float64: "
        f"worst leaf {g64['leaf']} {g64['worst']:.3e} of its largest "
        f"element (limit GRAD_TOL {GRAD_TOL:g}), loss rel "
        f"{g64['loss_rel']:.2e}; fp32 (logged only) {g32['leaf']} "
        f"{g32['worst']:.3e}, loss rel {g32['loss_rel']:.2e}; a step's "
        f"collectives {g64['traffic']['collectives']}; launches "
        f"{g64['launches']}")
    if not g64["ok"]:
        failed.append(f"(c) mamba2-370m float64 gradients {g64['leaf']} "
                      f"{g64['worst']:.3e} off")
    m1, m2 = t["mamba_one"], [r["train"]["mamba_mesh"] for r in ranks]
    tokens = MAMBA_BATCH * MAMBA_SEQ
    one_ms = min(m1["step_ms"][1:])
    two_ms = max(min(x["step_ms"][1:]) for x in m2)
    rel = [abs(x / y - 1) for x, y in zip(m2[0]["losses"], m1["losses"])]
    tr = m2[0]["traffic"]
    log(f"  (c) {EP_TRAIN_STEPS} fp32 steps at {MAMBA_BATCH} x {MAMBA_SEQ}:"
        f" losses two ranks {[round(x, 5) for x in m2[0]['losses']]}, one "
        f"rank {[round(x, 5) for x in m1['losses']]} (rel "
        f"{[f'{x:.1e}' for x in rel]}); step {two_ms:.1f} ms two ranks "
        f"({tokens / two_ms * 1e3:.0f} tokens/s) against {one_ms:.1f} ms "
        f"one rank; {tr['collectives']} collectives, "
        f"{tr['bytes'] / 1e9:.3f} GB a step; peak a rank "
        f"{[round(x['peak_gib'], 2) for x in m2]} GiB (one rank "
        f"{m1['peak_gib']:.2f}); parameters a rank "
        f"{m2[0]['local_params'] / 1e6:.1f} M")
    summary["mamba"] = dict(grad_f64=g64["worst"], grad_f32=g32["worst"],
                            step_ms=(two_ms, one_ms),
                            collectives=tr["collectives"],
                            bytes=tr["bytes"],
                            peak_gib=[x["peak_gib"] for x in m2],
                            one_peak_gib=m1["peak_gib"])
    for name, r in t["smokes"].items():
        log(f"  (d) {name} over (1, {EP}), fp32: loss rel "
            f"{r['loss_rel']:.2e} (limit {EP_LOSS_RTOL:g}); worst gradient "
            f"leaf {r['leaf']} {r['worst']:.3e} of its largest element; "
            f"{r['traffic']['collectives']} collectives")
        if not (r["ok"] and r["loss_rel"] <= EP_LOSS_RTOL):
            failed.append(f"(d) {name}: loss rel {r['loss_rel']:.2e}, "
                          f"gradient {r['leaf']} {r['worst']:.3e}")
    log(f"  (d) whisper-medium-smoke encode over (1, {EP}): |diff| / max "
        f"{t['encode']:.3e} (limit {EP_GRAD_TOL:g})")
    if not t["encode"] <= EP_GRAD_TOL:
        failed.append(f"(d) whisper encode {t['encode']:.3e} off")
    summary["smokes"] = {k: v["worst"] for k, v in t["smokes"].items()}
    return failed


# ----------------------------------------------------------------------------
# Phase 26: the dry run's accounting held to the card
# ----------------------------------------------------------------------------

# (a) The op trace of a real step on the card against its meta trace (the
# dry run's): qwen2-0.5b's fp32 train step at DRY_TRAIN (phase 14's batch)
# and qwen3-4b's bf16 decode at DRY_DECODE (b slots against a full cache
# of that many rows, so the decode kernel reads every row the trace
# counts). Gates: the census of the ops that move data and the FLOPs
# equal; the trace's argument bytes within DRY_ARG_RTOL of what the
# build allocated; the measured time at least DRY_BOUND_FLOOR of the
# roofline's overlapped bound (a time under it means the count is
# wrong). (b) DRY_MESHES on two gloo ranks sharing the card, each
# against one rank's run of the same calls (a prefill of DRY_PROMPT and
# DRY_STEPS decode steps): fp32 logits within FP32_LOGIT_TOL (bf16
# logged); each rank's census equal to its fake-group trace on meta; the
# decode kernel's log-sum-exp held to its plain version. jamba is cut to
# one period (DRY_JAMBA_LAYERS of 32 layers) at its published widths; its
# (2, 1) mesh splits the cache's rows over "data" (sequence-parallel
# decode), the prompt long enough to fill both blocks. (c) Remat:
# qwen2-0.5b's fp32 gradients with "full" and "dots" against none within
# DRY_REMAT_TOL of each leaf's largest element; peak memory and time
# logged.
DRY_TRAIN_ARCH, DRY_TRAIN = "qwen2-0.5b", (4, 512)
DRY_DECODE_ARCH, DRY_DECODE = "qwen3-4b", (8, 2048)
DRY_JAMBA_LAYERS = 8
DRY_MAX_LEN = 2048
DRY_STEPS = 3
DRY_PROMPT = {"jamba-v0.1-52b": (1, 1100), "qwen3-4b": (4, 300)}
DRY_MESHES = (("jamba-v0.1-52b", (1, 2)), ("jamba-v0.1-52b", (2, 1)),
              ("qwen3-4b", (1, 2)))
DRY_ARG_RTOL = 0.01
DRY_BOUND_FLOOR = 0.95
DRY_REMAT_TOL = 1e-6
DRY_DEADLINE_S, DRY_TIMEOUT_S = 600.0, 300.0


def dry_cfg(arch: str, configs, smoke: bool = False, dtype="float32"):
    """The phase's config of ``arch``: jamba cut to one period."""
    cfg = configs.get_smoke(arch) if smoke else configs.get_config(arch)
    if arch == "jamba-v0.1-52b" and not smoke:
        cfg = dataclasses.replace(cfg, n_layers=DRY_JAMBA_LAYERS)
    return dataclasses.replace(cfg, compute_dtype=dtype)


def census_diff(got: dict, want: dict) -> dict:
    return {k: (got.get(k, 0), want.get(k, 0))
            for k in sorted(set(got) | set(want))
            if got.get(k, 0) != want.get(k, 0)}


def traced(fn, *args, **kwargs):
    """(output, trace) of ``fn`` under an ``OpTrace``."""
    from repro_torch.core import op_analysis

    trace = op_analysis.OpTrace()
    return trace.run(fn, *args, **kwargs), trace


def dry_decode_fn(T):
    def fn(params, cfg, last, caches):
        logits, new = T.forward(params, cfg, last[:, None], caches=caches)
        return logits[:, -1].argmax(dim=-1).int(), new
    return fn


def dry_against_meta(label, real, meta, held, ms, mf, chips=1) -> tuple:
    """Gates and log lines of one real trace against its meta trace:
    returns (failures, summary)."""
    from repro_torch.core import op_analysis, roofline

    failed = []
    got = op_analysis.op_census(real, include_free=False)
    want = op_analysis.op_census(meta, include_free=False)
    if got != want:
        failed.append(f"{label}: the card's census differs from the meta "
                      f"trace's: {census_diff(got, want)}")
    f_real, f_meta = (op_analysis.trace_flops(t) for t in (real, meta))
    if f_real != f_meta:
        failed.append(f"{label}: FLOPs {f_real:.6e} on the card, "
                      f"{f_meta:.6e} traced on meta")
    mem = op_analysis.memory_analysis_bytes(meta)
    arg = mem["argument_bytes"]
    if abs(arg - held) > DRY_ARG_RTOL * held:
        failed.append(f"{label}: argument bytes {arg:.6e} against "
                      f"{held:.6e} allocated by the build")
    terms = roofline.terms_from_trace(label, "", "1", chips, meta, mf)
    bound_ms = terms.step_time_overlapped_s * 1e3
    if ms < DRY_BOUND_FLOOR * bound_ms:
        failed.append(f"{label}: {ms:.4f} ms measured, under "
                      f"{DRY_BOUND_FLOOR} x its roofline bound "
                      f"{bound_ms:.4f} ms: the count is wrong")
    log(f"  {label}: {len(real.ops)} ops on the card, {len(meta.ops)} on "
        f"meta; census of {sum(got.values())} data-moving ops "
        f"{'equal' if got == want else 'DIFFERS'}; FLOPs {f_real:.6e} card "
        f"/ {f_meta:.6e} meta; argument bytes {arg:.6e} traced / "
        f"{held:.6e} allocated ({100 * (arg / held - 1):+.3f} %); "
        f"measured {ms:.4f} ms against the roofline {bound_ms:.4f} ms "
        f"({terms.dominant}: compute {terms.compute_s * 1e3:.4f}, memory "
        f"{terms.memory_s * 1e3:.4f}, collective "
        f"{terms.collective_s * 1e3:.4f} ms; traced bytes "
        f"{op_analysis.trace_bytes(meta):.6e})")
    return failed, dict(ops=len(real.ops), flops=f_real, argument=arg,
                        held=held, temp=mem["temp_bytes"], ms=ms,
                        bound_ms=bound_ms, dominant=terms.dominant)


def dry_trace_train(dev, configs, T, steps) -> tuple:
    """(a), the train step: real on the card, then on meta."""
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.optim import adamw

    cfg = dry_cfg(DRY_TRAIN_ARCH, configs)
    b, s = DRY_TRAIN
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    state = steps.init_state(cfg, seed=0, device=dev).tree()
    tokens, labels = SyntheticLMData(DataConfig(
        vocab=cfg.vocab, seq_len=s, global_batch=b)).batch_at(0)
    batch = {"tokens": torch.from_numpy(tokens).to(dev),
             "labels": torch.from_numpy(labels).to(dev)}
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    step = steps.make_train_step(cfg)
    step(state, batch)                                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, real = traced(step, state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    # One step a spin: the host issues about 15,000 ops a step.
    ms = time_ms(lambda i: step(state, batch), 1, iters=1, spin=True)
    del state, batch
    torch.cuda.empty_cache()
    meta = torch.device("meta")
    params = T.param_shapes(cfg)
    mstate = steps.TrainState(params=params, opt=adamw.adamw_init(params),
                              step=torch.zeros((), dtype=torch.int32,
                                               device=meta)).tree()
    mbatch = {k: torch.zeros((b, s), dtype=torch.int32, device=meta)
              for k in ("tokens", "labels")}
    _, mtrace = traced(steps.make_train_step(cfg), mstate, mbatch)
    mf = T.model_flops(cfg, b, s, mode="train")
    failed, summary = dry_against_meta(
        f"{cfg.name} fp32 train step {b} x {s}", real, mtrace, held, ms, mf)
    summary["peak"] = peak
    log(f"    argument + temp traced {(summary['argument'] + summary['temp']) / 2**30:.2f} "
        f"GiB against max_memory_allocated {peak / 2**30:.2f} GiB (logged)")
    return failed, summary


def dry_trace_decode(dev, configs, T) -> tuple:
    """(a), the decode step: real on the card, then on meta."""
    cfg = dry_cfg(DRY_DECODE_ARCH, configs, dtype="bfloat16")
    b, rows = DRY_DECODE
    fn = dry_decode_fn(T)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    caches = T.init_caches(cfg, b, rows, device=dev)
    caches[0]["index"].fill_(rows - 1)      # every row read, as on meta
    last = torch.zeros((b,), dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    with torch.no_grad():
        fn(params, cfg, last, caches)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _, real = traced(fn, params, cfg, last, caches)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        # Two steps a spin: the host issues about 5,000 ops a step (some
        # 76 ms), and two fit under the longest spin time_ms tries.
        ms = time_ms(lambda i: fn(params, cfg, last, caches), 1, iters=2,
                     spin=True)
    del params, caches
    torch.cuda.empty_cache()
    meta = torch.device("meta")
    with torch.no_grad():
        _, mtrace = traced(
            fn, T.init_params(cfg, torch.Generator(), device=meta), cfg,
            torch.zeros((b,), dtype=torch.int32, device=meta),
            T.init_caches(cfg, b, rows, device=meta))
    mf = T.model_flops(cfg, b, 1, mode="inference", cache_len=rows)
    failed, summary = dry_against_meta(
        f"{cfg.name} bf16 decode b {b} against {rows} rows", real, mtrace,
        held, ms, mf)
    summary["peak"] = peak
    log(f"    argument + temp traced {(summary['argument'] + summary['temp']) / 2**30:.2f} "
        f"GiB against max_memory_allocated {peak / 2**30:.2f} GiB (logged)")
    return failed, summary


def dry_calls(T, params, cfg, prompt, steps_, caches):
    """A prefill of ``prompt`` and one decode step a row of ``steps_``;
    the last position's logits of each call, on the device."""
    out = []
    logits, caches = T.forward(params, cfg, prompt, caches=caches)
    out.append(logits[:, -1])
    for tok in steps_:
        logits, caches = T.forward(params, cfg, tok[:, None], caches=caches)
        out.append(logits[:, -1])
    return out


def host(logits) -> list:
    return [x.float().cpu().numpy() for x in logits]


def dry_inputs(cfg, arch):
    b, s = DRY_PROMPT[arch]
    rng = np.random.RandomState(26)
    prompt = rng.randint(0, cfg.vocab, (b, s)).astype(np.int64)
    steps_ = rng.randint(0, cfg.vocab, (DRY_STEPS, b)).astype(np.int64)
    return prompt, steps_


def dry_rank(rank: int, world: int, spec: dict) -> dict:
    """Phase 26 (b) on one rank (``launch.mesh.run_ranks`` spawned it):
    each case of DRY_MESHES on its mesh, this rank's shard of the bf16
    weights (built one rank at a time from the same seed, so that one
    card holds a whole copy once) and of the contiguous caches, its slots
    of the prompt: the calls in fp32 compute under an ``OpTrace``, then
    in bf16. Returns each case's rows, logits and census."""
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.core import op_analysis
    from repro_torch.dist import sharding
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import transformer as T

    dev = mesh_lib.rank_device(rank, spec["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    out = []
    for arch, shape in spec["meshes"]:
        mesh = mesh_lib.make_mesh(shape, ("data", "model"))
        ruleset = sharding.Ruleset(mesh=mesh, rules={"cache_seq": "data"})
        cfg = dry_cfg(arch, configs, spec["smoke"])
        local = None
        for turn in range(world):
            if turn == rank:
                full = T.init_params(
                    cfg, torch.Generator(device=dev).manual_seed(0),
                    device=dev, dtype=torch.bfloat16)
                local = sharding.shard_tree(full, mesh, ruleset)
                del full
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
            dist.barrier()
        prompt, steps_ = dry_inputs(cfg, arch)
        b = prompt.shape[0]
        (rows,), (spec_b,) = sharding.local_shape(ruleset, ("batch",), (b,))
        r0 = 0 if spec_b is None else sharding._block(spec_b, mesh)[2] * rows
        p = torch.from_numpy(prompt[r0:r0 + rows]).to(dev)
        st = torch.from_numpy(steps_[:, r0:r0 + rows]).to(dev)
        case = {"rows": (r0, rows), "spec": list(T.cache_spec(
            ruleset, "k", (b, DRY_MAX_LEN, cfg.n_kv_heads, cfg.dhead)))}
        # bf16 first, untraced: it also sizes the kernels' zeroed
        # counters, so the traced fp32 calls allocate none.
        ops.reset_launches()
        for dtype in ("bfloat16", "float32"):
            c = dataclasses.replace(cfg, compute_dtype=dtype)
            caches = T.init_caches(c, b, DRY_MAX_LEN, device=dev,
                                   ruleset=ruleset)
            with torch.no_grad(), sharding.use_ruleset(ruleset):
                if dtype == "float32":
                    logits, trace = traced(dry_calls, T, local, c, p, st,
                                           caches)
                    case["census"] = op_analysis.op_census(
                        trace, include_free=False)
                    case["flops"] = op_analysis.trace_flops(trace)
                else:
                    logits = dry_calls(T, local, c, p, st, caches)
            case[dtype] = host(logits)
            del caches, logits
        case["launches"] = {k: v for k, v in ops.LAUNCHES.items() if v}
        out.append(case)
        del local
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        dist.barrier()
    return out


def dry_fake_census(arch, shape, rank, world, smoke, configs, T) -> tuple:
    """The fake-group trace of rank ``rank``'s calls on meta: (census of
    the ops that move data, FLOPs)."""
    from repro_torch.core import op_analysis
    from repro_torch.dist import sharding
    from repro_torch.launch import mesh as mesh_lib

    meta = torch.device("meta")
    with mesh_lib.fake_group(world, rank=rank):
        mesh = mesh_lib.make_mesh(shape, ("data", "model"))
        ruleset = sharding.Ruleset(mesh=mesh, rules={"cache_seq": "data"})
        cfg = dry_cfg(arch, configs, smoke)
        local = sharding.shard_tree(T.init_params(
            cfg, torch.Generator(), device=meta, dtype=torch.bfloat16),
            mesh, ruleset)
        b, s = DRY_PROMPT[arch]
        rows = sharding.local_shape(ruleset, ("batch",), (b,))[0][0]
        caches = T.init_caches(cfg, b, DRY_MAX_LEN, device=meta,
                               ruleset=ruleset)
        p = torch.zeros((rows, s), dtype=torch.int64, device=meta)
        st = torch.zeros((DRY_STEPS, rows), dtype=torch.int64, device=meta)
        with torch.no_grad(), sharding.use_ruleset(ruleset):
            _, trace = traced(dry_calls, T, local, cfg, p, st, caches)
    return (op_analysis.op_census(trace, include_free=False),
            op_analysis.trace_flops(trace))


def dry_one_rank(dev, configs, T) -> dict:
    """One rank's logits of each arch of DRY_MESHES, fp32 and bf16
    compute over the same bf16 weights, before the ranks start."""
    want = {}
    for arch in dict(DRY_MESHES):
        cfg = dry_cfg(arch, configs)
        params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                               device=dev, dtype=torch.bfloat16)
        prompt, steps_ = dry_inputs(cfg, arch)
        p, st = (torch.from_numpy(x).to(dev) for x in (prompt, steps_))
        want[arch] = {}
        for dtype in ("float32", "bfloat16"):
            c = dataclasses.replace(cfg, compute_dtype=dtype)
            with torch.no_grad():
                want[arch][dtype] = host(dry_calls(
                    T, params, c, p, st, T.init_caches(
                        c, prompt.shape[0], DRY_MAX_LEN, device=dev)))
        del params
        torch.cuda.empty_cache()
    return want


def dry_lse(dev, ops, ref, cost) -> tuple:
    """The decode kernel's ``return_lse`` against its plain version, fp32
    and bf16, ragged lengths with a 0; its time at (a)'s decode shape
    (qwen3-4b's attention, b 8 against 2,048 rows, every row live) beside
    the default launch, SDPA and the bound."""
    failed, out = [], {}
    gen = torch.Generator(device=dev).manual_seed(26)
    b, rows = DRY_DECODE
    for dtype in (torch.float32, torch.bfloat16):
        rnd = lambda *s: torch.randn(*s, generator=gen, device=dev).to(dtype)  # noqa: E731
        q, k, v = rnd(b, H, D), rnd(b, rows, KVH, D), rnd(b, rows, KVH, D)
        lens = torch.tensor([0, 1, 255, 256, 700, 1500, rows - 1, rows],
                            dtype=torch.int32, device=dev)
        o, lse = ops.flash_decode(q, k, v, lens, return_lse=True)
        wo, wl = ref.flash_decode(q, k, v, lens, return_lse=True)
        ok_o, err_o = ref.compare(o, wo)
        live = lens > 0
        ok_l, err_l = ref.compare(lse[live], wl[live])
        zero = bool(torch.isneginf(lse[~live]).all())
        same = torch.equal(o, ops.flash_decode(q, k, v, lens))
        if not (ok_o and ok_l and zero and same):
            failed.append(f"flash_decode return_lse {dtype}: out err "
                          f"{err_o:.3e}, lse err {err_l:.3e}, zero-length "
                          f"lse -inf {zero}, output equal to the default "
                          f"launch's {same}")
        log(f"  flash_decode(return_lse=True) [{dtype}]: out max_abs_err "
            f"{err_o:.3e}, lse max_abs_err {err_l:.3e} (ref.TOLERANCE "
            f"{ref.TOLERANCE[dtype]}), -inf at length 0 {zero}, output "
            f"bit-equal to the default launch {same}")
        out[str(dtype)] = max(err_o, err_l)
    dtype = torch.bfloat16
    n_sets = 4
    sets = [tuple(torch.randn(*s, generator=gen, device=dev).to(dtype)
                  for s in ((b, H, D), (b, rows, KVH, D), (b, rows, KVH, D)))
            for _ in range(n_sets)]
    full = torch.full((b,), rows, dtype=torch.int32, device=dev)
    views = [(s[0][:, :, None, :],) + tuple(t.permute(0, 2, 1, 3).contiguous()
                                          for t in s[1:]) for s in sets]
    r = dict(
        ms=time_ms(lambda i: ops.flash_decode(*sets[i], full,
                                              return_lse=True), n_sets),
        default_ms=time_ms(lambda i: ops.flash_decode(*sets[i], full),
                           n_sets),
        device_ms=time_ms(lambda i: ops.flash_decode(
            *sets[i], full, return_lse=True), n_sets, spin=True),
        default_device_ms=time_ms(lambda i: ops.flash_decode(*sets[i], full),
                                  n_sets, spin=True),
        plain_ms=time_ms(lambda i: ref.flash_decode(*sets[i], full,
                                                    return_lse=True),
                         n_sets, iters=10),
        library_ms=time_ms(lambda i: F.scaled_dot_product_attention(
            *views[i], enable_gqa=True), n_sets))
    nbytes, flops = cost.flash_decode(b, H, KVH, D, 2, b * rows, lse=True)
    r["bound_ms"], r["bound_by"] = bound(nbytes, flops, dtype)
    log(f"  flash_decode(return_lse=True) [b={b} h={H} kvh={KVH} d={D} "
        f"rows={rows}, every row live, bf16]: kernel {r['ms']:.4f} ms "
        f"(default launch {r['default_ms']:.4f} ms); device time "
        f"{r['device_ms']:.4f} ms (default {r['default_device_ms']:.4f} ms);"
        f" plain {r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms, "
        f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}: "
        f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)")
    out["timing"] = r
    return failed, out


def dry_remat(dev, configs, steps) -> tuple:
    """(c): qwen2-0.5b's fp32 gradients with each remat policy against
    none, the same weights and batch; peak memory and time logged."""
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_items

    cfg = dry_cfg(DRY_TRAIN_ARCH, configs)
    b, s = DRY_TRAIN
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev, dtype=torch.float32)
    tokens, labels = SyntheticLMData(DataConfig(
        vocab=cfg.vocab, seq_len=s, global_batch=b)).batch_at(0)
    batch = {"tokens": torch.from_numpy(tokens).to(dev),
             "labels": torch.from_numpy(labels).to(dev)}
    runs, failed = {}, []
    # Each policy twice, in turns; the second reading is kept.
    for name, upd in 2 * (("none", {}), ("full", {"remat": True}),
                          ("dots", {"remat": True,
                                    "remat_policy": "dots"})):
        fn = steps.make_grad_fn(dataclasses.replace(cfg, **upd))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        loss, _, grads, _ = fn(params, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() - base
        runs[name] = (float(loss), dict(tree_items(grads)), ms, peak)
        log(f"  remat {name}: loss {float(loss):.8f}, {ms:.1f} ms for the "
            f"loss and gradients, peak {peak / 2**30:.2f} GiB above the "
            f"weights")
    loss0, g0 = runs["none"][:2]
    for name in ("full", "dots"):
        loss, g = runs[name][:2]
        worst = max(float((g[k] - g0[k]).abs().max())
                    / max(float(g0[k].abs().max()), 1e-30) for k in g0)
        rel = abs(loss - loss0) / abs(loss0)
        if rel > DRY_REMAT_TOL or worst > DRY_REMAT_TOL:
            failed.append(f"remat {name}: loss off by {rel:.3e}, a gradient "
                          f"by {worst:.3e} of its leaf's largest element")
        log(f"  remat {name} against none: loss {rel:.3e} relative, "
            f"gradients {worst:.3e} of each leaf's largest at worst "
            f"(gate {DRY_REMAT_TOL})")
    del params, batch, runs
    torch.cuda.empty_cache()
    return failed, {}


def run_dry(dev, ops, ref, configs, T, steps) -> dict:
    """Phase 26."""
    from repro_torch.kernels import cost
    from repro_torch.launch import mesh as mesh_lib

    from repro_torch.core import hwmodel

    summary, failed = {}, []
    t0 = time.perf_counter()
    summary["total_memory"] = torch.cuda.get_device_properties(0).total_memory
    log(f"  total_memory {summary['total_memory']} B "
        f"({summary['total_memory'] / 2**30:.2f} GiB) against the data "
        f"sheet's {hwmodel.H100.hbm_bytes} B (hwmodel.H100.hbm_bytes)")
    f, summary["train"] = dry_trace_train(dev, configs, T, steps)
    failed += f
    f, summary["decode"] = dry_trace_decode(dev, configs, T)
    failed += f
    f, summary["lse"] = dry_lse(dev, ops, ref, cost)
    failed += f
    f, _ = dry_remat(dev, configs, steps)
    failed += f
    want = dry_one_rank(dev, configs, T)
    torch.cuda.empty_cache()
    spec = dict(device="cuda", smoke=False, meshes=DRY_MESHES)
    t1 = time.perf_counter()
    ranks = mesh_lib.run_ranks(dry_rank, 2, args=(spec,),
                               deadline_s=DRY_DEADLINE_S,
                               timeout_s=DRY_TIMEOUT_S, threads=1)
    summary["ranks_s"] = time.perf_counter() - t1
    failed += dry_mesh_verdicts(ranks, want, configs, T, summary)
    summary["s"] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("; ".join(failed))
    return summary


def dry_mesh_verdicts(ranks, want, configs, T, summary,
                      smoke: bool = False) -> list:
    """(b)'s gates over the ranks' results."""
    failed = []
    for j, (arch, shape) in enumerate(DRY_MESHES):
        label = f"{arch} over {shape}"
        for rank, got in enumerate(r[j] for r in ranks):
            r0, n = got["rows"]
            for dtype in ("float32", "bfloat16"):
                errs = [float(np.abs(g - w[r0:r0 + n]).max()) for g, w in
                        zip(got[dtype], want[arch][dtype])]
                if dtype == "float32" and max(errs) > FP32_LOGIT_TOL:
                    failed.append(f"{label} rank {rank}: fp32 logits "
                                  f"{max(errs):.3e} from one rank's")
                log(f"  {label} rank {rank} rows [{r0}, {r0 + n}) cache "
                    f"spec {got['spec']}: {dtype} logits of the prefill "
                    f"and {DRY_STEPS} decode steps against one rank's, max "
                    f"|diff| {', '.join(f'{e:.3e}' for e in errs)}"
                    + (f" (gate {FP32_LOGIT_TOL})" if dtype == "float32"
                       else " (logged)"))
            cfg = dry_cfg(arch, configs, smoke)
            kinds = [cfg.kind(i) for i in range(cfg.n_layers)]
            want_launches = {k: v for k, v in {
                "flash_decode": 2 * DRY_STEPS * sum(
                    k in ("attn", "cross") for k in kinds),
                "ssd_scan": 2 * kinds.count("mamba")}.items() if v}
            if not smoke and got["launches"] != want_launches:
                failed.append(f"{label} rank {rank}: launches "
                              f"{got['launches']}, want {want_launches}")
            log(f"  {label} rank {rank}: launches {got['launches']} in the "
                f"bf16 and fp32 calls (want {want_launches})")
            census, flops = dry_fake_census(arch, shape, rank,
                                            len(ranks), smoke, configs, T)
            if census != got["census"] or flops != got["flops"]:
                failed.append(f"{label} rank {rank}: the card's census "
                              f"differs from its fake-group trace: "
                              f"{census_diff(got['census'], census)}, FLOPs "
                              f"{got['flops']:.6e} / {flops:.6e}")
            log(f"  {label} rank {rank}: census of "
                f"{sum(got['census'].values())} data-moving ops and "
                f"{got['flops']:.6e} FLOPs on the card, "
                f"{'equal to' if census == got['census'] else 'NOT'} its "
                f"fake-group trace on meta ({flops:.6e} FLOPs)")
    return failed


# ----------------------------------------------------------------------------
# Phase 27: the reference's attention and cache knobs on the card
# ----------------------------------------------------------------------------
# (a) qwen2-0.5b whole, bf16 compute over fp32 masters, the train step at
# 4 x 512 with fp32 and bf16 softmax probabilities (``attn_probs_fp32``
# True, False), in turns, twice each, each run from the same seeded state
# and batch (the least of KNOB_STEPS steps' ms and max_memory_allocated
# logged; the loss is the first step's, on the seeded weights); the
# losses finite
# and the bf16-probability loss within KNOB_LOSS_RTOL of the fp32 one
# (the modes differ by one bf16 rounding of each probability, 2^-8
# relative; the loss, a mean of 2,048 log-softmaxes, may move by at most
# twice that); each mode's op census and FLOPs on the card equal to its
# meta trace, and its traced argument + temp bytes within KNOB_MEM_RTOL
# of max_memory_allocated. (b) qwen3-4b at full width, bf16, the cached
# contiguous forward at b 8 against 2,048 live rows of int8 caches:
# argument bytes traced within KNOB_ARG_RTOL of what the build allocated,
# census equal, ``flash_decode`` launched once a layer a step on the cast
# cache and within ref.TOLERANCE of its plain version there, a planted K
# row saturating on the card as the reference's cast does. (c)
# ``expand_kv`` on qwen3-4b at full width, fp32: the cache-less plain
# forward and the contiguous prefill (masked ``sdpa``) within
# KNOB_EXPAND_TOL of the flag off, the contiguous engine's decode
# launching ``flash_decode`` once a layer a step under the flag, and the
# paged engine's chunks and decode steps their paged kernels. (d) fp32:
# ``attn_probs_fp32`` False bit-equal to True.
KNOB_TRAIN_ARCH, KNOB_TRAIN = "qwen2-0.5b", (4, 512)
KNOB_DECODE_ARCH, KNOB_DECODE = "qwen3-4b", (8, 2048)
KNOB_LOSS_RTOL = 2.0 ** -7
KNOB_MEM_RTOL = 0.03
KNOB_ARG_RTOL = 0.005
KNOB_EXPAND_TOL = 1e-5
KNOB_CACHELESS, KNOB_PROMPT = (2, 512), (2, 300)
KNOB_REQUESTS, KNOB_NEW = 8, 16
KNOB_STEPS = 3                   # timed train steps a run, the least kept
# A K row planted on the card, and what the reference's cast makes of it
# in bf16 (127.9 rounds to 128 first).
KNOB_PLANTED = (300.0, -300.0, 127.9, -127.9, float("nan"))
KNOB_SATURATED = [127, -128, 127, -128, 0]


def score_bytes(trace, s: int) -> int:
    """Bytes of the (b, kvh, group, s, s) results of a trace: the plain
    ``sdpa``'s scores, probabilities and their temporaries."""
    sizes = {}
    total = 0
    for op in trace.ops:
        for shape, dtype in op.results:
            if len(shape) == 5 and shape[-2:] == (s, s):
                if dtype not in sizes:
                    sizes[dtype] = torch.empty(
                        (), dtype=getattr(torch, dtype)).element_size()
                total += math.prod(shape) * sizes[dtype]
    return total


def knob_train(dev, configs, T, steps) -> tuple:
    """(a): the bf16 train step with each softmax mode."""
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.optim import adamw

    b, s = KNOB_TRAIN
    base_cfg = dataclasses.replace(configs.get_config(KNOB_TRAIN_ARCH),
                                   compute_dtype="bfloat16")
    tokens, labels = SyntheticLMData(DataConfig(
        vocab=base_cfg.vocab, seq_len=s, global_batch=b)).batch_at(0)
    failed, runs, out = [], {True: [], False: []}, {}
    # Each mode twice, in turns: a first run meets the allocator cold.
    # The step writes its state in place and returns it, and a trace
    # holds its arguments: each is dropped before the next count.
    for fp32 in (True, False, True, False):
        cfg = dataclasses.replace(base_cfg, attn_probs_fp32=fp32)
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        state = steps.init_state(cfg, seed=0, device=dev).tree()
        batch = {"tokens": torch.from_numpy(tokens).to(dev),
                 "labels": torch.from_numpy(labels).to(dev)}
        step = steps.make_train_step(cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for i in range(KNOB_STEPS):
            t0 = time.perf_counter()
            new_state, metrics = step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                loss = float(metrics["loss"])    # the seeded weights'
            del new_state, metrics
        ms = min(times)
        peak = torch.cuda.max_memory_allocated() - base
        del state
        runs[fp32].append((loss, ms, peak))
        log(f"  {cfg.name} bf16 train step {b} x {s}, attn_probs_fp32 "
            f"{fp32}: loss {loss:.6f}, {KNOB_STEPS} steps "
            f"{', '.join(f'{t:.1f}' for t in times)} ms (least kept), "
            f"max_memory_allocated {peak / 2**30:.2f} GiB above what was "
            f"held before the state")
        if len(runs[fp32]) == 2:
            # The second run of the mode is also traced on the card, from
            # a fresh state again.
            torch.cuda.empty_cache()
            state = steps.init_state(cfg, seed=0, device=dev).tree()
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated() - base
            torch.cuda.reset_peak_memory_stats()
            (new_state, _), real = traced(step, state, batch)
            torch.cuda.synchronize()
            tpeak = torch.cuda.max_memory_allocated() - base
            del state, new_state
            params = T.param_shapes(cfg)
            mstate = steps.TrainState(
                params=params, opt=adamw.adamw_init(params),
                step=torch.zeros((), dtype=torch.int32,
                                 device="meta")).tree()
            mbatch = {k: torch.zeros((b, s), dtype=torch.int32,
                                     device="meta")
                      for k in ("tokens", "labels")}
            _, mtrace = traced(steps.make_train_step(cfg), mstate, mbatch)
            f, summary = dry_against_meta(
                f"{cfg.name} bf16 train step, attn_probs_fp32 {fp32}",
                real, mtrace, held, ms, T.model_flops(cfg, b, s,
                                                      mode="train"))
            failed += f
            traced_bytes = summary["argument"] + summary["temp"]
            if abs(traced_bytes - tpeak) > KNOB_MEM_RTOL * tpeak:
                failed.append(f"attn_probs_fp32 {fp32}: argument + temp "
                              f"{traced_bytes:.6e} traced, "
                              f"max_memory_allocated {tpeak:.6e}")
            summary["scores"] = score_bytes(mtrace, s)
            log(f"    argument + temp traced {traced_bytes / 2**30:.2f} GiB "
                f"against max_memory_allocated {tpeak / 2**30:.2f} GiB "
                f"({100 * (traced_bytes / tpeak - 1):+.2f} %, gate "
                f"{100 * KNOB_MEM_RTOL:.0f} %); score-tensor bytes "
                f"{summary['scores']:.6e}")
            out[fp32] = summary
            del real, mtrace, mstate, params
        del batch, step
    torch.cuda.empty_cache()
    l32, l16 = runs[True][-1][0], runs[False][-1][0]
    if not all(math.isfinite(r[0]) for v in runs.values() for r in v):
        failed.append(f"a loss is not finite: {runs}")
    if abs(l16 - l32) > KNOB_LOSS_RTOL * abs(l32):
        failed.append(f"bf16-probability loss {l16:.6f} against fp32's "
                      f"{l32:.6f}: beyond {KNOB_LOSS_RTOL:.3e} relative")
    ratio = out[False]["scores"] / out[True]["scores"] if out.get(True) \
        and out[True]["scores"] else float("nan")
    log(f"  losses fp32 probabilities {l32:.6f}, bf16 {l16:.6f} "
        f"({abs(l16 - l32) / abs(l32):.3e} relative, gate "
        f"{KNOB_LOSS_RTOL:.3e}); second runs {runs[True][-1][1]:.1f} ms / "
        f"{runs[False][-1][1]:.1f} ms, peaks "
        f"{runs[True][-1][2] / 2**30:.2f} / {runs[False][-1][2] / 2**30:.2f}"
        f" GiB; score-tensor bytes bf16 / fp32 {ratio:.3f} (expected about "
        f"0.5); temp bytes traced {out[True]['temp'] / 2**30:.2f} / "
        f"{out[False]['temp'] / 2**30:.2f} GiB")
    return failed, dict(runs=runs, loss_rel=abs(l16 - l32) / abs(l32),
                        score_ratio=ratio,
                        temp={k: v["temp"] for k, v in out.items()})


def knob_saturation(dev, layers) -> list:
    """(b): a K row with KNOB_PLANTED written into an int8 cache on the
    card through the contiguous write (``layers._write_rows``), read back
    against the reference's values (bf16) and the CPU's cast (fp32)."""
    failed = []
    for dtype in (torch.bfloat16, torch.float32):
        row = torch.tensor(KNOB_PLANTED, dtype=torch.float32).to(dtype)
        want = layers.cast_to(row, torch.int8).tolist()
        k = torch.zeros((1, 2, 1, len(KNOB_PLANTED)), dtype=dtype,
                        device=dev)
        k[0, 1, 0] = row.to(dev)
        ck = torch.zeros((1, 4, 1, len(KNOB_PLANTED)), dtype=torch.int8,
                         device=dev)
        cv = torch.zeros_like(ck)
        layers._write_rows(ck, cv, k, k, torch.tensor([[1, 2]], device=dev))
        got = ck[0, 2, 0].cpu().tolist()
        wraps = row.to(dev).to(torch.int8).cpu().tolist()
        if got != want or (dtype == torch.bfloat16
                           and got != KNOB_SATURATED):
            failed.append(f"int8 write from {dtype}: {got} on the card, "
                          f"{want} on the CPU, want {KNOB_SATURATED}")
        log(f"  planted K row {list(KNOB_PLANTED)} from {dtype} written to "
            f"an int8 cache on the card: {got} (the CPU's cast {want}; a "
            f"plain .to(int8) on the card gives {wraps})")
    return failed


def knob_decode(dev, ops, ref, configs, T) -> tuple:
    """(b): qwen3-4b's bf16 decode step against int8 caches."""
    from repro_torch.models import layers
    from repro_torch.tree import tree_items

    failed = knob_saturation(dev, layers)
    cfg = dataclasses.replace(configs.get_config(KNOB_DECODE_ARCH),
                              compute_dtype="bfloat16")
    b, rows = KNOB_DECODE
    fn = dry_decode_fn(T)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    caches = T.init_caches(cfg, b, rows, device=dev, dtype=torch.int8)
    gen = torch.Generator(device=dev).manual_seed(27)
    for c in caches:
        # Small integers, as a qk-normed K rounds: every row live. In
        # place, so that no temporary moves the allocator's count.
        for name in ("k", "v"):
            c[name].random_(-4, 5, generator=gen)
    caches[0]["index"].fill_(rows - 1)
    last = torch.zeros((b,), dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    cache_b = sum(c[n].numel() * c[n].element_size()
                  for c in caches for n in ("k", "v"))
    tensor_b = sum(t.numel() * t.element_size() for t in
                   [t for _, t in tree_items(params)] + [last, caches[0][
                       "index"]] + [c[n] for c in caches for n in ("k", "v")])
    with torch.no_grad():
        fn(params, cfg, last, caches)
        caches[0]["index"].fill_(rows - 1)
        ops.reset_launches()
        fn(params, cfg, last, caches)
        torch.cuda.synchronize()
        launches = {k: v for k, v in ops.LAUNCHES.items() if v}
        caches[0]["index"].fill_(rows - 1)
        torch.cuda.reset_peak_memory_stats()
        _, real = traced(fn, params, cfg, last, caches)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base

        def step(i):
            caches[0]["index"].fill_(rows - 1)
            fn(params, cfg, last, caches)

        ms = time_ms(step, 1, iters=2, spin=True)
        q = torch.randn((b, cfg.n_heads, cfg.dhead), generator=gen,
                        device=dev).bfloat16()
        k, v = (caches[0][n].to(torch.bfloat16) for n in ("k", "v"))
        lens = torch.full((b,), rows, dtype=torch.int32, device=dev)
        ok, err = ref.compare(ops.flash_decode(q, k, v, lens),
                              ref.flash_decode(q, k, v, lens))
    want = {"flash_decode": cfg.n_layers}
    if launches != want:
        failed.append(f"int8-cache decode step launches {launches}, want "
                      f"{want}")
    if not ok:
        failed.append(f"flash_decode on the cast int8 cache: max_abs_err "
                      f"{err:.3e} beyond ref.TOLERANCE")
    log(f"  {cfg.name} bf16 decode b {b} against {rows} int8 rows: cache "
        f"{cache_b / 1e9:.4f} GB (bf16 would hold {2 * cache_b / 1e9:.4f}); "
        f"launches a step {launches} (want {want}); flash_decode on layer "
        f"0's cache cast to bf16 against its plain version: max_abs_err "
        f"{err:.3e} ({'within' if ok else 'BEYOND'} ref.TOLERANCE)")
    del params, caches, k, v
    torch.cuda.empty_cache()
    with torch.no_grad():
        _, mtrace = traced(
            fn, T.init_params(cfg, torch.Generator(), device="meta"), cfg,
            torch.zeros((b,), dtype=torch.int32, device="meta"),
            T.init_caches(cfg, b, rows, device="meta", dtype=torch.int8))
    f, summary = dry_against_meta(
        f"{cfg.name} bf16 decode against int8 caches", real, mtrace, held,
        ms, T.model_flops(cfg, b, 1, mode="inference", cache_len=rows))
    failed += f
    if abs(summary["argument"] - held) > KNOB_ARG_RTOL * held \
            or summary["argument"] != tensor_b:
        failed.append(f"int8 decode: argument bytes {summary['argument']:.6e}"
                      f" traced against {held:.6e} allocated (gate "
                      f"{KNOB_ARG_RTOL}) and {tensor_b:.6e} in the tensors "
                      f"(gate: equal)")
    log(f"    argument bytes traced {summary['argument']:.6e}: the build's "
        f"tensors hold {tensor_b:.6e} B, the allocator counts {held:.6e} "
        f"({100 * (summary['argument'] / held - 1):+.3f} %, gate "
        f"{100 * KNOB_ARG_RTOL:.1f} %)")
    log(f"    argument + temp traced "
        f"{(summary['argument'] + summary['temp']) / 2**30:.2f} GiB against "
        f"max_memory_allocated {peak / 2**30:.2f} GiB (logged)")
    summary.update(cache=cache_b, peak=peak, max_abs_err=err)
    return failed, summary


def knob_expand(dev, ops, configs, T, engine) -> tuple:
    """(c) and (d): qwen3-4b at full width in fp32 with ``expand_kv`` on
    and off, and with ``attn_probs_fp32`` off."""
    from repro_torch.serve.engine import ServeConfig

    failed, out = [], {}
    cfg = dataclasses.replace(configs.get_config(KNOB_DECODE_ARCH),
                              compute_dtype="float32")
    on = dataclasses.replace(cfg, expand_kv=True)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    rng = np.random.RandomState(27)
    tokens = torch.from_numpy(rng.randint(
        0, cfg.vocab, KNOB_CACHELESS).astype(np.int64)).to(dev)
    prompt = torch.from_numpy(rng.randint(
        0, cfg.vocab, KNOB_PROMPT).astype(np.int64)).to(dev)

    def prefill(c):
        caches = T.init_caches(c, KNOB_PROMPT[0], MAX_LEN,
                               per_slot_index=True, device=dev)
        return engine.prefill(params, c, prompt, caches)[0]

    with torch.no_grad():
        plain = T.forward(params, cfg, tokens)[0]
        expanded = T.forward(params, on, tokens)[0]
        bf16_probs = T.forward(params, dataclasses.replace(
            cfg, attn_probs_fp32=False), tokens)[0]
        pre_off, pre_on = prefill(cfg), prefill(on)
    for label, a, b_ in (("cache-less forward", expanded, plain),
                         ("contiguous prefill", pre_on, pre_off)):
        err = max_diff(a, b_)
        scale = max(1.0, float(b_.abs().max()))
        out[label] = err
        if err > KNOB_EXPAND_TOL * scale:
            failed.append(f"expand_kv {label}: logits {err:.3e} from the "
                          f"flag off (scale {scale:.3f})")
        log(f"  {cfg.name} fp32 {label}, expand_kv on against off: max "
            f"|diff| {err:.3e} (gate {KNOB_EXPAND_TOL} x {scale:.3f})")
    same = torch.equal(bf16_probs, plain)
    if not same:
        failed.append(f"fp32 compute: attn_probs_fp32 False moved the "
                      f"logits by {max_diff(bf16_probs, plain):.3e}")
    log(f"  {cfg.name} fp32 cache-less forward, attn_probs_fp32 False "
        f"bit-equal to True: {same}")
    del plain, expanded, bf16_probs, pre_off, pre_on
    torch.cuda.empty_cache()
    prompts = make_requests(cfg.vocab, KNOB_REQUESTS, lo=64, hi=512)
    scfg = ServeConfig(max_len=MAX_LEN, batch=B)
    streams = {}
    for c in (cfg, on, on, cfg):
        eng, launches, finished, tok_s = run_engine(
            f"{cfg.name} fp32 contiguous, expand_kv {c.expand_kv}", params,
            c, scfg, prompts, dev, ops, capture=False, max_new=KNOB_NEW)
        want = c.n_layers * eng.decode_steps
        if launches["flash_decode"] != want:
            failed.append(f"expand_kv {c.expand_kv}: {launches} in "
                          f"{eng.decode_steps} decode steps, want "
                          f"flash_decode {want}")
        streams[c.expand_kv] = finished
        out[f"tok_s_expand_{c.expand_kv}"] = tok_s
        del eng
    log(f"  greedy streams with expand_kv on equal to off: "
        f"{streams[True] == streams[False]} (logged)")
    # The paged engine under the flag: its prefill chunks and decode
    # steps keep the paged kernels.
    eng, launches, finished, _ = run_engine(
        f"{cfg.name} fp32 paged, expand_kv True", params, on,
        ServeConfig(max_len=MAX_LEN, batch=B, paged=True, page_size=PS,
                    chunk_size=CHUNK), prompts, dev, ops, capture=False,
        max_new=KNOB_NEW)
    want = {"flash_attention_paged": on.n_layers * eng.chunk_steps,
            "flash_decode_paged": on.n_layers * eng.decode_steps}
    got = {k: launches[k] for k in want}
    if got != want:
        failed.append(f"paged engine under expand_kv: launches {got}, "
                      f"want {want}")
    log(f"  paged engine under expand_kv: launches {got} (want {want}); "
        f"streams equal to the contiguous engine's: "
        f"{finished == streams[True]} (logged)")
    del eng, params
    torch.cuda.empty_cache()
    return failed, out


def run_knobs(dev, ops, ref, configs, T, steps, engine) -> dict:
    """Phase 27."""
    summary, failed = {}, []
    t0 = time.perf_counter()
    for name, part in (
            ("train", lambda: knob_train(dev, configs, T, steps)),
            ("int8_decode", lambda: knob_decode(dev, ops, ref, configs, T)),
            ("expand_kv", lambda: knob_expand(dev, ops, configs, T,
                                              engine))):
        t1 = time.perf_counter()
        f, summary[name] = part()
        failed += f
        log(f"  phase 27 {name}: {time.perf_counter() - t1:.1f} s")
        torch.cuda.empty_cache()
    summary["s"] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("; ".join(failed))
    return summary


# ----------------------------------------------------------------------------
# Phase 28: every tile of every attention wrapper, and the tile chooser
# ----------------------------------------------------------------------------

def _gathered(pools, table, rows=None):
    """The library yardstick's (b, kvh, rows, d) K/V views of each pool
    through the table (gathered untimed)."""
    from repro_torch.kernels import ref
    out = []
    for kp, vp in pools:
        out.append(tuple((t if rows is None else t[:, :rows])
                         .permute(0, 2, 1, 3).contiguous()
                         for t in ref.gather_kv(kp, vp, table)))
    return out


def tile_cases(dev, dtype, gen, ops, ref):
    """Phase 28's cases at one dtype: (wrapper, shape, the tile argument,
    the tiles the build instantiates, the chooser's pick, run(i, tile),
    plain(i), library(i), (bytes, operations), the layers cycled)."""
    from repro_torch.kernels import cost
    from repro_torch.kernels import flash_attention as prefill_mod
    from repro_torch.kernels import flash_decode as decode_mod

    es = torch.tensor([], dtype=dtype).element_size()
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev).to(dtype)  # noqa: E731
    n_layers, max_pages = 2, MAX_LEN // PS
    splits = decode_mod.SPLIT_ROWS_SET
    pools = [(rnd(N_PAGES, PS, KVH, D), rnd(N_PAGES, PS, KVH, D))
             for _ in range(n_layers)]
    cases = []

    def sdpa(q4, views, mask):
        return lambda i: F.scaled_dot_product_attention(
            q4, views[i][0], views[i][1], attn_mask=mask, enable_gqa=True)

    # qwen3-4b's chunk step: one 256-row chunk at start 1024.
    start, n_keys = TILE_CHUNK_START, TILE_CHUNK_START + CHUNK
    table = _tables(gen, dev, [n_keys], max_pages)
    st = torch.tensor([start], dtype=torch.int32, device=dev)
    qc = rnd(1, CHUNK, H, D)
    cmask = (torch.arange(n_keys, device=dev)[None, :]
             <= start + torch.arange(CHUNK, device=dev)[:, None])
    pairs = cost.causal_pairs(CHUNK, n_keys)
    cases.append(dict(
        wrapper="flash_attention_paged",
        shape=f"chunk b=1 sq={CHUNK} start={start}", arg="block_q",
        tiles=prefill_mod.BLOCK_QS,
        pick=ops.prefill_tile(qc, max_pages * PS, True).block_q,
        run=lambda i, t: ops.flash_attention_paged(qc, *pools[i], table, st,
                                                   block_q=t),
        plain=lambda i: ref.flash_attention_paged(qc, *pools[i], table, st),
        library=sdpa(qc.permute(0, 2, 1, 3).contiguous(),
                     _gathered(pools, table, n_keys), cmask),
        work=(2 * qc.numel() * es + 2 * n_keys * KVH * D * es
              + 4 * (-(-n_keys // PS) + 1), 4 * pairs * H * D)))
    # The verify step: B slots of SPEC_K + 1 rows from starts spread up to
    # the table's end.
    w = SPEC_K + 1
    starts = [int(x) for x in np.linspace(512, MAX_LEN - w, B)]
    vtable = _tables(gen, dev, [s + w for s in starts], max_pages)
    vst = torch.tensor(starts, dtype=torch.int32, device=dev)
    qv = rnd(B, w, H, D)
    vmask = (torch.arange(MAX_LEN, device=dev)[None, None, :]
             <= (vst[:, None] + torch.arange(w, device=dev)[None, :])
             [:, :, None])[:, None]
    pairs = sum(s + r + 1 for s in starts for r in range(w))
    cases.append(dict(
        wrapper="flash_attention_paged", shape=f"verify b={B} sq={w}",
        arg="block_q", tiles=prefill_mod.BLOCK_QS,
        pick=ops.prefill_tile(qv, max_pages * PS, True).block_q,
        run=lambda i, t: ops.flash_attention_paged(qv, *pools[i], vtable,
                                                   vst, block_q=t),
        plain=lambda i: ref.flash_attention_paged(qv, *pools[i], vtable,
                                                  vst),
        library=sdpa(qv.permute(0, 2, 1, 3).contiguous(),
                     _gathered(pools, vtable), vmask),
        work=(2 * qv.numel() * es
              + 2 * sum(s + w for s in starts) * KVH * D * es
              + 4 * (sum(-(-(s + w) // PS) for s in starts) + B),
              4 * pairs * H * D)))
    # The full-sequence kernel at the same two shapes: a 256-row causal
    # block over 1280 keys, and 5 rows over 1029.
    for b, sq, skv, label in ((1, CHUNK, n_keys, "chunk"),
                              (B, w, TILE_CHUNK_START + w, "verify")):
        q = rnd(b, sq, H, D)
        kv = [(rnd(b, skv, KVH, D), rnd(b, skv, KVH, D))
              for _ in range(n_layers)]
        mask = (torch.arange(skv, device=dev)[None, :]
                <= skv - sq + torch.arange(sq, device=dev)[:, None])
        views = [tuple(t.permute(0, 2, 1, 3).contiguous() for t in x)
                 for x in kv]
        cases.append(dict(
            wrapper="flash_attention",
            shape=f"{label} b={b} sq={sq} skv={skv} causal", arg="block_q",
            tiles=prefill_mod.BLOCK_QS,
            pick=ops.prefill_tile(q, skv, True).block_q,
            run=lambda i, t, q=q, kv=kv: ops.flash_attention(
                q, *kv[i], causal=True, block_q=t),
            plain=lambda i, q=q, kv=kv: ref.flash_attention(q, *kv[i],
                                                            causal=True),
            library=sdpa(q.permute(0, 2, 1, 3).contiguous(), views, mask),
            work=cost.flash_attention(b, sq, skv, H, KVH, D, es, True)))
    # The graphed decode's shape (phase 5: B slots, pages of PS, max_len
    # MAX_LEN), paged and contiguous, contexts over 512..2048.
    lengths = [int(x) for x in np.linspace(512, MAX_LEN, B)]
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    dmask = (torch.arange(MAX_LEN, device=dev)[None, :]
             < lens[:, None])[:, None, None, :]
    kv_rows = sum(lengths)
    pages_read = sum(-(-n // PS) for n in lengths)
    dtable = _tables(gen, dev, lengths, max_pages)
    for h, kvh, d, label, dpools in (
            (H, KVH, D, "graphed decode", pools),
            (PHI3_H, PHI3_KVH, PHI3_D, "phi3-mini MHA decode",
             [(rnd(N_PAGES, PS, PHI3_KVH, PHI3_D),
               rnd(N_PAGES, PS, PHI3_KVH, PHI3_D))
              for _ in range(n_layers)])):
        q = rnd(B, h, d)
        cases.append(dict(
            wrapper="flash_decode_paged",
            shape=f"{label} b={B} h={h} kvh={kvh} d={d} page={PS}",
            arg="block_k", tiles=splits,
            pick=ops.decode_tile(q, kvh, max_pages * PS, PS).block_k,
            run=lambda i, t, q=q, p=dpools: ops.flash_decode_paged(
                q, *p[i], dtable, lens, block_k=t),
            plain=lambda i, q=q, p=dpools: ref.flash_decode_paged(
                q, *p[i], dtable, lens),
            library=sdpa(q[:, :, None, :], _gathered(dpools, dtable), dmask),
            work=(2 * q.numel() * es + 2 * kv_rows * kvh * d * es
                  + 4 * (pages_read + B), 4 * kv_rows * h * d)))
    q = rnd(B, H, D)
    caches = [(rnd(B, MAX_LEN, KVH, D), rnd(B, MAX_LEN, KVH, D))
              for _ in range(n_layers)]
    cases.append(dict(
        wrapper="flash_decode",
        shape=f"graphed decode b={B} max_len={MAX_LEN}", arg="block_k",
        tiles=splits, pick=ops.decode_tile(q, KVH, MAX_LEN).block_k,
        run=lambda i, t: ops.flash_decode(q, *caches[i], lens, block_k=t),
        plain=lambda i: ref.flash_decode(q, *caches[i], lens),
        library=sdpa(q[:, :, None, :],
                     [tuple(t.permute(0, 2, 1, 3).contiguous() for t in c)
                      for c in caches], dmask),
        work=cost.flash_decode(B, H, KVH, D, es, kv_rows)))
    for c in cases:
        c["layers"] = n_layers
    return cases


def run_tiles(dev, ops, ref) -> dict:
    """Phase 28: each attention wrapper at each tile the build
    instantiates, at qwen3-4b's chunk and verify shapes (the paged and the
    full-sequence prefill), the graphed decode's (paged and contiguous)
    and phi3-mini's MHA decode, fp32 and bf16: held against its plain
    version, its device time (launches queued behind a spin), the bound
    (``kernels.cost``), the plain version's time, SDPA's device time, the
    launches, the chooser's pick and the measured fastest. One JSON line a
    tile (``tile {...}``) for ``PERF.md``."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(28)
    failed, rows, picks = [], [], {}
    for dtype in (torch.bfloat16, torch.float32):
        dt = "bf16" if dtype == torch.bfloat16 else "fp32"
        for c in tile_cases(dev, dtype, gen, ops, ref):
            want = c["plain"](0)
            plain_ms = time_ms(c["plain"], c["layers"], iters=5)
            lib_ms = time_ms(c["library"], c["layers"], spin=True)
            b_ms, b_by = bound(*c["work"], dtype)
            times = {}
            for t in c["tiles"]:
                ops.reset_launches()
                ok, err = ref.compare(c["run"](0, t), want)
                ms = time_ms(lambda i, t=t: c["run"](i, t), c["layers"],
                             spin=True)
                torch.cuda.synchronize()
                launches = ops.LAUNCHES[c["wrapper"]]
                if not ok or launches < 1:
                    failed.append((c["wrapper"], c["shape"], dt, t, err,
                                   launches))
                times[t] = ms
                rows.append(dict(
                    wrapper=c["wrapper"], shape=c["shape"], dtype=dt,
                    **{c["arg"]: t}, ms=ms, bound_ms=b_ms, bound_by=b_by,
                    plain_ms=plain_ms, library_ms=lib_ms,
                    launches=launches, max_abs_err=err, ok=ok,
                    picked=t == c["pick"]))
                log(f"  tile {json.dumps(rows[-1])}")
            fastest = min(times, key=times.get)
            key = f"{c['wrapper']} {c['shape']} {dt}"
            picks[key] = dict(pick=c["pick"], fastest=fastest,
                              over_fastest=times[c["pick"]] / times[fastest])
            log(f"  {key}: the chooser picks {c['arg']} {c['pick']} "
                f"({times[c['pick']]:.4f} ms), the fastest is {fastest} "
                f"({times[fastest]:.4f} ms): {picks[key]['over_fastest']:.3f}"
                f"x the fastest; bound {b_ms:.4f} ms ({b_by}), plain "
                f"{plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms")
        torch.cuda.empty_cache()
    if failed:
        raise RuntimeError(f"phase 28: a tile disagrees with its plain "
                           f"version or did not launch: {failed}")
    s = time.perf_counter() - t0
    log(f"  phase 28 took {s:.1f} s: {len(rows)} tiles, all within "
        f"ref.TOLERANCE of their plain versions")
    return {"tiles": len(rows), "picks": picks, "s": s}


def ssd_chunk_cases(chunk: int) -> tuple:
    """Phase 29's (bt, l) at one chunk: phase 3's, and lengths either side
    of one and two chunks."""
    extra = ((2, chunk - 1), (2, chunk), (2, chunk + 1), (2, 2 * chunk + 1))
    return tuple(dict.fromkeys(SSD_CASES + extra))


@contextlib.contextmanager
def mamba_chunk(chunk: int):
    """Every Mamba layer scans at ``MambaConfig.chunk`` = ``chunk`` (the
    registry's configurations leave it at the reference's 128)."""
    from repro_torch.configs import ModelConfig

    real = ModelConfig.mamba_cfg
    ModelConfig.mamba_cfg = \
        lambda self: dataclasses.replace(real(self), chunk=chunk)
    try:
        yield
    finally:
        ModelConfig.mamba_cfg = real


def check_chunks(dev, ops, ref, decode_mod) -> list:
    """Phase 29 (a): each chunk against the plain version at that chunk;
    returns failures."""
    from repro_torch.kernels import ssd_scan as ssd_mod

    gen = torch.Generator(device=dev).manual_seed(29)
    failures = []
    for chunk in ssd_mod.CHUNKS:
        cases = ssd_chunk_cases(chunk)
        for dtype in (torch.float32, torch.bfloat16):
            for shape in SSD_SHAPES:
                worst, n, same_all = 0.0, 0, True
                for bt, l in cases:
                    for h0 in (False, True):
                        x, a, b, c, h = ssd_inputs(gen, dev, dtype, bt, l,
                                                   h0, shape)
                        ops.reset_launches()
                        y, st = ops.ssd_scan(x, a, b, c, h0=h, chunk=chunk)
                        y2, st2 = ops.ssd_scan(x, a, b, c, h0=h, chunk=chunk)
                        torch.cuda.synchronize()
                        launches = ops.LAUNCHES["ssd_scan"]
                        wy, ws = ref.ssd_scan(x, a, b, c, h0=h, chunk=chunk)
                        (ok_y, err_y), (ok_s, err_s) = (
                            ref.compare(y, wy, normwise=True),
                            ref.compare(st, ws, normwise=True))
                        same = torch.equal(y, y2) and torch.equal(st, st2)
                        worst, n = max(worst, err_y, err_s), n + 1
                        same_all = same_all and same
                        if not (ok_y and ok_s and same and launches == 2):
                            failures.append(("ssd_scan", chunk, dtype, shape,
                                             bt, l, h0, err_y, err_s, same,
                                             launches))
                log(f"  ssd_scan chunk {chunk:3d} {str(dtype):14s} (h, p, n) "
                    f"{shape}: {n} cases (l in {sorted({l for _, l in cases})}"
                    f", zero and given state), worst max_abs_err {worst:.3e} "
                    f"(tolerance scaled by |y|, |state|), second launch "
                    f"{'bit-identical' if same_all else 'DIFFERS'}")
    left = [c for c in decode_mod._COUNTERS.values() if c.any()]
    log(f"  the hand-off's tickets and counts after these launches: "
        f"{'all zero' if not left else 'NOT ZERO'}; "
        f"{len(failures)} failures")
    if left:
        failures.append(("ssd_scan tickets or counts left non-zero", left))
    return failures


def time_chunks(dev, ops, ref) -> list:
    """Phase 29 (b): each chunk's device time at l SSD_L, both head shapes,
    bf16 and fp32, beside its bound, the host-paced time and the plain
    version's; one ``chunk {...}`` JSON line each."""
    from repro_torch.kernels import ssd_scan as ssd_mod

    gen = torch.Generator(device=dev).manual_seed(290)
    rows = []
    for shape in SSD_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            es = torch.tensor([], dtype=dtype).element_size()
            sets = [ssd_inputs(gen, dev, dtype, 1, SSD_L, shape=shape)[:4]
                    for _ in range(12)]
            for chunk in ssd_mod.CHUNKS:
                y, st = ops.ssd_scan(*sets[0], chunk=chunk)
                wy, ws = ref.ssd_scan(*sets[0], chunk=chunk)
                (ok_y, err_y), (ok_s, err_s) = (
                    ref.compare(y, wy, normwise=True),
                    ref.compare(st, ws, normwise=True))
                run = lambda i, c=chunk: ops.ssd_scan(*sets[i], chunk=c)  # noqa: E731
                nbytes, n_ops = ssd_work(SSD_L, es, shape, chunk)
                b_ms, b_by = bound(nbytes, n_ops, dtype)
                device_ms = time_ms(run, len(sets), spin=True)
                rows.append(dict(
                    shape=f"bt=1 l={SSD_L} (h, p, n)={shape}",
                    dtype="bf16" if dtype == torch.bfloat16 else "fp32",
                    chunk=chunk, device_ms=device_ms,
                    ms=time_ms(run, len(sets)),
                    plain_ms=time_ms(lambda i, c=chunk: ref.ssd_scan(
                        *sets[i], chunk=c), len(sets), iters=10),
                    bound_ms=b_ms, bound_by=b_by,
                    bound_share=b_ms / device_ms,
                    max_abs_err=max(err_y, err_s), ok=ok_y and ok_s,
                    grid=ssd_grid(1, SSD_L, shape, chunk)))
                log(f"  chunk {json.dumps(rows[-1])}")
            del sets
    return rows


def serve_chunks(dev, ops, ref, configs, T) -> dict:
    """Phase 29 (c) and (d): mamba2-370m at full width served at each
    chunk; its first layers in fp32 at chunk 64 against 128, the plain
    version and the planted fault."""
    from repro_torch.kernels import ssd_scan as ssd_mod
    from repro_torch.serve.engine import ServeConfig

    cfg, params = init_model("mamba2-370m", configs, T, dev)
    prompts = make_requests(cfg.vocab, CHUNK_PROMPTS, lo=64, hi=512) + \
        make_requests(cfg.vocab, 1, lo=1031, hi=1031)
    log(f"  prompt lengths {[len(p) for p in prompts]}, {CHUNK_NEW} new "
        f"each, graphed")
    ccfg = ServeConfig(max_len=MAX_LEN, batch=B, eos_id=-1)
    failed, out = [], {"launches": {}, "tok_s": {}}
    streams = {}
    # In turns, the default first and last: host-paced tok/s drifts
    # within a call.
    order = [SSD_CHUNK] + [c for c in sorted(ssd_mod.CHUNKS, reverse=True)
                           if c != SSD_CHUNK] + [SSD_CHUNK]
    for chunk in order:
        with mamba_chunk(chunk):
            eng, finished, wall, launches = serve(params, cfg, ccfg, prompts,
                                                  CHUNK_NEW, dev, ops)
        check_served(eng, finished, prompts, CHUNK_NEW, cfg.vocab)
        admissions = sum(eng.prefill_buckets.values())
        want = cfg.n_layers * admissions
        streams.setdefault(chunk, finished)
        same = sum(int(a == b) for r in finished
                   for a, b in zip(finished[r], streams[SSD_CHUNK][r]))
        out["launches"][chunk] = launches["ssd_scan"]
        tok_s = len(prompts) * CHUNK_NEW / wall
        out["tok_s"].setdefault(chunk, []).append(tok_s)
        log(f"  chunk {chunk}: {tok_s:.1f} tok/s ({wall:.2f} s, "
            f"{eng.ticks} ticks); ssd_scan launches {launches['ssd_scan']} "
            f"(want {cfg.n_layers} layers x {admissions} admissions); bf16 "
            f"greedy streams {same}/{len(prompts) * CHUNK_NEW} tokens equal "
            f"to chunk {SSD_CHUNK}'s first run (logged: the random 48-layer "
            f"stack is chaotic)")
        if launches["ssd_scan"] != want:
            failed.append(f"chunk {chunk}: ssd_scan launched "
                          f"{launches['ssd_scan']} times, want {want}")
        del eng
    torch.cuda.empty_cache()

    cut = dict(params, blocks=params["blocks"][:MAMBA_CHECK_LAYERS])
    f32cfg = dataclasses.replace(cfg, n_layers=MAMBA_CHECK_LAYERS,
                                 compute_dtype="float32")
    prompt = prompts[-1]
    logits = {}
    for chunk in (128, 64):
        with mamba_chunk(chunk):
            logits[chunk] = contiguous_logits(cut, f32cfg, T, dev, prompt)
    with mamba_chunk(64), kernel_ops(ops, ssd_scan=ref.ssd_scan):
        plain = contiguous_logits(cut, f32cfg, T, dev, prompt)
    with mamba_chunk(64), kernel_ops(ops, ssd_scan=ssd_no_carry(ops)):
        fault = contiguous_logits(cut, f32cfg, T, dev, prompt)
    for part, what in ((0, f"{len(prompt) - 1}-row prefill"),
                       (1, "decode step")):
        d128 = max_diff(logits[64][part], logits[128][part])
        dplain = max_diff(logits[64][part], plain[part])
        dfault = max_diff(fault[part], logits[64][part])
        log(f"  mamba2-370m first {MAMBA_CHECK_LAYERS} layers fp32 {what}: "
            f"max |logit diff| chunk 64 against 128 {d128:.3e}, against the "
            f"plain version at 64 {dplain:.3e} (limit {FP32_LOGIT_TOL:g}); "
            f"the state not carried {dfault:.3e}")
        out[f"fp32 {what}"] = dict(against_128=d128, against_plain=dplain,
                                   fault=dfault)
        if max(d128, dplain) > FP32_LOGIT_TOL:
            failed.append(f"{what}: chunk 64 {d128:.3e} from 128, "
                          f"{dplain:.3e} from plain")
    if out[f"fp32 {len(prompt) - 1}-row prefill"]["fault"] <= FP32_LOGIT_TOL:
        failed.append("the state not carried did not show in the prefill's "
                      "logits")
    fstreams = {}
    for chunk in (128, 64):
        with mamba_chunk(chunk):
            eng, fstreams[chunk], _, _ = serve(cut, f32cfg, ccfg, prompts,
                                               CHUNK_NEW, dev, ops)
        check_served(eng, fstreams[chunk], prompts, CHUNK_NEW, cfg.vocab)
        del eng
    diff = first_difference(fstreams[64], fstreams[128])
    log(f"  fp32 first {MAMBA_CHECK_LAYERS} layers, greedy streams at chunk "
        f"64 against 128: {'equal' if diff is None else f'DIFFER at {diff}'}")
    if diff is not None:
        failed.append(f"fp32 greedy streams at chunk 64 differ from 128's "
                      f"at {diff}")
    del params, cut
    torch.cuda.empty_cache()
    if failed:
        raise RuntimeError("phase 29: " + "; ".join(failed))
    return out


def run_chunks(dev, ops, ref, configs, T, decode_mod) -> dict:
    """Phase 29: the SSD scan at each chunk (``ops.ssd_scan(chunk=)``),
    (a) held to its plain version, (b) timed, (c) served through the
    mamba2-370m engine and (d) a dropped hand-off caught. Returns the
    ``kernels`` line's entries for the chunks other than the default
    (phase 9 runs 128), and a summary."""
    t0 = time.perf_counter()
    failures = check_chunks(dev, ops, ref, decode_mod)
    gen = torch.Generator(device=dev).manual_seed(291)
    x, a, b, c, _ = ssd_inputs(gen, dev, torch.float32, 1, 1031)
    fy, _ = ssd_no_carry(ops)(x, a, b, c, chunk=64)
    wy, _ = ref.ssd_scan(x, a, b, c, chunk=64)
    ok, err = ref.compare(fy, wy, normwise=True)
    log(f"  (d) the state not carried across chunks of 64, l 1031, fp32: "
        f"max_abs_err {err:.3e} against the plain version (must exceed "
        f"the tolerance)")
    if ok:
        failures.append(("the state not carried passed", err))
    if failures:
        raise RuntimeError(f"phase 29: a chunk disagrees with its plain "
                           f"version: {failures}")
    rows = time_chunks(dev, ops, ref)
    if not all(r["ok"] for r in rows):
        raise RuntimeError("phase 29: a timed chunk disagrees with its plain "
                           "version")
    torch.cuda.empty_cache()
    served = serve_chunks(dev, ops, ref, configs, T)
    kernels = {}
    for r in rows:
        if (r["shape"].endswith(str(SSD_SHAPES[0])) and r["dtype"] == "bf16"
                and r["chunk"] != SSD_CHUNK):
            kernels[f"ssd_scan chunk={r['chunk']}"] = dict(
                r, library_ms=None, launches=served["launches"][r["chunk"]])
    s = time.perf_counter() - t0
    log(f"  phase 29 took {s:.1f} s")
    return {"kernels": kernels, "served": served, "s": s,
            "device_ms": {f"{r['shape']} {r['dtype']} chunk {r['chunk']}":
                          r["device_ms"] for r in rows}}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs only on a CUDA card")
    from repro_torch import configs
    from repro_torch.core import autotune, card, dissect, hwmodel, latency
    from repro_torch.core import simulator
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import flash_decode as decode_mod
    from repro_torch.kernels import gemm as gemm_kernel
    from repro_torch.launch import autotune_gemm
    from repro_torch.launch import latency as latency_launch
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as T
    from repro_torch.serve import engine, sampling
    from repro_torch.serve.engine import ServeConfig
    from repro_torch.train import steps

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    log(f"card: {smi}; torch.cuda.get_device_name: "
        f"{torch.cuda.get_device_name(0)}")

    log("== build ==")
    t0 = time.perf_counter()
    lib = _build.build()
    log(f"  built {lib.name} from {[f.name for f in _build.sources()]} in "
        f"{time.perf_counter() - t0:.1f} s")
    report = ptxas_report((lib.parent / "build.log").read_text())
    for line in report:
        log(f"  ptxas: {line}")
    log(f"  toolchain: {toolchain(_build)}")
    failed = check_gemm_registers(report, gemm_kernel)
    if failed:
        raise RuntimeError(f"the GEMM tile chooser's registers differ from "
                           f"this build's: {failed}")

    if sys.argv[1:] == ["--phase", "29"]:
        # Phase 29 alone, after the build.
        summary = run_chunks(dev, ops, ref, configs, T, decode_mod)
        log(f"  phase 29 alone: {summary}")
        return

    if sys.argv[1:] == ["--phase", "28"]:
        # Phase 28 alone, after the build.
        summary = run_tiles(dev, ops, ref)
        log(f"  phase 28 alone: {summary}")
        return

    if sys.argv[1:] == ["--phase", "27"]:
        # Phase 27 alone, after the build.
        summary = run_knobs(dev, ops, ref, configs, T, steps, engine)
        log(f"  phase 27 alone: {summary}")
        return

    if sys.argv[1:] == ["--phase", "26"]:
        # Phase 26 alone, after the build.
        summary = run_dry(dev, ops, ref, configs, T, steps)
        log(f"  phase 26 alone: {summary}")
        return

    if sys.argv[1:] == ["--phase", "25"]:
        # Phase 25 alone, after the build.
        t0 = time.perf_counter()
        summary = run_ep(dev, ops, ref, configs, T, moe_mod)
        log(f"  phase 25 alone: {summary}; {time.perf_counter() - t0:.1f} s")
        return

    if sys.argv[1:] == ["--phase", "24"]:
        # Phase 24 alone, after the build.
        t0 = time.perf_counter()
        summary = run_train_dist(dev, ops, ref)
        log(f"  phase 24 alone: {summary}; {time.perf_counter() - t0:.1f} s")
        return

    if sys.argv[1:] == ["--phase", "23"]:
        # Phase 23 alone, after the build: for iterating on it; run
        # without arguments, the script runs every phase.
        t0 = time.perf_counter()
        tp = run_tp(dev, ops, ref, configs, T)
        tp["training"] = run_train_families(dev, ops, configs, T, steps)
        log(f"  phase 23 alone: {tp}; {time.perf_counter() - t0:.1f} s")
        return

    log("== kernels against their plain versions ==")
    failures = check_kernels(dev, ops, ref)
    failures += check_contiguous_kernels(dev, ops, ref, decode_mod)
    failures += check_decode_splits(dev, ops, ref, decode_mod)
    failures += check_probe_kernels(dev, ops, ref, latency, gemm_kernel)
    failures += check_timed_chase(dev, ops, ref, simulator)
    if failures:
        raise RuntimeError(f"kernels disagree with plain versions: {failures}")

    log("== times at the main path's shapes ==")
    timing = time_kernels(dev, ops, ref, decode_mod)
    torch.cuda.empty_cache()
    timing.update(time_probe_kernels(dev, ops, ref, latency, autotune,
                                     gemm_kernel))
    timing.update(time_timed_chase(dev, ops, ref))
    torch.cuda.empty_cache()
    log("  -- at phi3-mini's attention (head_dim 96, MHA) and jamba's SSD "
        "shape (d_state 16) --")
    family_timing = time_family_shapes(dev, ops, ref, decode_mod)
    if not all(r["ok"] for r in [*timing.values(), *family_timing.values()]):
        raise RuntimeError("a timed kernel disagrees with its plain version")
    torch.cuda.empty_cache()

    log("== engine: qwen3-4b at full width, paged ==")
    cfg, params = init_model("qwen3-4b", configs, T, dev)
    prompts = make_requests(cfg.vocab, N_REQUESTS)
    log(f"  prompt lengths: {[len(p) for p in prompts]}")
    scfg = ServeConfig(max_len=MAX_LEN, batch=B, paged=True, page_size=PS,
                       chunk_size=CHUNK, eos_id=-1)
    eng, launches, greedy, plain_tok_s = run_eager_and_graphed(
        "paged", params, cfg, scfg, prompts, dev, ops)
    if min(launches["flash_decode_paged"],
           launches["flash_attention_paged"]) <= 0:
        raise RuntimeError(f"paged path skipped a kernel: {launches}")
    main_launches = dict(launches)
    ticks = {"paged": eng.ticks}
    del eng
    torch.cuda.empty_cache()

    log("== engine: squeezed pool ==")
    squeezed = dataclasses.replace(scfg, n_pages=161)
    eng, finished, wall, _ = serve(params, cfg, squeezed, prompts, MAX_NEW,
                                   dev, ops)
    check_served(eng, finished, prompts, MAX_NEW, cfg.vocab)
    if eng.preemptions < 1:
        raise RuntimeError("squeezed pool ran without a preemption")
    log(f"  n_pages {squeezed.n_pages}, graphed: {len(finished)} requests "
        f"done in {wall:.2f} s, {eng.ticks} ticks, {eng.preemptions} "
        f"preemptions, {eng.admission_rejections} holds")
    del eng
    torch.cuda.empty_cache()

    log("== paged kernel path against plain path (same weights) ==")
    prompt = make_requests(cfg.vocab, 1, lo=300, hi=300)[0]
    f32cfg = dataclasses.replace(cfg, compute_dtype="float32")
    paths = paged_paths(ops, ref)
    f32 = compare_paths(lambda: paged_logits(params, f32cfg, T, dev, prompt),
                        paths, ops)
    b16 = compare_paths(lambda: paged_logits(params, cfg, T, dev, prompt),
                        paths, ops)
    failed = check_logits(f32, b16, [(0, "prefill chunk", "prefill fault"),
                                     (1, "decode step", "decode fault")],
                          "paged")
    del f32, b16
    if failed:
        raise RuntimeError("; ".join(failed))
    sp = make_requests(cfg.vocab, 2, lo=200, hi=400)
    small = dataclasses.replace(scfg, batch=2)
    # Eager engines: a graph captured with the kernels would not see the
    # plain path swapped in.
    _, k_fin, _, _ = serve(params, cfg, small, sp, 16, dev, ops,
                           capture=False)
    with kernel_ops(ops, **paths["plain"]):
        _, p_fin, _, _ = serve(params, cfg, small, sp, 16, dev, ops,
                               capture=False)
    same = sum(int(a == b) for r in k_fin for a, b in zip(k_fin[r], p_fin[r]))
    prefix = [next((j for j, (a, b) in enumerate(zip(k_fin[r], p_fin[r]))
                    if a != b), 16) for r in sorted(k_fin)]
    log(f"  greedy streams (2 x 16 tokens): {same}/32 tokens agree, "
        f"agreeing prefixes {prefix}")
    torch.cuda.empty_cache()

    log("== engine: qwen3-4b at full width, contiguous ==")
    ccfg = ServeConfig(max_len=MAX_LEN, batch=B, eos_id=-1)
    eng, launches, _, _ = run_eager_and_graphed("contiguous", params, cfg,
                                                ccfg, prompts, dev, ops)
    if not 0 < launches["flash_decode"] == cfg.n_layers * eng.decode_steps:
        raise RuntimeError(f"contiguous decode launches {launches} != "
                           f"{cfg.n_layers} x {eng.decode_steps} steps")
    main_launches["flash_decode"] = launches["flash_decode"]
    ticks["contiguous qwen3-4b"] = eng.ticks
    del eng
    torch.cuda.empty_cache()

    log("== contiguous kernel path against plain path: qwen3-4b ==")
    prompt = make_requests(cfg.vocab, 1, lo=301, hi=301)[0]
    paths = {k: v for k, v in contiguous_paths(ops, ref).items()
             if k in ("plain", "decode fault")}     # no Mamba layer here
    f32 = compare_paths(lambda: contiguous_logits(params, f32cfg, T, dev,
                                                  prompt), paths, ops)
    b16 = compare_paths(lambda: contiguous_logits(params, cfg, T, dev,
                                                  prompt), paths, ops)
    failed = check_logits(f32, b16, [(1, "decode step", "decode fault")],
                          "qwen3-4b contiguous")
    del f32, b16, params
    if failed:
        raise RuntimeError("; ".join(failed))
    torch.cuda.empty_cache()

    log("== engine: mamba2-370m at full width, contiguous ==")
    cfg, params = init_model("mamba2-370m", configs, T, dev)
    prompts = make_requests(cfg.vocab, N_REQUESTS - 1)
    prompts.append(make_requests(cfg.vocab, 1, lo=1031, hi=1031)[0])
    log(f"  prompt lengths: {[len(p) for p in prompts]} (1031 is prime)")
    eng, launches, _, _ = run_eager_and_graphed("contiguous", params, cfg,
                                                ccfg, prompts, dev, ops)
    admissions = sum(eng.prefill_buckets.values())
    if not 0 < launches["ssd_scan"] == cfg.n_layers * admissions:
        raise RuntimeError(f"ssd_scan launches {launches} != "
                           f"{cfg.n_layers} x {admissions} admissions")
    main_launches["ssd_scan"] = launches["ssd_scan"]
    ticks["contiguous mamba2-370m"] = eng.ticks
    del eng
    torch.cuda.empty_cache()

    log("== contiguous kernel path against plain path: mamba2-370m ==")
    prompt = make_requests(cfg.vocab, 1, lo=301, hi=301)[0]
    paths = {k: v for k, v in contiguous_paths(ops, ref).items()
             if k != "decode fault"}        # no attention layer here
    f32cfg = dataclasses.replace(cfg, compute_dtype="float32")
    full = compare_paths(lambda: contiguous_logits(params, f32cfg, T, dev,
                                                   prompt),
                         {k: paths[k] for k in ("plain", "reorder")}, ops)
    for part, what in ((0, "300-row prefill"), (1, "decode step")):
        log(f"  mamba2-370m 48 layers fp32 {what}: max |logit diff| kernel "
            f"vs plain {max_diff(full['kernel'][part], full['plain'][part]):.3e},"
            f" plain vs plain reordered "
            f"{max_diff(full['plain'][part], full['reorder'][part]):.3e} "
            f"(logged only: the random 48-layer stack is chaotic)")
    del full
    cut = dict(params, blocks=params["blocks"][:MAMBA_CHECK_LAYERS])
    f32cfg = dataclasses.replace(cfg, n_layers=MAMBA_CHECK_LAYERS,
                                 compute_dtype="float32")
    b16cfg = dataclasses.replace(cfg, n_layers=MAMBA_CHECK_LAYERS)
    f32 = compare_paths(lambda: contiguous_logits(cut, f32cfg, T, dev,
                                                  prompt), paths, ops)
    b16 = compare_paths(lambda: contiguous_logits(cut, b16cfg, T, dev,
                                                  prompt), paths, ops)
    failed = check_logits(
        f32, b16, [(0, "300-row prefill", "ssd fault"),
                   (1, "decode step", "ssd state fault")],
        f"mamba2-370m first {MAMBA_CHECK_LAYERS} layers")
    log(f"  plain vs plain reordered, fp32: prefill "
        f"{max_diff(f32['plain'][0], f32['reorder'][0]):.3e}, decode step "
        f"{max_diff(f32['plain'][1], f32['reorder'][1]):.3e}")
    del f32, b16, params, cut
    if failed:
        raise RuntimeError("; ".join(failed))
    torch.cuda.empty_cache()

    log("== probes: the paper's methods through their entry points ==")
    torch.cuda.synchronize()
    ops.reset_launches()
    tiling = autotune_gemm.main([])
    lat = latency_launch.main([])
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    log(f"  launches: {launches}")
    if min(launches["gemm"], launches["pchase"]) <= 0:
        raise RuntimeError(f"probe path skipped a kernel: {launches}")
    main_launches.update(gemm=launches["gemm"], pchase=launches["pchase"])
    if lat["table_4_1"] != {"volta": (25, 25), "pascal": (43, 43)}:
        raise RuntimeError(f"Table 4.1 not recovered: {lat['table_4_1']}")
    readings = [*lat["op_chain_ns"].values(), *lat["chase_ns"].values(),
                *(ms for r in tiling["problems"] for ms in r["ms"].values())]
    if not all(math.isfinite(v) and v > 0 for v in readings):
        raise RuntimeError(f"a probe reading is not a positive time: "
                           f"{readings}")
    log("  tiling (Ch.1): " + "; ".join(
        f"{r['shape']}: tuned {r['tuned']}, modelled "
        f"{r['modelled_speedup']:.3f}x, measured {r['measured_speedup']:.3f}x"
        for r in tiling["problems"]))
    log("  pointer chase, phase 4 against phase 11 (ns per load): "
        + ", ".join(f"{fp // 2**10} KiB {timing['pchase']['ns'][fp]:.1f}/"
                    f"{v:.1f}" for fp, v in lat["chase_ns"].items()))
    torch.cuda.empty_cache()

    log("== the full-sequence attention kernel against its plain version ==")
    failures = check_flash_kernel(dev, ops, ref)
    if failures:
        raise RuntimeError(f"flash_attention disagrees with its plain "
                           f"version: {failures}")
    timing["flash_attention"] = time_flash_kernel(dev, ops, ref)
    if not timing["flash_attention"]["ok"]:
        raise RuntimeError("the timed flash_attention disagrees with its "
                           "plain version")
    torch.cuda.empty_cache()

    log("== cache-less forward: qwen3-4b at full width through the kernel ==")
    cfg, params = init_model("qwen3-4b", configs, T, dev)
    tokens, labels = SyntheticLMData(DataConfig(
        vocab=cfg.vocab, seq_len=FLASH_S, global_batch=FLASH_B)).batch_at(0)
    batch = {"tokens": torch.from_numpy(tokens).to(dev),
             "labels": torch.from_numpy(labels).to(dev)}
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        loss, _ = steps.loss_fn(params, dataclasses.replace(cfg,
                                                            use_flash=True),
                                batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    log(f"  loss_fn (use_flash, no_grad) on {FLASH_B} x {FLASH_S} tokens: "
        f"loss {float(loss):.6f} in {wall:.3f} s, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{launches}")
    if launches != dict(dict.fromkeys(launches, 0),
                        flash_attention=cfg.n_layers):
        raise RuntimeError(f"cache-less forward launches {launches}: want "
                           f"flash_attention {cfg.n_layers} and nothing else")
    main_launches["flash_attention"] = launches["flash_attention"]
    failed = check_cacheless(params, cfg, T, steps, batch, ops,
                             "qwen3-4b cache-less")
    del params, batch
    if failed:
        raise RuntimeError("; ".join(failed))
    torch.cuda.empty_cache()

    log("== training launcher: qwen2-0.5b at full width ==")
    train_summary = run_training(dev, ops, configs, T, steps)
    torch.cuda.empty_cache()

    log("== sampled decoding: qwen3-4b at full width, paged ==")
    cfg, params = init_model("qwen3-4b", configs, T, dev)
    check_keys_on_card(dev, sampling, cfg.vocab)
    sampled = dataclasses.replace(scfg, temperature=SAMPLE_TEMPERATURE,
                                  seed=0)
    sampled_tok_s = run_sampled(params, cfg, sampled,
                                make_requests(cfg.vocab, N_REQUESTS), greedy,
                                dev, ops)
    torch.cuda.empty_cache()

    log("== speculative decoding: qwen3-4b at full width, paged ==")
    spec = run_spec(params, cfg, scfg, make_requests(cfg.vocab, N_REQUESTS),
                    greedy, plain_tok_s, dev, ops, T)
    log(f"  flash_attention_paged at the verify shape: device time "
        f"{timing['verify']['device_ms']:.4f} ms a launch (paged decode "
        f"{timing['flash_decode_paged']['device_ms']:.4f} ms), "
        f"{spec['verify_launches']} launches in the graphed phase-16 run")

    log("== prefix caching: qwen3-4b at full width, paged ==")
    prefix = run_prefix(params, cfg, scfg, dev, ops, T)

    log("== open-loop overload: qwen3-4b at full width, paged ==")
    overload = run_overload(params, cfg, scfg, dev, ops)
    torch.cuda.empty_cache()

    log("== cost models and calibration: qwen3-4b at full width, paged ==")
    t0 = time.perf_counter()
    costs = run_costmodels(params, cfg, scfg, dev, ops, spec)
    log(f"  phase 19 took {time.perf_counter() - t0:.1f} s")
    del params
    torch.cuda.empty_cache()

    log("== the paper's dissection on the card ==")
    dissection = run_dissection(dev, ops, card, dissect, hwmodel)
    main_launches["pchase_timed"] = dissection["launches"]
    torch.cuda.empty_cache()

    log("== the other model families at full width, bf16 ==")
    t0 = time.perf_counter()
    families = run_families(dev, ops, ref, configs, T, moe_mod)
    log(f"  phase 21 took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    log("== the encoder-decoder and cross-attention families, bf16 ==")
    t0 = time.perf_counter()
    encdec = run_encdec(dev, ops, ref, configs, T, engine)
    log(f"  phase 22 took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    log(f"== tensor-parallel serving: qwen3-4b at full width over {TP} ranks "
        f"of a gloo group on this card ==")
    t0 = time.perf_counter()
    tp = run_tp(dev, ops, ref, configs, T)
    log("== every family trains ==")
    tp["training"] = run_train_families(dev, ops, configs, T, steps)
    log(f"  phase 23 took {time.perf_counter() - t0:.1f} s")

    log("== training over ranks: qwen2-0.5b whole on two gloo ranks of this "
        "card, and GPipe ==")
    t0 = time.perf_counter()
    train_dist = run_train_dist(dev, ops, ref)
    log(f"  phase 24 took {time.perf_counter() - t0:.1f} s")

    log(f"== the model axis for every family: {EP_ARCH} at published widths "
        f"served by {EP} gloo ranks of this card with its experts split, a "
        f"model draft under the mesh, Mamba, hybrid, cross and encoder "
        f"layers trained over (data 1, model {EP}) ==")
    t0 = time.perf_counter()
    model_axis = run_ep(dev, ops, ref, configs, T, moe_mod)
    log(f"  phase 25 took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    log("== the dry run's accounting on the card: op traces against their "
        "meta traces, the cached forward over two gloo ranks, remat ==")
    dry = run_dry(dev, ops, ref, configs, T, steps)
    log(f"  phase 26 took {dry['s']:.1f} s")

    log("== the reference's attention and cache knobs: bf16 probabilities "
        "in training, int8 caches, expand_kv ==")
    knobs = run_knobs(dev, ops, ref, configs, T, steps, engine)
    log(f"  phase 27 took {knobs['s']:.1f} s")

    log("== every tile of every attention wrapper, and the tile chooser's "
        "picks ==")
    tiles = run_tiles(dev, ops, ref)

    log("== the SSD scan at each chunk it instantiates: held to the plain "
        "version, timed, and mamba2-370m served at each ==")
    chunks = run_chunks(dev, ops, ref, configs, T, decode_mod)
    line = dict(KERNELS)
    for name, r in chunks["kernels"].items():
        line[name] = KERNELS["ssd_scan"]
        timing[name] = r
        main_launches[name] = r["launches"]

    kernels = []
    for name, (source, replaces) in line.items():
        r = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": main_launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    log(f"  ticks: {ticks}; training: {train_summary}; sampled "
        f"{sampled_tok_s:.1f} tok/s; spec {spec}; prefix {prefix}; "
        f"overload {overload}; cost models {costs}; dissection "
        f"{dissection}; families {families}; encoder-decoder "
        f"{ {k: v for k, v in encdec.items() if k != 'kernels'} }; "
        f"tensor-parallel {tp}; training over ranks {train_dist}; the "
        f"model axis {model_axis}; the dry run's accounting {dry}; the "
        f"knobs {knobs}; the tiles {tiles}; the chunks "
        f"{ {k: v for k, v in chunks.items() if k != 'kernels'} }; total "
        f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
