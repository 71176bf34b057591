#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA card and the CUDA
toolkit (``nvcc``). In order, and failing loudly on any phase:

1. the card's name and power limit (``nvidia-smi``) and the toolchain;
2. build of the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. each kernel against its plain PyTorch version, fp32 and bf16, head_dim
   64/80/128, at the main path's head counts (ragged lengths with a 0,
   shuffled page tables, chunks at start > 0 and past the table's end);
4. times at the main path's shapes: kernel, plain version, one PyTorch
   library call (``scaled_dot_product_attention`` over the gathered view,
   a yardstick only) and the card's bound for the same work;
5. the paged serving engine at the full width of ``qwen3-4b`` (36 layers,
   bf16, random weights from a seeded ``torch.Generator``): 12 requests,
   32 tokens each, launch counters read around the run;
6. the same engine on a squeezed page pool, which must preempt;
7. kernel path against plain path on the same weights: logits of one
   prefill chunk and one decode step in fp32 (against a limit that a
   planted one-key fault in each kernel, run here too, must exceed) and
   in bf16 (against the plain path's own bf16 error), and greedy stream
   agreement.

The line before the last holds the kernels' numbers as JSON, and the last
line is ``{"ok": true, "device": {...}}``. Exits non-zero without a card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
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
SOURCE = "src/repro_torch/kernels/csrc/paged_attention.cu"
REPLACES = {
    "flash_decode_paged": "src/repro/kernels/flash_decode.py:162",
    "flash_attention_paged": "src/repro/kernels/flash_attention.py:236",
}
N_REQUESTS, MAX_NEW = 12, 32
# Phase 7, fp32 logits of the kernel path against the plain path: the
# kernels' summation order moves them by far less than this; a planted
# one-key fault in either kernel by far more.
FP32_LOGIT_TOL = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


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
        for d in (64, 80, 128):
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
    return failures


# ----------------------------------------------------------------------------
# Times at the main path's shapes
# ----------------------------------------------------------------------------

def time_ms(fn, n_layers: int, iters: int = 50) -> float:
    """Mean device time of ``fn(layer)`` over ``iters`` launches cycling
    through ``n_layers`` distinct pools (as the engine's layers do), so
    that the 50 MB L2 cache does not hold one pool across launches."""
    for i in range(3):
        fn(i % n_layers)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for i in range(iters):
        fn(i % n_layers)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_kernels(dev, ops, ref) -> dict:
    """Kernel, plain and library times and the bound, bf16, main path."""
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
    for name, r in out.items():
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["ops"] / PEAK_OPS[dtype] * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        log(f"  {name} [{r['shape']}, bf16]: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}: "
            f"{r['bytes'] / 1e6:.2f} MB, {r['ops'] / 1e9:.3f} GFLOP), "
            f"max_abs_err {r['max_abs_err']:.3e} {'ok' if r['ok'] else 'FAIL'}")
    return out


# ----------------------------------------------------------------------------
# The engine at full width
# ----------------------------------------------------------------------------

def make_requests(vocab: int, n: int, lo: int = 64, hi: int = 1536):
    rng = np.random.RandomState(0)
    lens = rng.randint(lo, hi + 1, size=n)
    return [rng.randint(2, vocab, size=int(l)).astype(np.int32) for l in lens]


def serve(params, cfg, scfg, prompts, max_new, dev, ops):
    """Drive the engine over ``prompts``; launch counts cover this run only."""
    from repro_torch.serve.engine import Request, ServingEngine

    eng = ServingEngine(params, cfg, scfg, device=dev)
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=p, max_new=max_new))
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
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
    if eng.pool.pages_in_use != 0:
        raise RuntimeError(f"{eng.pool.pages_in_use} pages leaked")


@contextlib.contextmanager
def attention_ops(layers, decode, prefill):
    """The same model with its paged attention computed by ``decode`` and
    ``prefill`` in place of the kernel wrappers: the comparison paths of
    phase 7."""
    saved = layers.kernel_ops
    layers.kernel_ops = types.SimpleNamespace(flash_decode_paged=decode,
                                              flash_attention_paged=prefill)
    try:
        yield
    finally:
        layers.kernel_ops = saved


def attention_paths(ops, ref) -> dict:
    """Phase 7's paths: (decode, prefill) for the plain versions and for
    the kernels with one planted fault each. The faults are ones a page
    walk or a mask can make: decode drops each slot's newest key
    (``lengths - 1``), prefill lets each query see one key past its own
    position (``starts + 1``, the causal mask off by one)."""
    return {
        "plain": (ref.flash_decode_paged, ref.flash_attention_paged),
        "decode fault": (
            lambda q, kp, vp, t, n: ops.flash_decode_paged(q, kp, vp, t,
                                                           n - 1),
            ops.flash_attention_paged),
        "prefill fault": (
            ops.flash_decode_paged,
            lambda q, kp, vp, t, s: ops.flash_attention_paged(q, kp, vp, t,
                                                              s + 1)),
    }


def compare_paths(params, cfg, T, layers, ops, ref, dev, prompt) -> dict:
    """Max |logit difference| of the plain path and of each planted fault
    against the kernel path, on the last prefill chunk and one decode step,
    with ``cfg``'s compute dtype throughout (weights cast at use)."""
    kernel = path_logits(params, cfg, T, dev, prompt)
    out = {"kernel": kernel}
    for name, (dec, pre) in attention_paths(ops, ref).items():
        with attention_ops(layers, dec, pre):
            out[name] = path_logits(params, cfg, T, dev, prompt)
    return out


def max_diff(a, b) -> float:
    return float((a - b).abs().max())


def path_logits(params, cfg, T, dev, prompt):
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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs only on a CUDA card")
    from repro_torch import configs
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.models import layers
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import ServeConfig

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    log(f"card: {smi}; torch.cuda.get_device_name: "
        f"{torch.cuda.get_device_name(0)}")

    log("== build ==")
    t0 = time.perf_counter()
    lib = _build.build()
    log(f"  built {lib.name} in {time.perf_counter() - t0:.1f} s")
    for line in (lib.parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")
    log(f"  toolchain: {toolchain(_build)}")

    log("== kernels against their plain versions ==")
    failures = check_kernels(dev, ops, ref)
    if failures:
        raise RuntimeError(f"kernels disagree with plain versions: {failures}")

    log("== times at the main path's shapes ==")
    timing = time_kernels(dev, ops, ref)
    if not all(r["ok"] for r in timing.values()):
        raise RuntimeError("a timed kernel disagrees with its plain version")
    torch.cuda.empty_cache()

    log("== engine: qwen3-4b at full width ==")
    cfg = configs.get_config("qwen3-4b")
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    torch.cuda.synchronize()
    log(f"  {cfg.name}: {T.param_count(params) / 1e9:.3f} B parameters, "
        f"{cfg.n_layers} layers, d_model {cfg.d_model}, head_dim "
        f"{cfg.dhead}, bf16, initialised in {time.perf_counter() - t0:.1f} s")
    prompts = make_requests(cfg.vocab, N_REQUESTS)
    log(f"  prompt lengths: {[len(p) for p in prompts]}")
    scfg = ServeConfig(max_len=MAX_LEN, batch=B, page_size=PS,
                       chunk_size=CHUNK, eos_id=-1)
    torch.cuda.reset_peak_memory_stats()
    eng, finished, wall, launches = serve(params, cfg, scfg, prompts,
                                          MAX_NEW, dev, ops)
    check_served(eng, finished, prompts, MAX_NEW, cfg.vocab)
    if min(launches.values()) <= 0:
        raise RuntimeError(f"main path skipped a kernel: {launches}")
    toks = sum(len(v) for v in finished.values())
    log(f"  served {len(finished)} requests, {toks} tokens in {wall:.2f} s "
        f"({toks / wall:.1f} tok/s), {eng.ticks} ticks, "
        f"{eng.chunk_steps} chunk steps, {eng.decode_steps} decode steps, "
        f"{eng.preemptions} preemptions, {eng.admission_rejections} holds, "
        f"pool {eng.pool.n_pages} pages (high water "
        f"{eng.pool.high_water}), max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"  launches on the main path: {launches} "
        f"(per tick: decode {launches['flash_decode_paged'] / eng.ticks:.2f},"
        f" prefill {launches['flash_attention_paged'] / eng.ticks:.2f})")
    main_ticks = eng.ticks
    del eng
    torch.cuda.empty_cache()

    log("== engine: squeezed pool ==")
    squeezed = dataclasses.replace(scfg, n_pages=161)
    eng, finished, wall, _ = serve(params, cfg, squeezed, prompts, MAX_NEW,
                                   dev, ops)
    check_served(eng, finished, prompts, MAX_NEW, cfg.vocab)
    if eng.preemptions < 1:
        raise RuntimeError("squeezed pool ran without a preemption")
    log(f"  n_pages {squeezed.n_pages}: {len(finished)} requests done in "
        f"{wall:.2f} s, {eng.ticks} ticks, {eng.preemptions} preemptions, "
        f"{eng.admission_rejections} holds")
    del eng
    torch.cuda.empty_cache()

    log("== kernel path against plain path (same weights) ==")
    prompt = make_requests(cfg.vocab, 1, lo=300, hi=300)[0]
    f32 = compare_paths(params, dataclasses.replace(
        cfg, compute_dtype="float32"), T, layers, ops, ref, dev, prompt)
    b16 = compare_paths(params, cfg, T, layers, ops, ref, dev, prompt)
    failed = []
    for part, what in ((0, "prefill chunk"), (1, "decode step")):
        # fp32: the kernels and their plain versions differ only in the
        # order of their sums, so a limit far below what a one-key fault
        # moves (FP32_LOGIT_TOL) separates right from wrong.
        sound = max_diff(f32["kernel"][part], f32["plain"][part])
        fault = max_diff(f32["kernel"][part],
                         f32["decode fault" if part else
                             "prefill fault"][part])
        scale = float(f32["plain"][part].abs().max())
        log(f"  fp32 {what}: max |logit diff| kernel vs plain {sound:.3e}, "
            f"planted {'decode' if part else 'prefill'} fault {fault:.3e} "
            f"(limit {FP32_LOGIT_TOL:g}; max |logit| {scale:.3f})")
        if not (math.isfinite(sound) and sound <= FP32_LOGIT_TOL):
            failed.append(f"fp32 {what}: kernel and plain logits differ")
        if not fault > FP32_LOGIT_TOL:
            failed.append(f"fp32 {what}: the planted fault went unseen")
        # bf16: the limit is twice the plain path's own bf16 error (plain
        # bf16 against plain fp32, same weights): kernel and plain path
        # each sit within about that of the fp32 logits.
        sound = max_diff(b16["kernel"][part], b16["plain"][part])
        noise = max_diff(b16["plain"][part], f32["plain"][part])
        fault = max_diff(b16["kernel"][part],
                         b16["decode fault" if part else
                             "prefill fault"][part])
        agree = float((b16["kernel"][part].argmax(-1)
                       == b16["plain"][part].argmax(-1)).float().mean())
        log(f"  bf16 {what}: max |logit diff| kernel vs plain {sound:.4f}, "
            f"plain bf16 vs fp32 {noise:.4f} (limit {2 * noise:.4f}), "
            f"planted fault {fault:.4f}, argmax agreement {agree:.3f}")
        if not (math.isfinite(sound) and sound <= 2 * noise):
            failed.append(f"bf16 {what}: kernel and plain logits differ")
    del f32, b16
    if failed:
        raise RuntimeError("; ".join(failed))
    plain = attention_paths(ops, ref)["plain"]
    sp = make_requests(cfg.vocab, 2, lo=200, hi=400)
    small = dataclasses.replace(scfg, batch=2)
    _, k_fin, _, _ = serve(params, cfg, small, sp, 16, dev, ops)
    with attention_ops(layers, *plain):
        _, p_fin, _, _ = serve(params, cfg, small, sp, 16, dev, ops)
    same = sum(int(a == b) for r in k_fin for a, b in zip(k_fin[r], p_fin[r]))
    prefix = [next((j for j, (a, b) in enumerate(zip(k_fin[r], p_fin[r]))
                    if a != b), 16) for r in sorted(k_fin)]
    log(f"  greedy streams (2 x 16 tokens): {same}/32 tokens agree, "
        f"agreeing prefixes {prefix}")

    kernels = []
    for name in ("flash_decode_paged", "flash_attention_paged"):
        r = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    log(f"  main path: {main_ticks} ticks; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
