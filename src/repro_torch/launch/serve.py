"""Serving launcher: a batch of requests through the serving engine,
contiguous caches by default, a page pool with ``--paged``.

  python -m repro_torch.launch.serve --arch qwen3-4b --requests 8
  python -m repro_torch.launch.serve --arch mamba2-370m --requests 8
  python -m repro_torch.launch.serve --arch qwen3-4b --paged --smoke \\
      --device cpu --max-len 64 --page-size 8 --chunk-size 8 --max-new 6
  python -m repro_torch.launch.serve --arch qwen3-4b --temperature 0.8
  python -m repro_torch.launch.serve --arch qwen3-4b --paged --spec-k 4 \
      --prefix-cache

Weights are random, drawn on the device from a ``torch.Generator`` seeded
with ``--seed``, which also seeds the sampling keys at ``--temperature``
above 0. Cached attention and the SSD scan run through the port's
kernels (their plain versions on the CPU). On a card each decode (or,
with ``--spec-k``, verify) and chunk step is one captured CUDA graph.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Request, ServeConfig, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-4b", choices=configs.list_archs())
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--paged", action="store_true",
                    help="K/V rows from a shared page pool (attention "
                         "stacks only); default: contiguous caches")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--chunk-size", type=int, default=64,
                    help="prefill chunk rows (paged; page-size multiple)")
    ap.add_argument("--prefix-cache", default=False,
                    action=argparse.BooleanOptionalAction,
                    help="share full-page prompt prefixes across requests "
                         "through the page table (paged only; refcounted "
                         "pages, copy-on-write)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: drafted tokens a verify "
                         "tick (paged only; 0 disables)")
    ap.add_argument("--draft", default="ngram",
                    help="draft source for --spec-k: 'ngram' (prompt "
                         "lookup), 'self' (sliding-window self-speculation) "
                         "or an arch name")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0: greedy; above 0, sampled under threefry keys "
                         "of (request, emitted index)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.spec_k and not args.paged:
        raise SystemExit("--spec-k needs --paged (the verify runs the paged "
                         "prefill kernel)")
    if args.prefix_cache and not args.paged:
        raise SystemExit("--prefix-cache needs --paged (sharing happens "
                         "through the page table)")

    device = resolve_device(args.device)
    cfg = configs.get_smoke(args.arch) if args.smoke \
        else configs.get_config(args.arch)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = T.init_params(cfg, gen, device=device)
    scfg = ServeConfig(max_len=args.max_len, batch=args.batch,
                       paged=args.paged, page_size=args.page_size,
                       chunk_size=args.chunk_size,
                       temperature=args.temperature, seed=args.seed,
                       spec_k=args.spec_k, draft=args.draft,
                       prefix_cache=args.prefix_cache)
    engine = ServingEngine(params, cfg, scfg, device=device)
    rng = np.random.RandomState(args.seed)
    for rid in range(args.requests):
        prompt = rng.randint(2, cfg.vocab, size=rng.randint(4, 12))
        engine.submit(Request(rid=rid, prompt=prompt.astype(np.int32),
                              max_new=args.max_new))
    if device.type == "cuda":
        torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    finished = engine.run_until_drained()
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    toks = sum(len(v) for v in finished.values())
    print(f"served {len(finished)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s) on {device}, "
          + (f"graphed (captured in {engine.capture_seconds:.2f}s)"
             if engine.graphed else "eager")
          + (f", sampled at temperature {args.temperature}"
             if args.temperature else ", greedy"))
    if args.paged:
        occ = engine.pool.occupancy()
        print(f"  paged: {occ['high_water']}/{occ['capacity']} pages "
              f"high-water ({args.page_size} rows each), chunk={engine.chunk}"
              f", {engine.chunk_steps} chunk steps, "
              f"{engine.admission_rejections} admission holds, "
              f"{engine.preemptions} preemptions, {engine.ticks} ticks")
        if engine.prefix is not None:
            probes = engine.prefix_hits + engine.prefix_misses
            print(f"  prefix cache: {occ['pages_shared']} shared / "
                  f"{occ['pages_exclusive']} exclusive / "
                  f"{occ['pages_cached_idle']} cached-idle pages, index "
                  f"{len(engine.prefix)} entries, {engine.prefix_hits}/"
                  f"{probes} admissions hit, {engine.prefix_hit_pages} pages "
                  f"mapped, {engine.cow_copies} copy-on-write, "
                  f"{engine.prefix.evicted_pages} evicted")
        if engine.spec_k:
            ticks = max(1, engine.spec_ticks)
            print(f"  spec: k={engine.spec_k} draft={args.draft} "
                  f"accepted/tick={engine.spec_accepted / ticks:.2f} "
                  f"emitted/tick={engine.spec_emitted / ticks:.2f} "
                  f"({engine.verify_traces} verify step)")
    else:
        print(f"  contiguous: {engine.ticks} ticks, prefill buckets "
              f"{dict(sorted(engine.prefill_buckets.items()))} (bucket: "
              f"prefills), {engine.decode_steps} decode steps")
    print(f"  kernel launches: {dict(ops.LAUNCHES)}")
    for rid in sorted(finished):
        print(f"  req {rid}: {finished[rid][:10]}...")
    return finished


if __name__ == "__main__":
    main()
