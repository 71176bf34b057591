"""Where a serving run's time goes on the card: ``torch.profiler`` around
one engine run at full width.

  python -m repro_torch.launch.profile --arch qwen3-4b
  python -m repro_torch.launch.profile --arch qwen3-4b --paged
  python -m repro_torch.launch.profile --arch mamba2-370m [--eager]

Profiles the graphed engine by default (each decode and chunk step one
captured CUDA graph, replayed once a tick); ``--eager`` profiles the same
engine with every step launched op by op from Python. Serves
``chip_smoke.py``'s engine cell (12 requests with prompts of 64 to
1536 tokens drawn from ``np.random.RandomState(0)``, 32 new tokens each,
batch 8, max_len 2048; paged: pages of 16 rows, chunks of 256) once to
warm up and once under the profiler, and prints the wall time, the device
time by kernel family and for the top kernels, and the device's busy and
idle shares of the wall time (one stream, so busy = the sum of kernel
times). Random weights from a ``torch.Generator`` seeded with ``--seed``.
"""

from __future__ import annotations

import argparse
import time
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs, resolve_device
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Request, ServeConfig, ServingEngine

# Kernel name fragments -> family: the first entry whose fragments all
# occur in the (demangled) name wins. The port's kernels are keyed on their
# own names, which sit in an anonymous namespace as no library's do, and on
# the layout they are instantiated for; each family is the TPU kernel they
# replace.
PORT = "(anonymous namespace)::"
FAMILIES = (((PORT + "decode_split_kernel<", "PagedLayout"),
             "flash_decode_paged"),
            ((PORT + "decode_split_kernel<", "ContiguousLayout"),
             "flash_decode"),
            ((PORT + "prefill_kernel<", "PagedLayout"),
             "flash_attention_paged"),
            ((PORT + "prefill_mma_kernel<", "PagedLayout"),
             "flash_attention_paged"),
            ((PORT + "prefill_kernel<", "ContiguousLayout"),
             "flash_attention"),
            ((PORT + "prefill_mma_kernel<", "ContiguousLayout"),
             "flash_attention"),
            ((PORT + "ssd_scan_kernel<",), "ssd_scan"),
            ((PORT + "ssd_scan_mma_kernel<",), "ssd_scan"),
            ((PORT + "gemm_kernel<",), "gemm"),
            ((PORT + "gemm_wgmma_kernel<",), "gemm"),
            ((PORT + "pchase_kernel(",), "pchase"),
            ((PORT + "pchase_timed_kernel<",), "pchase_timed"),
            (("gemm",), "GEMM (cuBLAS)"), (("nvjet",), "GEMM (cuBLAS)"),
            (("xmma",), "GEMM (cuBLAS)"), (("cutlass",), "GEMM (cuBLAS)"),
            (("reduce",), "reductions"), (("index",), "indexing and scatter"),
            (("elementwise",), "elementwise"), (("copy",), "copies and casts"))


def family(name: str) -> str:
    low = name.lower()
    return next((f for keys, f in FAMILIES
                 if all(k.lower() in low for k in keys)), "other")


def serve_once(params, cfg, scfg, prompts, max_new, device, capture):
    eng = ServingEngine(params, cfg, scfg, device=device, capture=capture)
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=p, max_new=max_new))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run_until_drained()
    torch.cuda.synchronize()
    return eng, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-4b", type=configs.canonical_id,
                    choices=list(configs.ALIASES),
                    help="a CLI id or its module's name "
                         "(configs.list_archs())")
    ap.add_argument("--paged", action="store_true")
    ap.add_argument("--eager", action="store_true",
                    help="launch every step's ops from Python (default: "
                         "replay each step's captured CUDA graph)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)

    device = resolve_device(None)
    cfg = configs.get_config(args.arch)
    params = T.init_params(cfg, torch.Generator(device=device)
                           .manual_seed(args.seed), device=device)
    rng = np.random.RandomState(0)
    lens = rng.randint(64, 1536 + 1, size=12)
    prompts = [rng.randint(2, cfg.vocab, size=int(n)).astype(np.int32)
               for n in lens]
    scfg = ServeConfig(max_len=2048, batch=8, eos_id=-1, paged=args.paged,
                       page_size=16, chunk_size=256)
    capture = not args.eager
    serve_once(params, cfg, scfg, prompts, 32, device, capture)  # warm-up
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng, wall = serve_once(params, cfg, scfg, prompts, 32, device,
                               capture)
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.self_device_time_total]
    busy_us = sum(e.self_device_time_total for e in kernels)
    by_family = defaultdict(float)
    for e in kernels:
        by_family[family(e.key)] += e.self_device_time_total
    mode = (f"graphed (capture {eng.capture_seconds:.3f} s, graph pools "
            f"{eng.graph_bytes / 2**20:.1f} MiB, outside the wall time)"
            if eng.graphed else "eager")
    print(f"{torch.cuda.get_device_name(0)}; {cfg.name} "
          f"{'paged' if args.paged else 'contiguous'}, {mode}: "
          f"{eng.ticks} ticks, "
          f"{eng.decode_steps} decode steps, wall {wall:.3f} s under the "
          f"profiler, device busy {busy_us / 1e6:.3f} s "
          f"({busy_us / 1e4 / wall:.1f} %), idle "
          f"{100 - busy_us / 1e4 / wall:.1f} %")
    for fam, us in sorted(by_family.items(), key=lambda kv: -kv[1]):
        print(f"  {fam:24s} {us / 1e3:10.1f} ms  {100 * us / busy_us:5.1f} % "
              f"of device time")
    print(f"  top {args.top} kernels:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total
                    )[:args.top]:
        print(f"    {e.self_device_time_total / 1e3:9.1f} ms "
              f"{e.count:7d} calls  {e.key[:90]}")


if __name__ == "__main__":
    main()
