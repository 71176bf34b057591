#!/usr/bin/env python3
"""Time the MoE router on one CUDA card, the port's against its former one.

    python3 scripts/route_timing.py [--parts]

``models.moe._route`` computes the reference's softmax in
``MoEConfig.router_dtype`` (``torch.softmax`` in fp32, exp(l - max) / sum
written out in a narrower dtype) and takes its top-k from a stable sort
(ties to the lower expert, as ``jax.lax.top_k``). Its former body took
``torch.softmax`` and ``torch.topk`` in fp32; ``former_route`` below is
that body. Both run at the router shapes of the MoE families that
``chip_smoke.py`` serves (dbrx-132b, llama4-maverick-400b-a17b,
jamba-v0.1-52b: d_model, experts, top-k), bf16 activations, the default
fp32 router, at a decode step's tokens (8), a prefill chunk's (256) and a
long prefill's (2048). Each is timed over 12 input sets at the host's
pace (eager, as an eager engine issues it) and as device time, the
launches of 20 calls queued behind a spin of the card
(``chip_smoke.time_ms``), the former body first and last. The rows
whose ids differ between the two are counted. ``--parts`` also times the
pieces on fixed logits (the softmax, exp / sum, ``torch.topk``, the
stable sort, ``torch.topk`` over unique keys) and says whether each
synchronises. Prints the card's name
and power limit first and one JSON object of the times last. Needs a
CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("dbrx-132b", "llama4-maverick-400b-a17b", "jamba-v0.1-52b")
TOKENS = (8, 256, 2048)
SETS = 12
# Calls a device-time reading queues behind the spin: their 20-30 kernels
# each must fit the card's queue of pending launches (about 1,024), or the
# host blocks and the reading falls back to the host's pace.
DEVICE_ITERS = 20


def former_route(params, cfg, x):
    """``_route``'s body before the router dtype: fp32 logits,
    ``torch.softmax`` and ``torch.topk`` (one rank, no split)."""
    import torch

    logits = x.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    weights, ids = torch.topk(probs, cfg.top_k, dim=-1)
    weights = weights / weights.sum(dim=-1, keepdim=True)
    t = x.shape[0]
    density = torch.zeros(cfg.n_experts, device=x.device).scatter_add_(
        0, ids.reshape(-1), torch.ones(ids.numel(), device=x.device)) / (
        t * cfg.top_k)
    aux = cfg.n_experts * torch.sum(density * probs.mean(dim=0))
    return weights.to(x.dtype), ids, aux


def stable_topk_keys(probs, k: int):
    """The k largest, ties to the lower index, by ``torch.topk`` over keys
    no two experts share: a probability's bits (non-negative floats order
    as their bit patterns) times E, plus the index reversed."""
    import torch

    e = probs.shape[-1]
    bits = probs.view({2: torch.int16, 4: torch.int32}[probs.element_size()])
    rev = torch.arange(e - 1, -1, -1, device=probs.device)
    ids = torch.topk(torch.add(rev, bits.to(torch.int64), alpha=e), k,
                     dim=-1).indices
    return probs.gather(-1, ids), ids


def parts(cs, dev, gen) -> list:
    """The router's pieces on fixed fp32 logits: each one's host-paced and
    device ms, and whether it synchronises the host (the sync debug mode
    warns)."""
    import warnings

    import torch
    from repro_torch import configs

    def exp_sum(l):
        e = torch.exp(l - l.amax(dim=-1, keepdim=True))
        return e / e.sum(dim=-1, keepdim=True)

    rows = []
    for arch in ARCHS:
        mcfg = configs.get_config(arch).moe_cfg()
        k = mcfg.top_k
        for t in TOKENS:
            ls = [torch.randn(t, mcfg.n_experts, generator=gen, device=dev)
                  for _ in range(SETS)]
            ps = [exp_sum(l) for l in ls]
            fns = {
                "softmax": lambda i: torch.softmax(ls[i], dim=-1),
                "exp_sum": lambda i: exp_sum(ls[i]),
                "topk": lambda i: torch.topk(ps[i], k, dim=-1),
                "sort": lambda i: torch.sort(ps[i], dim=-1, descending=True,
                                             stable=True),
                "keys_topk": lambda i: stable_topk_keys(ps[i], k)}
            row = dict(arch=arch, tokens=t, experts=mcfg.n_experts, top_k=k)
            for name, fn in fns.items():
                torch.cuda.synchronize()
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    torch.cuda.set_sync_debug_mode("warn")
                    fn(0)
                    torch.cuda.set_sync_debug_mode("default")
                row[name] = dict(
                    ms=cs.time_ms(fn, SETS),
                    device_ms=cs.time_ms(fn, SETS, iters=DEVICE_ITERS,
                                         spin=True),
                    syncs=len(caught))
            same = all(torch.equal(stable_topk_keys(p, k)[1], torch.sort(
                p, dim=-1, descending=True, stable=True)[1][:, :k])
                for p in ps)
            row["keys_topk_equals_sort"] = same
            rows.append(row)
            print(f"  {json.dumps(row)}", flush=True)
    return rows


def main() -> None:
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("route_timing: needs a CUDA card")
    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.models import moe

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    rows = []
    for arch in ARCHS:
        mcfg = configs.get_config(arch).moe_cfg()
        params = {"router": torch.randn(mcfg.d_model, mcfg.n_experts,
                                        generator=gen, device=dev) * 0.02}
        for t in TOKENS:
            xs = [torch.randn(t, mcfg.d_model, generator=gen, device=dev,
                              dtype=torch.bfloat16) for _ in range(SETS)]
            fns = {"former": lambda i: former_route(params, mcfg, xs[i]),
                   "route": lambda i: moe._route(params, mcfg, xs[i])}
            differ = sum(int((fns["former"](i)[1] != fns["route"](i)[1])
                             .any(dim=-1).sum()) for i in range(SETS))
            times = {}
            for name in ("former", "route", "route", "former"):
                times.setdefault(name, []).append(dict(
                    ms=cs.time_ms(fns[name], SETS),
                    device_ms=cs.time_ms(fns[name], SETS,
                                         iters=DEVICE_ITERS, spin=True)))
            row = dict(arch=arch, tokens=t, experts=mcfg.n_experts,
                       top_k=mcfg.top_k, rows_with_other_ids=differ,
                       rows=t * SETS, **{
                           f"{name}_{k}": [r[k] for r in runs]
                           for name, runs in times.items()
                           for k in ("ms", "device_ms")})
            rows.append(row)
            print(f"  {json.dumps(row)}", flush=True)
    out = {"route": rows}
    if "--parts" in sys.argv[1:]:
        out["parts"] = parts(cs, dev, gen)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
