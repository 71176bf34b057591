"""The dry run (port of ``repro/launch/dryrun.py``): every (architecture x
input shape) cell on the production meshes, traced on rank 0 of a group
of 256 or 512 ranks that does no communication, with meta tensors (no
memory allocated, no device needed).

For each cell the port's own program runs as rank 0 would run it: the
train step (``train.steps.make_train_step`` over the training ruleset,
FSDP on, remat on unless ``--no-remat``), ``serve.engine.prefill`` or the
decode forward plus ``argmax``, on this rank's shard of the state, the
parameters and the contiguous caches (``dist.sharding.shard_tree``,
``models.transformer.init_caches(..., ruleset=)``), under a
``core.op_analysis.OpTrace``. It records what the reference records:

* ``memory``: the trace's argument, output, alias and peak temp bytes
  (the counterpart of ``compiled.memory_analysis()``);
* ``cost``: the trace's FLOPs, bytes and transcendentals;
* the collectives' payload bytes (the roofline's third term) and counts;
* the three-term roofline priced on the H100 (``core.roofline``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun              # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both --out dryrun.json
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape decode_32k --kv-dtype int8

The reference's memory knobs map as its ``prepare_cfg`` maps them:
``--bf16-probs`` sets ``attn_probs_fp32=False`` (the plain ``sdpa``'s
scores and probabilities in bf16), ``--expand-kv`` sets ``expand_kv``
(kv heads repeated to the query heads before the plain ``sdpa``), and
``--kv-dtype int8`` builds the contiguous attention and Mamba caches in
int8 (``input_specs(..., kv_dtype=torch.int8)``), written with
saturation and cast back to the compute dtype on every read, so the
kernels (counted by ``kernels/cost.py`` at the dtype they are launched
with) read the cast copy.
"""

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch import configs
from repro_torch.configs import shapes as shapes_mod
from repro_torch.core import op_analysis, roofline
from repro_torch.dist import sharding as shd
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.serve import engine as serve_engine
from repro_torch.train import steps as train_steps

META = torch.device("meta")


def input_specs(cfg: T.ModelConfig, shape: shapes_mod.ShapeSpec,
                ruleset: shd.Ruleset,
                kv_dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Meta stand-ins for one cell's inputs on this rank. A train step
    takes the global batch and cuts its rows itself; the serving paths
    take this rank's slots (the batch's rule) and its shard of the
    contiguous caches, in ``kv_dtype`` (default: the compute dtype)."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        specs = {"tokens": torch.zeros((b, s), dtype=torch.int32,
                                       device=META),
                 "labels": torch.zeros((b, s), dtype=torch.int32,
                                       device=META)}
        if cfg.n_frontend_tokens:
            specs["frontend"] = torch.zeros(
                (b, cfg.n_frontend_tokens, cfg.d_model), dtype=cfg.dtype,
                device=META)
        return specs
    rows = shd.local_shape(ruleset, ("batch",), (b,))[0][0]
    specs = {"caches": T.init_caches(cfg, b, s, device=META,
                                     dtype=kv_dtype, ruleset=ruleset)}
    if shape.kind == "prefill":
        specs["tokens"] = torch.zeros((rows, s), dtype=torch.int32,
                                      device=META)
    else:
        specs["last_tokens"] = torch.zeros((rows,), dtype=torch.int32,
                                           device=META)
    if cfg.n_frontend_tokens:
        specs["cross_kv"] = torch.zeros(
            (rows, cfg.n_frontend_tokens, cfg.d_model), dtype=cfg.dtype,
            device=META)
    return specs


@dataclasses.dataclass
class CellResult:
    arch: str
    shape: str
    mesh: str
    ok: bool
    skipped: bool = False
    reason: str = ""
    compile_s: float = 0.0          # the trace's seconds
    memory: Optional[Dict[str, float]] = None
    cost: Optional[Dict[str, float]] = None
    collective_bytes: float = 0.0
    collective_detail: Optional[Dict[str, int]] = None
    collective_count: Optional[Dict[str, int]] = None
    roofline: Optional[Dict[str, Any]] = None
    cache_bytes: Optional[Dict[str, float]] = None   # the rank's caches


def cache_bytes(caches) -> Dict[str, float]:
    """This rank's cache bytes: the attention layers' k/v, and the Mamba
    layers' conv and SSM state."""
    out = {"kv": 0.0, "state": 0.0}
    for c in caches:
        for name, t in c.items():
            if name in ("k", "v"):
                out["kv"] += t.numel() * t.element_size()
            elif name in ("conv", "ssm"):
                out["state"] += t.numel() * t.element_size()
    return out


def prepare_cfg(cfg: T.ModelConfig, args) -> T.ModelConfig:
    """The reference's cell config: bf16 compute, remat on unless
    ``--no-remat``, and the knobs the flags set (``--expand-kv``,
    ``--bf16-probs`` among them)."""
    upd: Dict[str, Any] = {"compute_dtype": "bfloat16",
                           "remat": not args.no_remat}
    if args.moe_impl:
        upd["moe_impl"] = args.moe_impl
    if args.flash:
        upd["use_flash"] = True
    if args.expand_kv:
        upd["expand_kv"] = True
    if args.bf16_probs:
        upd["attn_probs_fp32"] = False
    if args.remat_policy:
        upd["remat_policy"] = args.remat_policy
    if args.capacity_factor:
        upd["moe_capacity_factor"] = args.capacity_factor
    return dataclasses.replace(cfg, **upd)


def cell_rules(shape: shapes_mod.ShapeSpec, args) -> Dict[str, Any]:
    rules: Dict[str, Any] = {}
    if shape.name == "long_500k":
        # Sequence parallelism: the 500k cache shards over the data axis.
        rules["cache_seq"] = "data"
    if args.replicate_experts:
        rules["experts"] = None
    if args.shard_cache_seq:
        rules["cache_seq"] = args.shard_cache_seq
    return rules


def _serve_params(cfg: T.ModelConfig, ruleset: shd.Ruleset, bf16: bool):
    """This rank's shard of the serving parameters (tensor-parallel, no
    FSDP): fp32 masters as the reference lowers them, or with
    ``--serve-params-bf16`` the matrices in bf16 (norms stay fp32)."""
    params = T.init_params(cfg, torch.Generator(), device=META,
                           dtype=torch.bfloat16 if bf16 else torch.float32)
    return shd.shard_tree(params, ruleset.mesh, shd.Ruleset(
        mesh=ruleset.mesh, rules=ruleset.rules, fsdp=False))


def _train_state(cfg: T.ModelConfig, ruleset: shd.Ruleset) -> dict:
    params = shd.shard_tree(T.param_shapes(cfg), ruleset.mesh, ruleset)
    return train_steps.TrainState(
        params=params, opt=adamw.adamw_init(params),
        step=torch.zeros((), dtype=torch.int32, device=META)).tree()


def trace_cell(arch_id: str, shape_name: str, multi_pod: bool,
               args) -> CellResult:
    """One cell traced on rank 0 of a fake group of the mesh's ranks."""
    chips = 512 if multi_pod else 256
    with mesh_mod.fake_group(chips):
        mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod)
        mesh_name = mesh_mod.describe(mesh)
        ok, why = shapes_mod.runnable(arch_id, shape_name)
        if not ok:
            return CellResult(arch_id, shape_name, mesh_name, ok=True,
                              skipped=True, reason=why)
        cfg = prepare_cfg(configs.get_config(arch_id), args)
        shape = shapes_mod.SHAPES[shape_name]
        ruleset = shd.Ruleset(rules=cell_rules(shape, args), mesh=mesh,
                              fsdp=not args.no_fsdp and shape.kind == "train")
        kv_dtype = torch.int8 if args.kv_dtype == "int8" else None
        specs = input_specs(cfg, shape, ruleset, kv_dtype=kv_dtype)
        trace = op_analysis.OpTrace()
        t0 = time.time()
        if shape.kind == "train":
            step = train_steps.make_train_step(cfg, accum_steps=args.accum,
                                               ruleset=ruleset)
            trace.run(step, _train_state(cfg, ruleset), specs)
            mode, cache_len = "train", 0
        else:
            params = _serve_params(cfg, ruleset, args.serve_params_bf16)
            with torch.no_grad(), shd.use_ruleset(ruleset):
                if shape.kind == "prefill":
                    trace.run(serve_engine.prefill, params, cfg,
                              specs["tokens"], specs["caches"],
                              cross_kv=specs.get("cross_kv"))
                    mode, cache_len = "prefill", 0
                else:
                    trace.run(_decode, params, cfg, specs["last_tokens"],
                              specs["caches"], specs.get("cross_kv"))
                    mode, cache_len = "decode", shape.seq_len
        trace_s = time.time() - t0
    held = None if shape.kind == "train" else cache_bytes(specs["caches"])
    stats = op_analysis.collective_stats(trace)
    seq_for_flops = 1 if shape.kind == "decode" else shape.seq_len
    mf = T.model_flops(cfg, shape.global_batch, seq_for_flops,
                       mode="train" if mode == "train" else "inference",
                       cache_len=cache_len)
    terms = roofline.terms_from_trace(arch_id, shape_name, mesh_name, chips,
                                      trace, mf)
    return CellResult(
        arch=arch_id, shape=shape_name, mesh=mesh_name, ok=True,
        compile_s=trace_s, memory=op_analysis.memory_analysis_bytes(trace),
        cost={"flops": op_analysis.trace_flops(trace),
              "bytes": op_analysis.trace_bytes(trace),
              "transcendentals": op_analysis.trace_transcendentals(trace)},
        collective_bytes=float(stats.total_bytes),
        collective_detail=stats.bytes_by_kind,
        collective_count=stats.count_by_kind,
        roofline=terms.to_dict(), cache_bytes=held)


def _decode(params, cfg, last_tokens, caches, cross_kv=None):
    """The reference's ``serve_fn``: one new token a slot against the
    caches, and the next token by ``argmax``."""
    logits, new_caches = T.forward(params, cfg, last_tokens[:, None],
                                   caches=caches, cross_kv=cross_kv)
    return logits[:, -1].argmax(dim=-1).int(), new_caches


# ----------------------------------------------------------------------------
# Driver
# ----------------------------------------------------------------------------

def run(args) -> int:
    mesh_kinds = (["single", "multi"] if args.mesh == "both"
                  else [args.mesh])
    arch_ids = ([configs.canonical_id(a) for a in configs.list_archs()]
                if args.arch == "all" else [configs.canonical_id(args.arch)])
    shape_names = (list(shapes_mod.SHAPES) if args.shape == "all"
                   else [args.shape])
    results = []
    failures = 0
    for mesh_kind in mesh_kinds:
        multi = mesh_kind == "multi"
        mesh_name = "pod=2xdata=16xmodel=16" if multi else "data=16xmodel=16"
        for arch_id in arch_ids:
            for shape_name in shape_names:
                tag = f"{arch_id} x {shape_name} @ {mesh_name}"
                try:
                    res = trace_cell(arch_id, shape_name, multi, args)
                except Exception as e:  # noqa: BLE001 - report and go on
                    traceback.print_exc()
                    res = CellResult(arch_id, shape_name, mesh_name,
                                     ok=False,
                                     reason=f"{type(e).__name__}: {e}")
                    failures += 1
                results.append(res)
                if res.skipped:
                    print(f"[skip] {tag}: {res.reason}", flush=True)
                elif res.ok:
                    r = res.roofline
                    print(f"[ok]   {tag}: trace={res.compile_s:.1f}s "
                          f"flops/chip={res.cost['flops']:.3e} "
                          f"bytes/chip={res.cost['bytes']:.3e} "
                          f"coll={res.collective_bytes:.3e} "
                          f"dominant={r['dominant']} "
                          f"frac={r['roofline_fraction']:.3f}", flush=True)
                    if args.verbose:
                        print(f"       memory: {res.memory}")
                        print(f"       collectives: {res.collective_detail} "
                              f"counts {res.collective_count}")
                else:
                    print(f"[FAIL] {tag}: {res.reason}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump([dataclasses.asdict(r) for r in results], f, indent=1)
        print(f"wrote {args.out}")
    print(f"{sum(1 for r in results if r.ok and not r.skipped)} ok, "
          f"{sum(1 for r in results if r.skipped)} skipped, "
          f"{failures} failed")
    return 1 if failures else 0


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--kv-dtype", default="", choices=["", "int8"])
    ap.add_argument("--moe-impl", default="",
                    choices=["", "capacity", "dense_mask"])
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--flash", action="store_true")
    ap.add_argument("--expand-kv", action="store_true")
    ap.add_argument("--bf16-probs", action="store_true")
    ap.add_argument("--remat-policy", default="", choices=["", "full", "dots"])
    ap.add_argument("--accum", type=int, default=1,
                    help="gradient-accumulation microbatches")
    ap.add_argument("--replicate-experts", action="store_true")
    ap.add_argument("--capacity-factor", type=float, default=0.0)
    ap.add_argument("--shard-cache-seq", default="",
                    choices=["", "model", "data"])
    ap.add_argument("--serve-params-bf16", action="store_true")
    return ap


def main(argv=None):
    sys.exit(run(parser().parse_args(argv)))


if __name__ == "__main__":
    main()
