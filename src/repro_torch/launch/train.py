"""Training launcher: the trainer over synthetic data, on one device or
on a mesh of ranks.

  python -m repro_torch.launch.train --arch qwen2-0.5b --steps 30 \\
      --batch 4 --seq 512 --ckpt DIR
  python -m repro_torch.launch.train --arch qwen3-4b --smoke --device cpu \\
      --steps 30 --batch 2 --seq 16 --ckpt DIR

Runs on cuda unless ``--device cpu`` is given. Parameters are fp32
masters drawn from a ``torch.Generator`` seeded with ``--seed``, computed
in the config's dtype; attention trains through the plain ``sdpa``.
Running again with a higher ``--steps`` against the same ``--ckpt``
resumes from its last checkpoint. ``--key=value`` pairs override
``ModelConfig`` fields (``--compute_dtype=float32``); booleans take true,
false, 1 or 0. Every family trains (mixtures of experts with their aux
loss, Mamba stacks through the plain chunked scan, an encoder-decoder or
cross layers: a config with a stubbed frontend is fed zeros of shape
(batch, n_frontend_tokens, d_model), as the reference's
``frontend_stub``). ``--log-every N`` keeps every Nth step's metrics
(10 by default).

**Ranks.** ``--mesh single`` (16 x 16 over ("data", "model")) or
``--mesh multi`` (2 x 16 x 16 over ("pod", "data", "model")) trains on
the reference's production meshes, one process a rank, each started with
``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` set (a gloo
group; a group of another size raises, naming the ranks the mesh
needs), e.g. 256 of

  RANK=$r WORLD_SIZE=256 MASTER_ADDR=host0 MASTER_PORT=29500 \
      python -m repro_torch.launch.train --arch qwen2-0.5b --mesh single \
      --fsdp --ckpt DIR

``--mesh data=D,model=M`` (or ``pod=P,data=D,model=M``) trains on a
mesh of that shape: the launcher spawns its ranks on this host
(``launch.mesh.run_ranks``; on a card they share it), or joins the group
that ``RANK``/``WORLD_SIZE`` name, which must have that many ranks. Every
family trains over the model axis as over the data axis (the mixtures
split by experts, Mamba mixers by ``ssm_heads``, cross and encoder
layers by heads):

  python -m repro_torch.launch.train --arch mamba2-370m --mesh \
      data=1,model=2 --batch 4 --seq 512 --steps 3 --ckpt DIR
  python -m repro_torch.launch.train --arch jamba-v0.1-52b --smoke \
      --device cpu --mesh data=1,model=2 --steps 3 --ckpt DIR

Each rank runs on the card ``RANK`` modulo the cards it sees; rank 0
prints. ``--fsdp`` also shards large leaves over "data"; without a mesh
it does nothing, as in the reference. ``build(cfg, args, device, mesh)``
takes any ``launch.mesh.Mesh`` (tests and ``chip_smoke.py`` phases 24-25
use (2, 1) and (1, 2) meshes over ``launch.mesh.run_ranks``). gloo runs
only ``all_reduce`` and ``broadcast`` on CUDA tensors, which is all the
step uses.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import math
import os
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import configs, resolve_device
from repro_torch.configs import ModelConfig
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.dist import sharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.optim import schedule
from repro_torch.train import steps as steps_mod
from repro_torch.train.trainer import Trainer, TrainerConfig

_BOOLS = {"true": True, "1": True, "false": False, "0": False}


def _parse_bool(value: str) -> bool:
    if value.lower() not in _BOOLS:
        raise ValueError(f"not a boolean: {value!r} (true, false, 1 or 0)")
    return _BOOLS[value.lower()]


def apply_overrides(cfg: ModelConfig, overrides: Dict[str, str]) -> ModelConfig:
    """``cfg`` with each field named in ``overrides`` parsed from its
    string to the field's current type. Booleans are parsed strictly (the
    reference's ``bool("False")`` is True)."""
    fields = {f.name for f in dataclasses.fields(cfg)}
    typed: Dict[str, Any] = {}
    for k, v in overrides.items():
        if k not in fields:
            raise ValueError(f"unknown config field {k}")
        kind = type(getattr(cfg, k))
        if kind is bool:
            typed[k] = _parse_bool(v)
        elif kind in (int, float, str):
            typed[k] = kind(v)
        else:
            raise ValueError(f"config field {k} ({kind.__name__}) cannot be "
                             f"overridden from the command line")
    return dataclasses.replace(cfg, **typed)


def train_ruleset(mesh, fsdp: bool) -> Optional[sharding.Ruleset]:
    """The sharding a train step runs under: None without a mesh (so
    ``--fsdp`` alone does nothing, as in the reference)."""
    return sharding.Ruleset(mesh=mesh, fsdp=fsdp) if mesh else None


def build(cfg: ModelConfig, args, device, mesh=None):
    """(step function, fresh-state function) for the trainer; on a
    ``mesh`` (``launch.mesh.Mesh``), under ``train_ruleset(mesh,
    args.fsdp)``: each rank's state is its shards of the seed's tree and
    the step computes the single-device step's result."""
    ruleset = train_ruleset(mesh, args.fsdp)
    sched = schedule.ScheduleConfig(peak_lr=args.lr, warmup_steps=args.warmup,
                                    total_steps=args.steps)
    step = steps_mod.make_train_step(cfg, sched=sched,
                                     accum_steps=args.accum,
                                     compress_grads=args.compress_grads,
                                     error_feedback=args.error_feedback,
                                     ruleset=ruleset)

    def init_fn():
        return steps_mod.init_state(cfg, args.seed, device,
                                    error_feedback=args.error_feedback,
                                    ruleset=ruleset).tree()

    return step, init_fn


def frontend_stub(cfg: ModelConfig, device):
    """batch size -> the frontend's stand-in, zeros (b, n_frontend_tokens,
    d_model) in the compute dtype; None for a config without a frontend."""
    if not cfg.n_frontend_tokens:
        return None

    def make(batch: int) -> torch.Tensor:
        return torch.zeros((batch, cfg.n_frontend_tokens, cfg.d_model),
                           dtype=cfg.dtype, device=device)

    return make


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, type=configs.canonical_id,
                    choices=list(configs.ALIASES),
                    help="a CLI id or its module's name "
                         "(configs.list_archs())")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", required=True, help="checkpoint directory")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--fsdp", action="store_true",
                    help="shard large leaves over the data axis (with "
                         "--mesh)")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--error-feedback", action="store_true",
                    help="carry the int8 quantization residual in the "
                         "train state (EF-SGD); implies --compress-grads")
    ap.add_argument("--mesh", default="none",
                    help="none; single or multi (the reference's "
                         "production meshes over the ranks that "
                         "RANK/WORLD_SIZE name); or a shape such as "
                         "data=1,model=2 (ranks spawned here unless "
                         "RANK/WORLD_SIZE name a group)")
    ap.add_argument("--device", default="cuda")
    args, extra = ap.parse_known_args(argv)
    bad = [a for a in extra if "=" not in a]
    if bad:
        ap.error(f"unrecognized arguments: {' '.join(bad)}")
    if args.error_feedback:
        args.compress_grads = True

    cfg = configs.get_smoke(args.arch) if args.smoke \
        else configs.get_config(args.arch)
    overrides = dict(a.lstrip("-").split("=", 1) for a in extra)
    if overrides:
        cfg = apply_overrides(cfg, overrides)

    shape = parse_mesh(args.mesh)
    if shape is not None:
        world = math.prod(shape[0])
        if world == 1 and "RANK" not in os.environ:
            return _train(cfg, args, resolve_device(args.device), None)
        # Tensors do not outlive their rank's process: rank 0's logs come
        # back, its state stays in the checkpoint.
        return mesh_lib.spawn_or_join(_train_rank, world, (cfg, args, shape))
    joined = mesh_lib.maybe_init_distributed()
    try:
        mesh, device = None, resolve_device(args.device)
        if args.mesh != "none":
            mesh = mesh_lib.make_production_mesh(
                multi_pod=args.mesh == "multi")
        if mesh is not None:
            device = mesh_lib.rank_device(mesh.rank, args.device)
            if device.type == "cuda":
                torch.cuda.set_device(device)
        if mesh is not None and mesh.rank != 0:
            with contextlib.redirect_stdout(io.StringIO()):
                return _train(cfg, args, device, mesh)
        return _train(cfg, args, device, mesh)
    finally:
        if joined:
            torch.distributed.destroy_process_group()


MESH_AXES = ("pod", "data", "model")


def parse_mesh(spec: str) -> Optional[Tuple[Tuple[int, ...],
                                            Tuple[str, ...]]]:
    """``--mesh``'s shape form, e.g. ``data=1,model=2`` -> ((1, 2),
    ("data", "model")): axes among pod, data and model in that order
    (data and model always present, 1 where not named); None for
    ``none``, ``single`` and ``multi``."""
    if spec in ("none", "single", "multi"):
        return None
    sizes: Dict[str, int] = {}
    for part in spec.split(","):
        axis, _, size = part.partition("=")
        if axis not in MESH_AXES or not size.isdigit() or int(size) < 1 \
                or axis in sizes:
            raise SystemExit(f"--mesh wants none, single, multi or "
                             f"AXIS=N[,AXIS=N] over {MESH_AXES}, got "
                             f"{spec!r}")
        sizes[axis] = int(size)
    axes = tuple(a for a in MESH_AXES if a != "pod" or a in sizes)
    return tuple(sizes.get(a, 1) for a in axes), axes


def _train_rank(rank: int, world: int, cfg: ModelConfig, args, shape):
    """One spawned rank of ``--mesh AXIS=N``: its device, the mesh over the
    group, the run; returns the logged metrics (rank 0 prints)."""
    mesh = mesh_lib.make_mesh(*shape)
    device = mesh_lib.rank_device(rank, args.device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    out = contextlib.nullcontext() if rank == 0 \
        else contextlib.redirect_stdout(io.StringIO())
    with out:
        result = _train(cfg, args, device, mesh)
    return {"metrics": [{k: float(v) for k, v in m.items()}
                        for m in result["metrics"]],
            "recoveries": result["recoveries"],
            "stragglers": list(result["stragglers"])}


def _train(cfg: ModelConfig, args, device, mesh):
    data = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                      global_batch=args.batch,
                                      seed=args.seed))
    step_fn, init_fn = build(cfg, args, device, mesh)
    trainer = Trainer(
        TrainerConfig(checkpoint_dir=args.ckpt, total_steps=args.steps,
                      checkpoint_every=args.ckpt_every,
                      log_every=args.log_every),
        cfg, data, step_fn, init_fn, device=device,
        frontend_fn=frontend_stub(cfg, device),
        ruleset=train_ruleset(mesh, args.fsdp))
    result = trainer.run()
    for m in result["metrics"]:
        print(f"step {m['step']:5d} loss={m['loss']:.4f} "
              f"nll={m['nll']:.4f} lr={m['lr']:.2e} dt={m['dt']:.3f}s")
    print(f"done: {len(result['metrics'])} logs, "
          f"{result['recoveries']} recoveries, "
          f"{len(result['stragglers'])} stragglers")
    return result


if __name__ == "__main__":
    main()
