"""Meshes over a process group (port of ``repro/launch/mesh.py``), and
the processes that make the group.

A mesh here is a grid of named axes over the ranks of an initialised
``torch.distributed`` process group, one rank a device: rank r sits at
the row-major coordinates of r in the grid's shape. Each axis has a
process group per line of the grid (the ranks that differ only along
it), over which the layers' collectives run.

``run_ranks`` starts a group on this host: one spawned process a rank,
each joining ``tcp://localhost:<port>`` (a free port from a socket bound
to port 0) with its rank, the world size and a collective timeout, then
running a function. The parent waits to a deadline; a rank that raises,
dies or outlives the deadline ends every rank and the call raises, so no
rank is left blocked in a collective. ``spawn_or_join`` is the launchers'
choice between that and joining a group that ``RANK``/``WORLD_SIZE``
name. ``fake_group`` is the dry run's group of 256 or 512 ranks that
does no communication.
"""

from __future__ import annotations

import contextlib
import datetime
import math
import os
import queue as queue_mod
import socket
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


class Mesh:
    """Named axes over every rank of the default process group.

    ``shape`` maps axis -> size in axis order (the product is the world
    size); ``index(axis)`` is this rank's coordinate along an axis and
    ``group(axis)`` the process group of its line along it (the default
    group for a one-axis mesh)."""

    def __init__(self, shape: Tuple[int, ...], axes: Tuple[str, ...]):
        if not dist.is_initialized():
            raise RuntimeError("a mesh needs an initialised process group "
                               "(torch.distributed.init_process_group)")
        if len(shape) != len(axes):
            raise ValueError(f"shape {shape} and axes {axes} differ in "
                             f"length")
        world = dist.get_world_size()
        if math.prod(shape) != world:
            raise ValueError(f"mesh {dict(zip(axes, shape))} needs "
                             f"{math.prod(shape)} ranks, the group has "
                             f"{world}")
        self.axes = tuple(axes)
        self.shape: Dict[str, int] = dict(zip(axes, (int(n) for n in shape)))
        self.rank = dist.get_rank()
        self._coords = self._unravel(self.rank)
        self._groups: Dict[str, Optional[object]] = {}
        for k, axis in enumerate(self.axes):
            if len(self.axes) == 1:
                self._groups[axis] = None          # the default group
                continue
            # Every rank creates every line's group, in one order.
            for r in range(world):
                c = self._unravel(r)
                if c[k]:
                    continue
                line = [self._ravel(c[:k] + (i,) + c[k + 1:])
                        for i in range(shape[k])]
                g = dist.new_group(line)
                if self.rank in line:
                    self._groups[axis] = g

    def _unravel(self, r: int) -> Tuple[int, ...]:
        out = []
        for axis in reversed(self.axes):
            r, c = divmod(r, self.shape[axis])
            out.append(c)
        return tuple(reversed(out))

    def _ravel(self, coords: Tuple[int, ...]) -> int:
        r = 0
        for axis, c in zip(self.axes, coords):
            r = r * self.shape[axis] + c
        return r

    def index(self, axis: str) -> int:
        return self._coords[self.axes.index(axis)]

    def group(self, axis: str):
        return self._groups[axis]


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]) -> Mesh:
    """A mesh of ``shape`` over the initialised group's ranks."""
    return Mesh(tuple(shape), tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production meshes over the initialised group:
    (16, 16) over ("data", "model"), or (2, 16, 16) over ("pod", "data",
    "model") with ``multi_pod``. A group of another size raises, naming
    the ranks the mesh needs."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def single_device_mesh() -> Mesh:
    """A (1, 1) ("data", "model") mesh over a one-rank group."""
    return make_mesh((1, 1), ("data", "model"))


def make_serving_mesh(tp: Optional[int] = None) -> Optional[Mesh]:
    """The serving engine's 1-D tensor-parallel mesh, ``("model",)`` over
    ``tp`` ranks (default: the whole group). Serving has no data axis:
    every rank holds the same slots and a shard of every weight and of
    the K/V page pool. ``tp <= 1`` returns None, so the engine takes its
    one-rank path."""
    if tp is None:
        tp = dist.get_world_size() if dist.is_initialized() else 1
    if tp <= 1:
        return None
    return make_mesh((tp,), ("model",))


def describe(mesh) -> str:
    return "x".join(f"{k}={v}" for k, v in mesh.shape.items())


# ----------------------------------------------------------------------------
# Process groups on this host
# ----------------------------------------------------------------------------

@contextlib.contextmanager
def fake_group(world: int, rank: int = 0):
    """A process group of ``world`` ranks that does no communication,
    joined as ``rank`` (0: the dry run's; torch's ``"fake"`` backend over
    its ``FakeStore``, ``torch.testing._internal.distributed.fake_pg``):
    its collectives return at once and leave their tensors as they are.
    For the dry run only (``launch.dryrun``, which traces rank 0's step
    on meta tensors, and ``chip_smoke.py``'s check of it); no launcher
    that serves or trains reaches it. Raises if a group is already
    initialised; destroys the group on exit."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised; the "
                           "dry run's fake group needs a process of its own")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    """A port no socket holds now: the one the OS gives a socket bound to
    port 0."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def init_group(rank: int, world: int, port: int, backend: str = "gloo",
               timeout_s: float = 60.0) -> None:
    """Join the group at ``tcp://localhost:port`` as ``rank`` of
    ``world``; a collective that waits longer than ``timeout_s`` raises."""
    dist.init_process_group(
        backend, init_method=f"tcp://localhost:{port}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))


def maybe_init_distributed(timeout_s: float = 300.0) -> bool:
    """Join the group that ``RANK`` and ``WORLD_SIZE`` name (with
    ``MASTER_ADDR``/``MASTER_PORT``, gloo) unless one is initialised or
    they are unset; True when this call joined it (the caller destroys
    it). The counterpart of the reference launcher's
    ``jax.distributed.initialize()``."""
    if dist.is_initialized() or "RANK" not in os.environ \
            or "WORLD_SIZE" not in os.environ:
        return False
    dist.init_process_group(
        "gloo", init_method="env://", rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]),
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def rank_device(rank: int, device: str) -> torch.device:
    """The device a rank runs on: the CPU, or the card ``rank`` modulo the
    cards visible (two ranks share a card on a one-card host, which only
    a gloo group allows: NCCL refuses two ranks on one device)."""
    if device == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _child(rank: int, world: int, port: int, backend: str,
           timeout_s: float, threads: int, fn: Callable, inbox,
           out) -> None:
    try:
        if threads:
            torch.set_num_threads(threads)
        args = inbox.get()
        init_group(rank, world, port, backend, timeout_s)
        try:
            value = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, "ok", value))
    except BaseException:                      # reported, then re-raised
        out.put((rank, "error", traceback.format_exc()))
        raise


def run_ranks(fn: Callable, world: int, args: Sequence = (),
              deadline_s: float = 300.0, backend: str = "gloo",
              timeout_s: float = 60.0, threads: int = 1) -> List[Any]:
    """``fn(rank, world, *args)`` in ``world`` spawned processes joined in
    one group (``init_group``; ``torch.set_num_threads(threads)`` first,
    0 leaves it). Returns the ranks' return values in rank order. A rank
    that raises or exits without a value, or a run past ``deadline_s``,
    kills every rank and raises. ``fn`` and ``args`` must pickle (a
    module-level function), and the values should pickle by value
    (numbers, lists, numpy arrays): a torch tensor would travel as
    shared memory that dies with its rank's process."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    # ``args`` travel through a queue, not the spawn's own pipe: a start
    # blocks until its child has read that pipe, so large arguments there
    # would start the ranks one after another.
    inbox = ctx.Queue()
    inbox.cancel_join_thread()
    port = free_port()
    procs = [ctx.Process(target=_child, args=(r, world, port, backend,
                                              timeout_s, threads, fn, inbox,
                                              out), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    for _ in procs:
        inbox.put(args)
    results: Dict[int, Any] = {}
    errors: List[str] = []
    end = time.monotonic() + deadline_s
    try:
        while len(results) < world and not errors:
            left = end - time.monotonic()
            if left <= 0:
                waiting = sorted(set(range(world)) - set(results))
                errors.append(f"ranks {waiting} still running after "
                              f"{deadline_s:.0f}s")
                break
            try:
                rank, kind, value = out.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode is not None]
                if dead:
                    # Give a dying rank's report a moment to arrive.
                    try:
                        rank, kind, value = out.get(timeout=2.0)
                    except queue_mod.Empty:
                        errors.append(f"ranks {dead} exited with codes "
                                      f"{[procs[r].exitcode for r in dead]}"
                                      f" and no result")
                        break
                else:
                    continue
            if kind == "ok":
                results[rank] = value
            else:
                errors.append(f"rank {rank} failed:\n{value}")
        # The first failure often takes its peers down with it (a reset
        # connection): gather their reports a moment, so the rank that
        # failed first is named.
        drain = time.monotonic() + (2.0 if errors else 0.0)
        while time.monotonic() < drain:
            try:
                rank, kind, value = out.get(timeout=0.2)
            except queue_mod.Empty:
                continue
            if kind != "ok":
                errors.append(f"rank {rank} failed:\n{value}")
    finally:
        for p in procs:
            if errors:
                p.kill()
            p.join(timeout=30 if not errors else 5)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("; ".join(errors))
    return [results[r] for r in range(world)]


# A launcher's collective that waits this long raises; a spawned run,
# this long.
RANK_TIMEOUT_S = 300.0
RANK_DEADLINE_S = 3000.0


def spawn_or_join(fn: Callable, world: int, args: Sequence = ()) -> Any:
    """``fn(rank, world, *args)`` on ``world`` ranks, as a launcher runs
    a mesh: where ``RANK`` and ``WORLD_SIZE`` are set this process joins
    that group (which must have ``world`` ranks; ``maybe_init_distributed``)
    and returns its own value; else ``run_ranks`` spawns the ranks on
    this host (one thread each) and rank 0's value is returned."""
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        if size != world:
            raise SystemExit(f"WORLD_SIZE {size} is not the mesh's {world} "
                             f"ranks")
        joined = maybe_init_distributed(RANK_TIMEOUT_S)
        try:
            return fn(rank, world, *args)
        finally:
            if joined:
                dist.destroy_process_group()
    return run_ranks(fn, world, args=args, deadline_s=RANK_DEADLINE_S,
                     timeout_s=RANK_TIMEOUT_S, threads=1)[0]
