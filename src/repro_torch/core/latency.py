"""Instruction and memory latency dissection — paper §4.1 and ch.3.

Three parts, as in ``repro/core/latency.py`` plus the pointer chase:

* **Model**: a scoreboard pipeline over the published latency tables
  (``hwmodel.VOLTA_INSTR_LATENCY`` / ``PASCAL_INSTR_LATENCY``). The paper's
  measurement method — shrink the control-word stall count of instruction A
  until its dependent consumer B reads a stale value — is reproduced as
  ``measure_fixed_latency``: the smallest stall preserving correctness is
  the latency. Pure Python; the same answers as the reference.

* **Dependent op chains** (``measure_op_chain``): n dependent applications
  of a torch op, timed as one unit. On the card the chain is one captured
  CUDA graph (the counterpart of the reference's jitted ``fori_loop``), so
  the time per application is the op's kernel and its dependent issue, not
  Python's dispatch; on a CPU tensor it is a timed eager loop.

* **Pointer chase** (``line_chain``, ``chase_ns_per_step``): the paper's
  ch.3 primitive on the card. A random single-cycle chain over 128-byte
  lines of a footprint, followed by the ``pchase`` kernel; the time per
  dependent load, swept over footprints, shows the L1, the L2 and device
  memory with its TLB.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Sequence, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops


# ----------------------------------------------------------------------------
# Scoreboard model + control-word measurement method
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModelInstr:
    op: str
    dst: int
    srcs: Tuple[int, ...]
    stall: int = 0              # control-word stall cycles (paper §2.1)


class Scoreboard:
    """In-order issue with control-word stalls, per the paper's description:
    fixed-latency instructions are *statically* scheduled — the hardware does
    not interlock; a too-small stall lets a consumer read a stale value."""

    def __init__(self, latencies: Dict[str, int]):
        self.latencies = latencies

    def run(self, instrs: Sequence[ModelInstr]) -> Tuple[int, bool]:
        """Returns (total_cycles, correct). ``correct`` is False if any
        consumer issued before its producer's result was ready."""
        ready: Dict[int, int] = {}
        t = 0
        correct = True
        for ins in instrs:
            for s in ins.srcs:
                if ready.get(s, 0) > t:
                    correct = False
            lat = self.latencies[ins.op]
            ready[ins.dst] = t + lat
            t += 1 + ins.stall
        return t, correct


def measure_fixed_latency(board: Scoreboard, op: str,
                          max_stall: int = 32) -> int:
    """The paper's §4.1 method: decrease A's stall cycles until B consumes a
    stale value; the smallest correct stall + 1 issue cycle is A's latency."""
    for stall in range(max_stall, -1, -1):
        prog = [ModelInstr(op, dst=1, srcs=(0,), stall=stall),
                ModelInstr(op, dst=2, srcs=(1,), stall=0)]
        _, ok = board.run(prog)
        if not ok:
            return stall + 2            # failing stall +1 back, +1 issue cycle
    return 1


def dependent_chain_cycles(board: Scoreboard, op: str, n: int) -> int:
    """Cycles to retire an n-deep dependent chain with correct scheduling."""
    lat = board.latencies[op]
    prog = [ModelInstr(op, dst=i + 1, srcs=(i,), stall=lat - 1)
            for i in range(n)]
    cycles, ok = board.run(prog)
    if not ok:
        raise RuntimeError(f"{op}: a chain at stall {lat - 1} read a stale "
                           f"value")
    return cycles


# ----------------------------------------------------------------------------
# Wall-clock dependent-chain harness
# ----------------------------------------------------------------------------

def measure_op_chain(op: Callable, x0: torch.Tensor, n: int = 1024,
                     repeats: int = 5) -> float:
    """Nanoseconds per dependent application of ``op`` on ``x0``'s device:
    the best of ``repeats`` runs of the n-deep chain, over n.

    ``op`` must map a tensor to a same-shaped tensor; the chain forces
    serialization the same way the paper's SASS chains do. On the card the
    chain is captured once as a CUDA graph and each run is one replay and a
    synchronise."""
    def chain(x):
        for _ in range(n):
            x = op(x)
        return x

    if x0.device.type == "cuda":
        x = x0.clone()
        side = torch.cuda.Stream(x0.device)
        side.wait_stream(torch.cuda.current_stream(x0.device))
        with torch.cuda.stream(side):
            chain(x)                       # warm up before capture
        torch.cuda.current_stream(x0.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            chain(x)
        run = graph.replay
        sync = lambda: torch.cuda.synchronize(x0.device)  # noqa: E731
    else:
        run = lambda: chain(x0)           # noqa: E731
        sync = lambda: None               # noqa: E731
    run()
    sync()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter_ns()
        run()
        sync()
        best = min(best, (time.perf_counter_ns() - t0) / n)
    return best


def standard_op_suite() -> Dict[str, Callable]:
    return {
        "add": lambda x: x + 1.0,
        "mul": lambda x: x * 1.0000001,
        "fma": lambda x: x * 1.0000001 + 1e-9,
        "exp": lambda x: torch.exp(x) * 1e-9,
        "rsqrt": lambda x: 1.0 / torch.sqrt(torch.abs(x) + 1.0),
        "tanh": lambda x: torch.tanh(x),
    }


# ----------------------------------------------------------------------------
# Pointer chase (paper ch.3) through the pchase kernel
# ----------------------------------------------------------------------------

LINE_BYTES = 128
STEPS = 65_536
# Footprints of the sweep: within the L1 (256 KB per SM, shared with
# shared memory), within the 50 MB L2, and past it in device memory, where
# the chase also walks more pages than the TLBs map.
FOOTPRINTS = (16 * 2**10, 128 * 2**10, 2**20, 16 * 2**20, 128 * 2**20,
              512 * 2**20)


def line_chain(footprint: int, seed: int = 0, device=None) -> torch.Tensor:
    """A ``footprint``-byte int32 chain whose first word of each
    ``LINE_BYTES``-byte line points to the next line's first word in one
    random cycle through all of them (the other words are 0), so each step
    loads a new line that the previous load named, with no stride a
    prefetcher could learn.
    Position 0 lies on the cycle. The reference's host chase
    (``benchmarks/tpu_vmem.py``) builds the same chain at 64 bytes."""
    dev = resolve_device(device)
    words = LINE_BYTES // 4
    n_lines = footprint // LINE_BYTES
    if n_lines < 1:
        raise ValueError(f"footprint {footprint} holds no {LINE_BYTES}-byte "
                         f"line")
    gen = torch.Generator(device=dev).manual_seed(seed)
    order = torch.randperm(n_lines, generator=gen, device=dev)
    chain = torch.zeros(n_lines * words, dtype=torch.int32, device=dev)
    chain[order * words] = (torch.roll(order, -1) * words).int()
    return chain


def chase_ns_per_step(footprint: int, steps: int = STEPS,
                      device=None) -> float:
    """Nanoseconds per dependent load of the ``pchase`` kernel over a
    ``line_chain`` of ``footprint`` bytes: one timed launch of ``steps``
    steps from position 0.

    One warm-up launch first walks the whole cycle (at least ``steps``
    steps), so the timed launch finds the caches as a chase over this
    footprint leaves them: its lines resident where the footprint fits, its
    first lines long evicted where it does not. The warm-up also checks
    the chain, once. On the card the launch is timed by CUDA events; on
    the CPU the plain version runs on the host clock."""
    dev = resolve_device(device)
    chain = line_chain(footprint, device=dev)
    ops.pchase(chain, max(steps, footprint // LINE_BYTES))
    if dev.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize(dev)
        start.record()
        ops.pchase(chain, steps)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e6 / steps
    t0 = time.perf_counter_ns()
    ops.pchase(chain, steps)
    return (time.perf_counter_ns() - t0) / steps
