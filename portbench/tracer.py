"""The device trace of a slice of the window: ``torch.profiler`` over a
whole number of ticks, written out as a Chrome trace (in a temporary
directory under ``TMPDIR``) and read back.

From it: the seconds in which an operation ran on the device (the union
of kernel, copy and set intervals), each kernel family's device seconds
(``families.py``), and the idle gaps between device operations, each named
by what the host was doing at its middle (the harness phase and the
innermost host operation). The harness's own record of the slice (decode
rows and their contexts, the paged prefill chunks) rides along for the
readers that count work.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from portbench import families

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "cuda_runtime", "cuda_driver"}


@dataclasses.dataclass
class Profile:
    window_s: float
    busy_s: float
    family_s: Dict[str, float]
    ops: List[Tuple[str, float]]          # top device operations
    idle: List[Tuple[str, float]]         # idle seconds by host activity
    decode_calls: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)             # (live rows, context rows) a step
    chunk_calls: List[Tuple[int, int, int]] = dataclasses.field(
        default_factory=list)             # (rid, start, valid rows) a chunk


class Tracer:
    """Start and stop ``torch.profiler`` at tick boundaries, the device
    idle at both (a synchronise before each); read the trace after the
    window. Building one traces a tiny step once, so that the profiler's
    own start-up (CUPTI's, seconds) falls in the set-up, not the window."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        self._torch = torch
        self.record_function = record_function
        activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=activities):
            (torch.zeros(8, device="cuda") + 1).sum().item()
        self.prof = profile(activities=activities)
        self._window = None

    def start(self) -> None:
        self._torch.cuda.synchronize()
        self.prof.start()
        self._window = self.record_function("portbench.window")
        self._window.__enter__()

    def stop(self) -> None:
        self._torch.cuda.synchronize()
        self._window.__exit__(None, None, None)
        self.prof.stop()

    def read(self) -> Profile:
        with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        return read_trace(events.get("traceEvents", events))


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _short(name: str) -> str:
    return name.split("(")[0][:80]


def read_trace(events: List[dict], top: int = 10) -> Profile:
    """A Chrome trace's events -> the traced window's ``Profile``. Times
    in the trace are microseconds."""
    window: Optional[Tuple[float, float]] = None
    device, host, phases = [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        ts, dur = float(e.get("ts", 0)), float(e.get("dur", 0))
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat == "user_annotation" and name == "portbench.window":
            window = (ts, ts + dur)
        elif cat in DEVICE_CATS:
            device.append((ts, ts + dur, name))
        elif cat == "user_annotation" and name.startswith("portbench."):
            phases.append((ts, ts + dur, name[len("portbench."):]))
        elif cat in HOST_CATS:
            host.append((ts, ts + dur, name))
    if window is None:
        lo = min((a for a, _, _ in device), default=0.0)
        hi = max((b for _, b, _ in device), default=0.0)
        window = (lo, hi)
    w0, w1 = window
    device = [(max(a, w0), min(b, w1), n) for a, b, n in device
              if b > w0 and a < w1]
    busy = _union([(a, b) for a, b, _ in device])
    family_s: Dict[str, float] = defaultdict(float)
    op_s: Dict[str, float] = defaultdict(float)
    for a, b, n in device:
        fam = families.family(n)
        family_s[fam] += (b - a) / 1e6
        op_s[fam if fam != "other" else _short(n)] += (b - a) / 1e6
    # Idle gaps, named by the host's phase (the harness's phases follow
    # one another) and innermost operation (the latest started one that
    # spans it) at their middle.
    host.sort()
    phases.sort()
    h_starts = [a for a, _, _ in host]
    p_starts = [a for a, _, _ in phases]
    idle: Dict[str, float] = defaultdict(float)
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        i = bisect.bisect_right(p_starts, mid)
        phase = phases[i - 1][2] if i and phases[i - 1][1] >= mid \
            else "between phases"
        i = bisect.bisect_right(h_starts, mid)
        inner = next((n for s, t, n in reversed(host[max(0, i - 64):i])
                      if t >= mid), None)
        label = phase + " / " + (_short(inner) if inner else "python")
        idle[label] += (b - a) / 1e6
    busy_s = sum(b - a for a, b in busy) / 1e6
    return Profile(
        window_s=(w1 - w0) / 1e6, busy_s=busy_s, family_s=dict(family_s),
        ops=sorted(op_s.items(), key=lambda kv: -kv[1])[:top],
        idle=sorted(idle.items(), key=lambda kv: -kv[1])[:top])
