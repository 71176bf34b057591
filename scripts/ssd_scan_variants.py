#!/usr/bin/env python3
"""Time variants of the port's bf16 SSD scan kernel on one CUDA card.

    python3 scripts/ssd_scan_variants.py

Each variant is ``src/repro_torch/kernels/csrc/ssd_scan.cu`` with one
design choice of its bf16 body undone: an edited copy of
``src/repro_torch/`` under
``build/ssd_variants/<name>/``, built by the port's own ``_build``
(all copies in parallel) and timed in a process of its own. The time is the
device time of a batch-1 scan at the main path's head shape (h 32, p 64,
n 128) at l 128, 1024 and 1536: 50 launches over 12 input sets queued
behind a spin of the card (``chip_smoke.time_ms(..., spin=True)``), the
best of 3 repeats, at the default chunk (``chip_smoke.py`` phase 29 times
every chunk the kernel instantiates). The kernel as it is runs first and
last. Variants that compute a wrong result are marked "time only"; the
others are checked against the plain version at each length first. The
last line is a JSON object of the times. Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "ssd_variants")
CU = "src/repro_torch/kernels/csrc/ssd_scan.cu"
PY = "src/repro_torch/kernels/ssd_scan.py"
LENGTHS = (128, 1024, 1536)

SCORE_LOOP = """#pragma unroll
    for (int jp = 0; jp < kRB; ++jp) {
      if (jp > rb) break;
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        uint32_t ca[4], b[4];
        ldsm_x4(c_row + kk * 32, ca);
        ldsm_x4(b_s + ((jp * 16 + (lane & 7) + 8 * (lane >> 4)) * kRowN +
                       kk * 16 + 8 * ((lane >> 3) & 1)) * 2, b);
        mma_bf16(s[2 * jp], ca, b[0], b[1]);
        mma_bf16(s[2 * jp + 1], ca, b[2], b[3]);
      }
    }"""
SCORE_LOOP_K_OUTER = """#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      uint32_t ca[4];
      ldsm_x4(c_row + kk * 32, ca);
#pragma unroll
      for (int jp = 0; jp < kRB; ++jp) {
        if (jp > rb) break;
        uint32_t b[4];
        ldsm_x4(b_s + ((jp * 16 + (lane & 7) + 8 * (lane >> 4)) * kRowN +
                       kk * 16 + 8 * ((lane >> 3) & 1)) * 2, b);
        mma_bf16(s[2 * jp], ca, b[0], b[1]);
        mma_bf16(s[2 * jp + 1], ca, b[2], b[3]);
      }
    }"""

# name: (checked against the plain version, [(file, old, new), ...])
VARIANTS = {
    "as built": (True, []),
    "p-blocks of 16": (True, [
        (CU, "constexpr int kPBlock = 32;", "constexpr int kPBlock = 16;"),
        (PY, "P_BLOCK = 32 ", "P_BLOCK = 16 ")]),
    "accurate expf for the decay": (True, [
        (CU, "fast_exp2((ci - cum_s[j]) * kLog2e)", "expf(ci - cum_s[j])")]),
    "branch inside the k loop": (True, [(CU, SCORE_LOOP, SCORE_LOOP_K_OUTER)]),
    "__threadfence in the hand-off": (True, [
        (CU, "      st_release(done, chunk + 1);",
         "      __threadfence();\n      st_release(done, chunk + 1);"),
        (CU, "      if (global_ns() - t0 > 10000000000ull) __trap();\n    }\n",
         "      if (global_ns() - t0 > 10000000000ull) __trap();\n    }\n"
         "    __threadfence();\n")]),
    "no hand-off wait (time only)": (False, [
        (CU, "  if (chunk > 0 && threadIdx.x == 0) {",
         "  if (false && chunk > 0 && threadIdx.x == 0) {")]),
}


def slug(name: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in name).strip("_")


def make_copy(name: str, edits) -> str:
    d = os.path.join(OUT, slug(name))
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "src", "repro_torch"),
                    os.path.join(d, "src", "repro_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), d)
    for rel, old, new in edits:
        path = os.path.join(d, rel)
        text = open(path).read()
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name!r}: edit not found in {rel}")
        open(path, "w").write(text.replace(old, new))
    return d


def time_here(check: bool) -> dict:
    """In a variant's copy: device ms at each length (best of 3), and
    whether the scan agrees with its plain version."""
    sys.path[:0] = [os.path.join(os.getcwd(), "src"), os.getcwd()]
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    out = {}
    for l in LENGTHS:
        sets = [cs.ssd_inputs(gen, dev, torch.bfloat16, 1, l)[:4]
                for _ in range(12)]
        ok = None
        if check:
            y, st = ops.ssd_scan(*sets[0])
            wy, ws = ref.ssd_scan(*sets[0], chunk=cs.SSD_CHUNK)
            ok = (ref.compare(y, wy, normwise=True)[0]
                  and ref.compare(st, ws, normwise=True)[0])
        ms = min(cs.time_ms(lambda i: ops.ssd_scan(*sets[i]), 12, spin=True)
                 for _ in range(3))
        out[l] = {"device_ms": ms, "agrees": ok}
    return out


def main() -> None:
    if sys.argv[1:2] == ["--time"]:
        print(json.dumps(time_here(sys.argv[2] == "1")))
        return
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("ssd_scan_variants: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dirs = {name: make_copy(name, edits)
            for name, (_, edits) in VARIANTS.items()}
    build = ("import sys; sys.path.insert(0, 'src'); "
             "from repro_torch.kernels import _build; _build.build()")
    procs = {n: subprocess.Popen([sys.executable, "-c", build], cwd=d,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for n, d in dirs.items()}
    for n, p in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"variant {n!r} did not build:\n{log}")
    results = {}
    order = list(VARIANTS) + ["as built"]
    for i, name in enumerate(order):
        check = VARIANTS[name][0]
        run = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--time",
             "1" if check else "0"], cwd=dirs[name], capture_output=True,
            text=True, timeout=300)
        if run.returncode != 0:
            raise RuntimeError(f"variant {name!r} failed:\n{run.stderr}")
        r = json.loads(run.stdout.strip().splitlines()[-1])
        key = name if i < len(VARIANTS) else "as built, again"
        results[key] = r
        if check and not all(v["agrees"] for v in r.values()):
            raise RuntimeError(f"variant {name!r} disagrees with the plain "
                               f"version: {r}")
        print(f"{key:32s} " + "  ".join(
            f"l {l}: {v['device_ms']:.4f} ms" for l, v in r.items()),
            flush=True)
    print(smi)
    print(json.dumps({"card": smi, "device_ms": {
        k: {l: v["device_ms"] for l, v in r.items()}
        for k, r in results.items()}}))


if __name__ == "__main__":
    main()
