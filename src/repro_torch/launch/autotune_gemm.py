"""Microbenchmark-informed GEMM tiling on the card: the hardware model
(``core.autotune``, priced on the H100) picks the tile, the CUDA kernel
runs it, and the output is held against the plain version.

  python -m repro_torch.launch.autotune_gemm               # on the card
  python -m repro_torch.launch.autotune_gemm --device cpu  # rehearsal

For each problem it prints the tuned bf16 tile and the modelled speedup
over the naive (smallest) bf16 tile, priced at the tensor cores' rate; on
the card also the kernel's measured time with every instantiated bf16
tile (the tensor-core kernel), inputs from a seeded ``torch.Generator``.
Counterpart of ``examples/autotune_gemm.py``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import autotune
from repro_torch.kernels import ops, ref
from repro_torch.kernels import gemm as gemm_kernel

PROBLEMS = ((512, 512, 512), (1024, 4096, 1024))


def kernel_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn()`` over ``iters`` launches, after two."""
    for _ in range(2):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rows = []
    gen = torch.Generator(device=dev).manual_seed(0)
    for m, k, n in PROBLEMS:
        p = autotune.GemmProblem(m=m, k=k, n=n)
        gain = autotune.tuning_gain(p)
        naive, tuned = gain["naive"]["config"], gain["tuned"]["config"]
        print(f"GEMM {m}x{k}x{n}: tuned block={tuned} modeled speedup vs "
              f"naive {naive} = {gain['speedup']:.2f}x (traffic "
              f"{gain['naive']['traffic_bytes'] / 2**20:.0f} -> "
              f"{gain['tuned']['traffic_bytes'] / 2**20:.0f} MiB)")
        row = {"shape": (m, k, n), "naive": naive, "tuned": tuned,
               "modelled_speedup": gain["speedup"]}
        if dev.type == "cuda":
            x = torch.randn(m, k, generator=gen, device=dev).bfloat16()
            y = torch.randn(k, n, generator=gen, device=dev).bfloat16()
            row["ms"] = {t: kernel_ms(lambda t=t: ops.gemm(x, y, block=t))
                         for t in gemm_kernel.TILES[torch.bfloat16]}
            row["measured_speedup"] = row["ms"][naive] / row["ms"][tuned]
            ok, err = ref.compare(ops.gemm(x, y), ref.gemm(x, y),
                                  normwise=True)
            row["max_abs_err"] = err
            print(f"  kernel, bf16 ({gemm_kernel.last_path}): " + ", ".join(
                f"{t} {ms:.4f} ms ({2 * m * k * n / ms / 1e9:.1f} TFLOP/s)"
                for t, ms in row["ms"].items())
                + f"; measured speedup of the tuned tile "
                f"{row['measured_speedup']:.2f}x; tuned tile against the "
                f"plain version: max_abs_err {err:.3e} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"gemm {m}x{k}x{n} disagrees with its "
                                   f"plain version: {err}")
        rows.append(row)
    if dev.type == "cpu":
        rng = np.random.RandomState(0)
        x = torch.from_numpy(rng.randn(256, 512).astype(np.float32))
        y = torch.from_numpy(rng.randn(512, 256).astype(np.float32))
        np.testing.assert_allclose(ops.gemm(x, y).numpy(), (x @ y).numpy(),
                                   rtol=1e-4, atol=1e-3)
        print("gemm with the tuned tile == plain version (CPU): OK")
    return {"device": str(dev), "problems": rows}


if __name__ == "__main__":
    main()
