"""Launchers of the CUDA pointer-chase kernels (``csrc/pchase.cu``).

``pchase`` replaces ``repro/kernels/pchase_probe.py:pchase`` (the Pallas
``_chase_kernel``): one thread follows an int32 next-index chain from
position 0 for ``steps`` dependent loads and writes the visited positions.
``pchase_timed`` is the same chase timed load by load (the paper's
fine-grained p-chase) over a chain of int64 byte offsets, the format of
``core.simulator.make_chain``. ``kernels.ops.pchase`` and
``kernels.ops.pchase_timed`` check their arguments and count launches;
call those, not these.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build


def pchase(chain, out) -> None:
    """Launch on the current stream; raise if the launch fails."""
    lib = _build.load()
    err = lib.pchase(chain.data_ptr(), out.data_ptr(), out.shape[0],
                     torch.cuda.current_stream(chain.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pchase launch failed: error {err}")


def pchase_timed(chain, start: int, warm: int, offsets, cycles, total,
                 status, bypass_l1: bool, carveout: int) -> None:
    """Launch on the current stream after setting the kernel's shared
    memory carveout; raise if either fails. ``offsets`` may be None."""
    lib = _build.load()
    err = lib.pchase_timed(
        chain.data_ptr(), None if offsets is None else offsets.data_ptr(),
        cycles.data_ptr(), total.data_ptr(), status.data_ptr(),
        chain.shape[0] * 8, start,
        warm, cycles.shape[0], int(bypass_l1), carveout,
        torch.cuda.current_stream(chain.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pchase_timed launch failed: error {err}")
