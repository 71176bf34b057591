"""Launcher of the CUDA pointer-chase kernel (``csrc/pchase.cu``).

Replaces ``repro/kernels/pchase_probe.py:pchase`` (the Pallas
``_chase_kernel``): one thread follows an int32 next-index chain from
position 0 for ``steps`` dependent loads and writes the visited positions.
``kernels.ops.pchase`` checks the chain and counts launches; call that,
not this.
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
