"""Launcher of the CUDA SSD scan kernel (``csrc/ssd_scan.cu``).

Replaces ``repro/kernels/ssd_scan.py:ssd_scan`` (the Pallas ``_ssd_kernel``):
the chunked Mamba-2 scan. One CTA per (head x p-block of ``P_BLOCK`` rows,
chunk of ``chunk`` rows, batch row), the (p, n) state handed from chunk to
chunk inside the launch through an int ticket and count per (batch row,
head, p-block); ``grid`` and ``sync_ints`` size both from shapes alone.
The chunk is one of ``CHUNKS``, each a template instance of both bodies
(bf16 and fp32); the reference's default is ``DEFAULT_CHUNK``.
``kernels.ops.ssd_scan`` checks the arguments, snaps the chunk to an
instantiated one and counts launches; call that, not this.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_decode import DTYPES, _raise_on, zeroed_ints

CHUNKS = (32, 64, 128)      # chunks the build instantiates
DEFAULT_CHUNK = 128         # the reference's ``ops.ssd_scan(chunk=128)``
P_BLOCK = 32                # rows of p a CTA owns
# (head_dim p, d_state n) the build instantiates: mamba2-370m's, jamba's.
SHAPES = ((64, 128), (64, 16))
GRID_YZ_LIMIT = 65535       # CUDA's bound on a grid's y and z


def grid(bt: int, l: int, h: int, p: int,
         chunk: int) -> Tuple[int, int, int]:
    """The launch grid: (head x p-block, chunk, batch row)."""
    return h * (p // P_BLOCK), -(-l // chunk), bt


def sync_ints(bt: int, h: int, p: int) -> int:
    """Zeroed ints the hand-off needs: a ticket and a count per (batch
    row, head, p-block)."""
    return 2 * bt * h * (p // P_BLOCK)


def check_grid(bt: int, l: int, h: int, p: int, chunk: int) -> None:
    """Raise where the grid would pass CUDA's limits: a chunk a y-block,
    a batch row a z-block."""
    _, gy, gz = grid(bt, l, h, p, chunk)
    if max(gy, gz) > GRID_YZ_LIMIT:
        raise ValueError(f"ssd_scan at bt {bt}, l {l}, chunk {chunk} needs "
                         f"a grid of {gy} chunks x {gz} rows; CUDA allows "
                         f"{GRID_YZ_LIMIT} in each")


def ssd_scan(x, a_log, b, c, h0, y, state, chunk: int) -> None:
    """Launch on the current stream at ``chunk`` (one of ``CHUNKS``; the
    C entry refuses any other); raise if the launch fails. ``h0`` None
    starts from a zero state."""
    lib = _build.load()
    bt, l, h, p = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    sync = zeroed_ints(x.device, stream, sync_ints(bt, h, p))
    _raise_on(lib.ssd_scan(
        DTYPES[x.dtype], p, b.shape[-1], chunk, x.data_ptr(),
        a_log.data_ptr(), b.data_ptr(), c.data_ptr(),
        None if h0 is None else h0.data_ptr(), y.data_ptr(),
        state.data_ptr(), sync.data_ptr(), bt, l, h, stream), "ssd_scan")
