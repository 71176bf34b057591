"""The work of the kernels the dry run reaches: bytes moved and FLOPs,
from shapes alone. One count, read by the wrappers' meta branches
(``kernels.ops``: the dry run's op census, ``core.op_analysis``) and by
``chip_smoke.py``'s bounds of the same kernels.

Bytes are each input read once and each output written once (the
analogue of an HLO fusion, which counts only its outside operands and
results), plus, in a launch's record, the decode's split partials, the
one traffic its tile adds (``flash_decode(n_splits=)``; a bound leaves
them out). A prefill's query block changes neither count: its padded
rows are not useful FLOPs, and its K/V re-reads are not the function's
bytes. FLOPs are the multiply-adds of the products, two a
multiply-add. The exponentials and the softmax's sums are not counted,
as ``torch.utils.flop_counter`` counts none for the plain versions.
"""

from __future__ import annotations

from typing import Tuple


def flash_decode(b: int, h: int, kvh: int, d: int, esize: int,
                 kv_rows: int, lse: bool = False,
                 n_splits: int = 0) -> Tuple[int, int]:
    """(bytes, FLOPs) of a contiguous decode of b query rows of h heads
    over ``kv_rows`` cache rows in all (the sum of the slots' lengths;
    the dry run's static shapes take every row of the cache): q read and
    the output written, each row's K and V of ``kvh`` heads read, the
    int32 lengths, and with ``lse`` the fp32 (b, h) log-sum-exps
    written. Each query head scores and sums each row: 4 d FLOPs.

    ``n_splits``: the splits the launched tile cuts each slot into
    (``flash_decode.splits``); each writes its fp32 partial (d + 2 floats
    a query row) and the merge reads it back. 0, the function's own
    inputs and outputs alone, is what a bound counts."""
    nbytes = 2 * b * h * d * esize + 2 * kv_rows * kvh * d * esize + 4 * b
    if lse:
        nbytes += 4 * b * h
    nbytes += 2 * 4 * b * h * n_splits * (d + 2)
    return nbytes, 4 * kv_rows * h * d


def ssd_tri(l: int, chunk: int) -> int:
    """(row, earlier row) pairs inside the chunks of an l-row scan, the
    diagonal included: the causal half of each chunk's scores."""
    return sum(min(chunk, l - t0) * (min(chunk, l - t0) + 1) // 2
               for t0 in range(0, l, chunk))


def ssd_scan(bt: int, l: int, h: int, p: int, n: int, esize: int,
             chunk: int, h0: bool = False) -> Tuple[int, int]:
    """(bytes, FLOPs) of a chunked SSD scan of ``bt`` rows of l steps at
    head shape (h, p, n): x read and y written, the fp32 a_log, B and C
    read, the fp32 final state written, and with ``h0`` the fp32 initial
    state read. The FLOPs are the useful ones a chunk and head: the
    causal half of C.B^T (n each) and of the decayed scores times x (p
    each), the carried state's term and the state update (p n each a
    row)."""
    nbytes = (2 * l * h * p * esize + 4 * l * h + 2 * l * n * esize
              + 4 * h * p * n * (2 if h0 else 1))
    flops = h * 2 * (ssd_tri(l, chunk) * (n + p) + 2 * l * p * n)
    return bt * nbytes, bt * flops


def causal_pairs(sq: int, skv: int) -> int:
    """(query, key) pairs of a causal attention whose query i sees keys
    ``<= i + skv - sq``: the sum over a = i + skv - sq + 1 of a clipped
    to [0, skv]."""

    def upto(n: int) -> int:             # sum of clip(a) for a <= n
        if n <= 0:
            return 0
        m = min(n, skv)
        return m * (m + 1) // 2 + (n - m) * skv

    hi = skv
    return upto(hi) - upto(hi - sq)


def flash_attention(b: int, sq: int, skv: int, h: int, kvh: int, d: int,
                    esize: int, causal: bool) -> Tuple[int, int]:
    """(bytes, FLOPs) of full-sequence attention: q read and the output
    written, K and V read; 4 d FLOPs a (query head, key) pair that the
    mask keeps."""
    pairs = causal_pairs(sq, skv) if causal else sq * skv
    nbytes = esize * (2 * b * sq * h * d + 2 * b * skv * kvh * d)
    return nbytes, 4 * b * h * d * pairs
