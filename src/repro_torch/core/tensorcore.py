"""Tensor-core (HMMA.884) dissection — paper §4.3, Figures 4.2–4.7.

A copy of ``repro/core/tensorcore.py``.

The paper discovered, by probing registers at runtime, how ``wmma::mma_sync``
distributes a 16x16x16 half-precision matrix multiplication across the 32
threads of a warp: which threads load which elements of A and B (Figs 4.2,
4.3), how the 4 HMMA instruction *sets* (k-chunks) x 4 *steps* (output
sub-tiles) cover C (Figs 4.4–4.6), and which threads write back each element
of C (Fig 4.7).

We encode the discovered mappings in closed form (derived from the published
address tables), emulate the 16-instruction HMMA sequence at thread-group
granularity, and verify that the emulation reproduces ``A @ B + C`` exactly —
the same consistency check the paper's tables must satisfy.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

M = N = K = 16
GROUPS = 8                    # thread groups of 4 (group_id = thread_id / 4)
SETS = 4                      # HMMA instruction sets: k-chunks of 4
STEPS = 4                     # steps: 2x4 output sub-tiles of a group's block


def a_fragment_threads(row: int, col: int) -> Tuple[int, int]:
    """Fig 4.2: the two threads loading A[row, col] (column-major, fp16)."""
    base = {0: 0, 1: 16, 2: 4, 3: 20}[row // 4]
    t = base + col % 4
    return (t, t + 8)


def b_fragment_threads(row: int, col: int) -> Tuple[int, int]:
    """Fig 4.3: the two threads loading B[row, col] (column-major, fp16)."""
    base = {0: 0, 1: 16, 2: 8, 3: 24}[col // 4]
    t = base + col % 4
    return (t, t + 4)


def c_fragment_thread(row: int, col: int) -> int:
    """Fig 4.7: the thread that stores C[row, col] (column-major, fp32)."""
    rowpat = (0, 1, 0, 1, 16, 17, 16, 17)
    colpat = 8 * (col // 8) + 2 * ((col // 2) % 2)
    return rowpat[row % 8] + 4 * (row // 8) + colpat


def c_group(row: int, col: int) -> int:
    """Fig 4.5: thread group owning C[row, col]."""
    return c_fragment_thread(row, col) // 4


def group_block(group: int) -> Tuple[slice, slice]:
    """The 4x8 block of C computed by one thread group (from Fig 4.5)."""
    rows = {0: 0, 4: 4, 1: 8, 5: 12, 2: 0, 6: 4, 3: 8, 7: 12}[group]
    cols = 0 if group in (0, 4, 1, 5) else 8
    return slice(rows, rows + 4), slice(cols, cols + 8)


def step_subtile(step: int) -> Tuple[slice, slice]:
    """Fig 4.4: the 2x4 sub-tile of a group's 4x8 block per HMMA step."""
    r = slice(0, 2) if step in (0, 2) else slice(2, 4)
    c = slice(0, 4) if step in (0, 1) else slice(4, 8)
    return r, c


def emulate_mma_sync(a: np.ndarray, b: np.ndarray,
                     c: np.ndarray) -> np.ndarray:
    """Emulate the 4-set x 4-step HMMA.884 sequence of Listing 4.1.

    Sets execute in order (set 0 first), each accumulating one k-chunk of 4;
    within a set, the 4 steps fill the group's four 2x4 output sub-tiles.
    """
    assert a.shape == (M, K) and b.shape == (K, N) and c.shape == (M, N)
    out = c.astype(np.float32).copy()
    af = a.astype(np.float32)
    bf = b.astype(np.float32)
    for g in range(GROUPS):
        rs, cs = group_block(g)
        block = out[rs, cs]
        for s in range(SETS):
            kk = slice(4 * s, 4 * s + 4)
            for st in range(STEPS):
                sr, sc = step_subtile(st)
                block[sr, sc] += (af[rs, kk][sr, :]
                                  @ bf[kk, cs][:, sc])
        out[rs, cs] = block
    return out


def fragment_table(matrix: str) -> np.ndarray:
    """Reproduce the paper's address->thread tables (Figs 4.2/4.3/4.7).

    Returns an array of shape (16, 16, 2) of thread indices for A and B
    ((16, 16) for C), indexed [row, col]."""
    if matrix == "A":
        return np.array([[a_fragment_threads(r, c) for c in range(K)]
                         for r in range(M)])
    if matrix == "B":
        return np.array([[b_fragment_threads(r, c) for c in range(N)]
                         for r in range(K)])
    if matrix == "C":
        return np.array([[c_fragment_thread(r, c) for c in range(N)]
                         for r in range(M)])
    raise ValueError(matrix)


def loads_per_thread(matrix: str) -> np.ndarray:
    """Elements of A/B loaded per thread — the paper reports 16 each."""
    table = fragment_table(matrix)
    counts = np.zeros(32, dtype=int)
    for pair in table.reshape(-1, table.shape[-1] if table.ndim == 3 else 1):
        for t in np.atleast_1d(pair):
            counts[int(t)] += 1
    return counts
