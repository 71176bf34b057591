"""Conflict-free register remapping for FFMA accumulation tiles (paper Ch.1).

A copy of ``repro/core/regremap.py``.

This module implements, as an *algorithm*, what the paper did by hand: given
the register slices of an 8x8 (or any m x n) outer-product accumulation tile,
produce an instruction order, accumulator register mapping and reuse-flag
assignment with zero register-bank conflicts and maximal reuse-cache hits.

Strategy (generalizes the paper's hand schedule in Table 1.1, right column):

* Walk B in 64-bit aligned register *pairs* — the two registers of a pair
  live in one bank entry and share one operand-slot reuse cache, so
  alternating them in slot 1 costs a single bank read per pair-group.
* Serpentine over A rows (forward, then backward for the next B pair) so the
  A operand stays in the slot-0 reuse cache across the turn.
* Choose each accumulator C[i][j] from the opposite bank whenever A[i] and
  B[j] share a bank, so even reuse-cache-cold instructions cannot assemble
  three same-bank reads.

The result is validated by the issue-cycle model in ``regbank`` under *both*
reuse-lifetime semantics, and held to the reference's schedule in
``tests/test_torch_paper_models.py``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from repro_torch.core.hwmodel import RegisterFileSpec
from repro_torch.core.regbank import FFMA, bank, instruction_cycles, pair_of


def _b_pair_groups(b_regs: Sequence[int]) -> List[List[int]]:
    """Group B registers into aligned 64-bit pairs where possible."""
    groups: Dict[int, List[int]] = {}
    for r in b_regs:
        groups.setdefault(pair_of(r), []).append(r)
    return [sorted(g) for _, g in sorted(groups.items())]


def assign_accumulators(spec: RegisterFileSpec, a_regs: Sequence[int],
                        b_regs: Sequence[int],
                        c_pool: Sequence[int]) -> Dict[Tuple[int, int], int]:
    """Pick an accumulator register for every (a, b) product such that no
    product has all three registers in one bank."""
    by_bank: Dict[int, List[int]] = {}
    for r in sorted(c_pool, reverse=True):
        by_bank.setdefault(bank(spec, r), []).append(r)
    mapping: Dict[Tuple[int, int], int] = {}
    # Constrained products first (a and b share a bank).
    items = sorted(((a, b) for a in a_regs for b in b_regs),
                   key=lambda ab: bank(spec, ab[0]) != bank(spec, ab[1]))
    for a, b in items:
        if bank(spec, a) == bank(spec, b):
            forbidden = bank(spec, a)
            choices = [bk for bk in by_bank if bk != forbidden and by_bank[bk]]
        else:
            choices = [bk for bk in by_bank if by_bank[bk]]
        if not choices:
            raise ValueError("accumulator pool cannot avoid conflicts")
        # Keep banks balanced so later constrained picks stay feasible.
        bk = max(choices, key=lambda k: len(by_bank[k]))
        mapping[(a, b)] = by_bank[bk].pop()
    return mapping


def remap_tile(spec: RegisterFileSpec, a_regs: Sequence[int],
               b_regs: Sequence[int], c_pool: Sequence[int]) -> List[FFMA]:
    """Produce the optimized FFMA schedule for C[i][j] += A[i] * B[j]."""
    acc = assign_accumulators(spec, a_regs, b_regs, c_pool)
    schedule: List[Tuple[int, int]] = []           # (a, b) issue order
    rows = list(a_regs)
    for gi, group in enumerate(_b_pair_groups(b_regs)):
        row_iter = rows if gi % 2 == 0 else rows[::-1]
        for a in row_iter:
            for b in group:
                schedule.append((a, b))
    instrs: List[FFMA] = []
    for k, (a, b) in enumerate(schedule):
        nxt = schedule[k + 1] if k + 1 < len(schedule) else None
        # Flag an operand for reuse when the next instruction reads the same
        # 64-bit pair in the same slot (valid under both lifetime semantics).
        fa = nxt is not None and pair_of(nxt[0]) == pair_of(a)
        fb = nxt is not None and pair_of(nxt[1]) == pair_of(b)
        c = acc[(a, b)]
        instrs.append(FFMA(c, (a, b, c), (fa, fb, False)))
    return instrs


def conflict_free(spec: RegisterFileSpec, instrs: Sequence[FFMA]) -> bool:
    for mode in ("pair", "next"):
        _, stalls = instruction_cycles(spec, instrs, reuse_mode=mode)
        if stalls:
            return False
    return True
