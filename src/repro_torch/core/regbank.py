"""Register-file bank model and the Ch.1 FFMA case study (Table 1.1).

A copy of ``repro/core/regbank.py``: the same listings, models and numbers.

The paper's headline demonstration: NVCC 9.0's register mapping for an 8x8
FFMA accumulation tile suffers register-bank conflicts that hand-written
machine code avoids, worth +15.4% measured on a V100 (132.05 -> 152.43
GFLOPS/SM at 128 threads).

Model facts (paper §2.1, §3.5):
  * Volta: 2 banks, 64-bit wide; ``bank(r) = r % 2``. An FFMA stalls only if
    all three source reads hit one bank (3 x 32b > 64b/cycle).
  * Pascal/Maxwell: 4 banks, 32-bit wide; ``bank(r) = r % 4``; two reads from
    one bank already stall.
  * 4 operand-slot reuse caches, 8 bytes each: a flagged read caches the full
    64-bit bank entry (the aligned even/odd register *pair*), so later reads
    of either register of the pair in the same slot skip the bank. This
    pair-width is exactly why the paper's hand mapping interleaves
    R80/R81 (one aligned pair) in one slot.

Reuse-lifetime semantics are not fully documented; we support two variants
and report both:
  * ``pair``  — cache persists until a flagged read of a different pair
                replaces it (hardware-plausible given the 8-byte slots).
  * ``next``  — a flag only serves the immediately following instruction.
"""

from __future__ import annotations

import dataclasses
import re
from collections import Counter
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.hwmodel import RegisterFileSpec


@dataclasses.dataclass(frozen=True)
class FFMA:
    dst: int
    srcs: Tuple[int, int, int]          # operand slots 0..2
    reuse: Tuple[bool, bool, bool]

    def __str__(self):
        ops = ", ".join(f"R{r}{'.reuse' if f else ''}"
                        for r, f in zip(self.srcs, self.reuse))
        return f"FFMA R{self.dst}, {ops}, R{self.dst};"


_INSTR_RE = re.compile(
    r"FFMA\s+R(\d+),\s*R(\d+)(\.reuse)?,\s*R(\d+)(\.reuse)?,\s*R(\d+)(\.reuse)?")


def parse_listing(text: str) -> List[FFMA]:
    out = []
    for line in text.strip().splitlines():
        m = _INSTR_RE.search(line)
        if not m:
            continue
        d, a, fa, b, fb, c, fc = m.groups()
        out.append(FFMA(int(d), (int(a), int(b), int(c)),
                        (bool(fa), bool(fb), bool(fc))))
    return out


def bank(spec: RegisterFileSpec, reg: int) -> int:
    return reg % spec.banks


def reads_per_bank_per_cycle(spec: RegisterFileSpec) -> int:
    return spec.bank_width_bits // 32


def pair_of(reg: int) -> int:
    """64-bit-aligned register pair index (R2k,R2k+1 share a bank entry)."""
    return reg // 2


def instruction_cycles(spec: RegisterFileSpec, instrs: Sequence[FFMA],
                       reuse_mode: str = "pair") -> Tuple[int, int]:
    """Issue-cycle model for an FFMA stream.

    Returns (total_cycles, conflict_stalls). Each instruction takes 1 issue
    cycle plus ``ceil(reads_on_worst_bank / bank_width) - 1`` stall cycles.
    """
    assert reuse_mode in ("pair", "next")
    per_cycle = reads_per_bank_per_cycle(spec)
    cache: List[Optional[int]] = [None] * 4     # per-slot cached pair (or reg)
    stalls = 0
    for ins in instrs:
        next_cache = list(cache) if reuse_mode == "pair" else [None] * 4
        reads = []
        for slot, (reg, flag) in enumerate(zip(ins.srcs, ins.reuse)):
            key = pair_of(reg) if reuse_mode == "pair" else reg
            if cache[slot] is not None and cache[slot] == key:
                hit = True
            else:
                hit = False
                reads.append(reg)
            if flag:
                next_cache[slot] = key
            elif reuse_mode == "next":
                next_cache[slot] = None
        cache = next_cache
        per_bank = Counter(bank(spec, r) for r in reads)
        if per_bank:
            worst = max(per_bank.values())
            stalls += max(0, -(-worst // per_cycle) - 1)
    return len(instrs) + stalls, stalls


def gflops_per_sm(spec: RegisterFileSpec, instrs: Sequence[FFMA],
                  clock_mhz: float, warps: int = 4,
                  issue_rate: float = 0.4316,
                  reuse_mode: str = "next") -> float:
    """Modeled FFMA throughput for ``warps`` warps, one per processing block.

    ``issue_rate`` is the per-warp sustained issue rate calibrated so the
    conflict-free Table 1.1 kernel reproduces the paper's measured 152.43
    GFLOPS/SM (0.4316 instr/cycle/warp at 1380 MHz); conflict stalls then
    *predict* the NVCC kernel's throughput (paper measured 132.05; the
    prediction error is reported by ``launch/dissect.py``).
    """
    cycles, _ = instruction_cycles(spec, instrs, reuse_mode)
    eff = issue_rate * len(instrs) / cycles
    flops_per_instr = 32 * 2                    # 32 lanes x FMA
    return warps * eff * flops_per_instr * clock_mhz * 1e6 / 1e9


# ----------------------------------------------------------------------------
# Fig 3.8 probe: discover bank structure by sweeping one source register.
# ----------------------------------------------------------------------------

def ffma_probe(spec: RegisterFileSpec, srcs: Tuple[int, ...]) -> int:
    """Elapsed cycles of one probe instruction reading ``srcs`` (no reuse
    flags) — the measurement primitive of Fig 3.8. Two-source probes model
    FADD-like instructions, three-source probes model FFMA."""
    per_cycle = reads_per_bank_per_cycle(spec)
    per_bank = Counter(bank(spec, r) for r in srcs)
    worst = max(per_bank.values())
    return 1 + max(0, -(-worst // per_cycle) - 1)


def conflict_sweep(probe3, fixed: Tuple[int, int],
                   rx_range: Sequence[int]) -> List[int]:
    """Fig 3.8: elapsed cycles of ``FFMA R6, R<fixed0>, R<fixed1>, RX``
    while sweeping RX."""
    return [probe3((fixed[0], fixed[1], rx)) for rx in rx_range]


def dissect_register_banks(probe2, probe3) -> Tuple[int, int]:
    """Infer (banks, bank_width_bits) purely from conflict timings.

    ``probe2((a, b)) -> cycles`` times a two-source instruction (FADD-like);
    ``probe3((a, b, c)) -> cycles`` a three-source one (FFMA), as in Fig 3.8.

    32-bit banks: two same-bank reads already stall, so the smallest operand
    spacing ``d`` with ``probe2((r, r+d))`` elevated is the bank count.
    64-bit banks: no two-read probe ever stalls; three same-bank reads do,
    so the smallest ``d`` with ``probe3((r, r+d, r+2d))`` elevated is the
    bank count.
    """
    base2 = probe2((96, 97))
    for d in (1, 2, 4, 8, 16):
        if probe2((96, 96 + d)) > base2:
            return d, 32
    # No 2-read conflict -> banks are (at least) 64-bit wide.
    base3 = probe3((96, 97, 99))
    for d in (1, 2, 4, 8, 16):
        if probe3((96, 96 + d, 96 + 2 * d)) > base3:
            return d, 64
    return 1, 128


def _pattern_period(pattern: Sequence[int]) -> int:
    n = len(pattern)
    for p in range(1, n // 2 + 1):
        if all(pattern[i] == pattern[i % p] for i in range(n)):
            if any(pattern[:p]):
                return p
    return 0


# ----------------------------------------------------------------------------
# Table 1.1 listings (transcribed; OCR artifacts in the source normalized).
# ----------------------------------------------------------------------------

NVCC_LISTING = """
FFMA R16, R12, R80, R16;
FFMA R17, R80.reuse, R13, R17;
FFMA R18, R80.reuse, R14, R18;
FFMA R19, R80, R15, R19;
FFMA R20, R80.reuse, R8, R20;
FFMA R21, R80.reuse, R9, R21;
FFMA R22, R80.reuse, R10, R22;
FFMA R23, R80, R11, R23;
FFMA R24, R12, R81.reuse, R24;
FFMA R25, R13, R81, R25;
FFMA R26, R14, R81.reuse, R26;
FFMA R27, R15, R81.reuse, R27;
FFMA R28, R8, R81.reuse, R28;
FFMA R29, R9, R81.reuse, R29;
FFMA R30, R10, R81.reuse, R30;
FFMA R31, R11, R81, R31;
FFMA R32, R12, R82.reuse, R32;
FFMA R33, R13, R82.reuse, R33;
FFMA R34, R14, R82.reuse, R34;
FFMA R35, R15, R82.reuse, R35;
FFMA R36, R8, R82.reuse, R36;
FFMA R37, R9, R82, R37;
FFMA R38, R10, R82.reuse, R38;
FFMA R39, R11, R82, R39;
FFMA R40, R12, R83.reuse, R40;
FFMA R41, R13, R83.reuse, R41;
FFMA R42, R14, R83.reuse, R42;
FFMA R43, R15, R83, R43;
FFMA R44, R8, R83.reuse, R44;
FFMA R45, R9, R83.reuse, R45;
FFMA R46, R10, R83.reuse, R46;
FFMA R47, R11, R83, R47;
FFMA R48, R12, R4.reuse, R48;
FFMA R49, R13, R4, R49;
FFMA R50, R14, R4.reuse, R50;
FFMA R51, R15, R4.reuse, R51;
FFMA R52, R8, R4.reuse, R52;
FFMA R53, R9, R4.reuse, R53;
FFMA R54, R10, R4.reuse, R54;
FFMA R55, R11, R4, R55;
FFMA R56, R12, R5.reuse, R56;
FFMA R57, R13, R5.reuse, R57;
FFMA R58, R14, R5.reuse, R58;
FFMA R59, R15, R5.reuse, R59;
FFMA R60, R8, R5.reuse, R60;
FFMA R61, R9, R5, R61;
FFMA R62, R10, R5.reuse, R62;
FFMA R63, R11, R5, R63;
FFMA R64, R12, R6.reuse, R64;
FFMA R65, R13, R6.reuse, R65;
FFMA R66, R14, R6.reuse, R66;
FFMA R67, R15, R6, R67;
FFMA R68, R8, R6.reuse, R68;
FFMA R69, R9, R6.reuse, R69;
FFMA R70, R10, R6.reuse, R70;
FFMA R71, R11, R6, R71;
FFMA R72, R12, R7.reuse, R72;
FFMA R73, R13, R7, R73;
FFMA R74, R14, R7.reuse, R74;
FFMA R75, R15, R7.reuse, R75;
FFMA R76, R8, R7.reuse, R76;
FFMA R77, R9, R7.reuse, R77;
FFMA R78, R10, R7.reuse, R78;
FFMA R79, R11, R7, R79;
"""

IMPROVED_LISTING = """
FFMA R17, R12.reuse, R80.reuse, R17;
FFMA R16, R12, R81.reuse, R16;
FFMA R25, R13.reuse, R80.reuse, R25;
FFMA R24, R13, R81.reuse, R24;
FFMA R33, R14.reuse, R80.reuse, R33;
FFMA R32, R14, R81.reuse, R32;
FFMA R41, R15.reuse, R80.reuse, R41;
FFMA R40, R15, R81.reuse, R40;
FFMA R49, R8.reuse, R80.reuse, R49;
FFMA R48, R8, R81.reuse, R48;
FFMA R57, R9.reuse, R80.reuse, R57;
FFMA R56, R9, R81.reuse, R56;
FFMA R65, R10.reuse, R80.reuse, R65;
FFMA R64, R10.reuse, R81.reuse, R64;
FFMA R73, R11.reuse, R80, R73;
FFMA R72, R11.reuse, R81, R72;
FFMA R75, R11.reuse, R82.reuse, R75;
FFMA R74, R11, R83.reuse, R74;
FFMA R67, R10.reuse, R82.reuse, R67;
FFMA R66, R10, R83.reuse, R66;
FFMA R59, R9.reuse, R82.reuse, R59;
FFMA R58, R9, R83.reuse, R58;
FFMA R51, R8.reuse, R82.reuse, R51;
FFMA R50, R8, R83.reuse, R50;
FFMA R43, R15.reuse, R82.reuse, R43;
FFMA R42, R15, R83.reuse, R42;
FFMA R35, R14.reuse, R82.reuse, R35;
FFMA R34, R14, R83.reuse, R34;
FFMA R27, R13.reuse, R82.reuse, R27;
FFMA R26, R13.reuse, R83.reuse, R26;
FFMA R19, R12.reuse, R82, R19;
FFMA R18, R12.reuse, R83, R18;
FFMA R21, R12.reuse, R4.reuse, R21;
FFMA R20, R12, R5.reuse, R20;
FFMA R29, R13.reuse, R4.reuse, R29;
FFMA R28, R13, R5.reuse, R28;
FFMA R37, R14.reuse, R4.reuse, R37;
FFMA R36, R14, R5.reuse, R36;
FFMA R45, R15.reuse, R4.reuse, R45;
FFMA R44, R15, R5.reuse, R44;
FFMA R53, R8.reuse, R4.reuse, R53;
FFMA R52, R8, R5.reuse, R52;
FFMA R61, R9.reuse, R4.reuse, R61;
FFMA R60, R9, R5.reuse, R60;
FFMA R69, R10.reuse, R4.reuse, R69;
FFMA R68, R10.reuse, R5.reuse, R68;
FFMA R77, R11.reuse, R4, R77;
FFMA R76, R11.reuse, R5, R76;
FFMA R79, R11.reuse, R6.reuse, R79;
FFMA R78, R11, R7.reuse, R78;
FFMA R71, R10.reuse, R6.reuse, R71;
FFMA R70, R10, R7.reuse, R70;
FFMA R63, R9.reuse, R6.reuse, R63;
FFMA R62, R9, R7.reuse, R62;
FFMA R55, R8.reuse, R6.reuse, R55;
FFMA R54, R8, R7.reuse, R54;
FFMA R47, R15.reuse, R6.reuse, R47;
FFMA R46, R15, R7.reuse, R46;
FFMA R39, R14.reuse, R6.reuse, R39;
FFMA R38, R14, R7.reuse, R38;
FFMA R31, R13.reuse, R6.reuse, R31;
FFMA R30, R13.reuse, R7.reuse, R30;
FFMA R23, R12.reuse, R6, R23;
FFMA R22, R12.reuse, R7, R22;
"""

A_REGS = (12, 13, 14, 15, 8, 9, 10, 11)     # row slice of matrix A
B_REGS = (80, 81, 82, 83, 4, 5, 6, 7)       # column slice of matrix B

PAPER_GFLOPS_NVCC = 132.05
PAPER_GFLOPS_IMPROVED = 152.43


def tile_coverage(instrs: Sequence[FFMA]) -> bool:
    """Check an FFMA stream computes every (a, b) product of the 8x8 tile
    exactly once, with a consistent accumulator per product."""
    seen = {}
    for ins in instrs:
        operands = set(ins.srcs) - {ins.dst}
        a = operands & set(A_REGS)
        b = operands & set(B_REGS)
        if len(a) != 1 or len(b) != 1:
            return False
        key = (a.pop(), b.pop())
        if key in seen:
            return False
        seen[key] = ins.dst
    return len(seen) == 64 and len(set(seen.values())) == 64
