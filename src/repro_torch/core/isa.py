"""Instruction encoding facts — paper ch. 2 + appendix.

A copy of ``repro/core/isa.py``: the discovered encoding as
machine-readable data plus faithful encode/decode of the *control
information*, which is the part the paper actually uses operationally
(stall counts, barriers, reuse flags drive the Ch.1 optimization and the
§4.1 latency measurements).

Control section layout (all of Volta/Pascal/Maxwell, paper §2.1):

    | width (bits) | 4     | 6         | 3        | 3         | 1     | 4     |
    | meaning      | reuse | wait mask | read bar | write bar | yield | stall |

Volta packs one 21-bit section per 128-bit instruction word; Pascal/Maxwell
pack 3 sections in a 64-bit control word (1 zero MSB); Kepler packs 7 8-bit
sections (6 zero MSBs + 2 zero LSBs).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

# Field widths, LSB-first: stall(4), yield(1), write_bar(3), read_bar(3),
# wait_mask(6), reuse(4) = 21 bits.
_FIELDS = (("stall", 4), ("yield_flag", 1), ("write_bar", 3),
           ("read_bar", 3), ("wait_mask", 6), ("reuse", 4))
SECTION_BITS = 21


@dataclasses.dataclass(frozen=True)
class ControlInfo:
    stall: int = 0
    yield_flag: int = 0
    write_bar: int = 7          # 7 = none
    read_bar: int = 7
    wait_mask: int = 0
    reuse: int = 0

    def encode(self) -> int:
        word = 0
        shift = 0
        for name, width in _FIELDS:
            val = getattr(self, name)
            assert 0 <= val < (1 << width), (name, val)
            word |= val << shift
            shift += width
        return word


def decode_control(word: int) -> ControlInfo:
    vals = {}
    shift = 0
    for name, width in _FIELDS:
        vals[name] = (word >> shift) & ((1 << width) - 1)
        shift += width
    return ControlInfo(**vals)


def pack_volta(instr_bits: int, ctrl: ControlInfo,
               ctrl_offset: int = 105) -> int:
    """One 128-bit Volta word: >=91 instruction bits, 21+2 control bits.

    The paper reports control information is "preceded and followed by
    instruction encoding bits"; we place the section at a fixed offset, with
    the 2 zero guard bits above it."""
    assert instr_bits < (1 << 105)
    return instr_bits | (ctrl.encode() << ctrl_offset)


def unpack_volta(word: int, ctrl_offset: int = 105
                 ) -> Tuple[int, ControlInfo]:
    mask = (1 << SECTION_BITS) - 1
    ctrl = decode_control((word >> ctrl_offset) & mask)
    instr = word & ~(mask << ctrl_offset)
    return instr, ctrl


def pack_pascal_control_word(sections: List[ControlInfo]) -> int:
    """Pascal/Maxwell: 3 x 21-bit sections in one 64-bit word, MSB zero."""
    assert len(sections) == 3
    word = 0
    for i, s in enumerate(sections):
        word |= s.encode() << (i * SECTION_BITS)
    return word


def unpack_pascal_control_word(word: int) -> List[ControlInfo]:
    mask = (1 << SECTION_BITS) - 1
    return [decode_control((word >> (i * SECTION_BITS)) & mask)
            for i in range(3)]


# ----------------------------------------------------------------------------
# Opcode tables (appendix; representative, cleanly transcribed subset).
# Volta opcodes sit in the LSBs of the first 64-bit half and are 10-13 bits.
# ----------------------------------------------------------------------------

VOLTA_OPCODES: Dict[str, str] = {
    # floating point
    "FADD": "010 0010 0001", "FCHK": "011 0000 0010", "FFMA": "010 0010 0011",
    "FMNMX": "010 0000 1001", "FMUL": "010 0010 0000", "FSET": "010 0000 1010",
    "FSETP": "010 0000 1011", "FSWZADD": "0 1000 0010 0010",
    "MUFU": "011 0000 1000", "DADD": "010 0010 1001", "DFMA": "010 0010 1011",
    "DMUL": "010 0010 1000", "DSETP": "010 0010 1010",
    "HADD2": "010 0011 0000", "HFMA2": "010 0011 0001",
    "HMMA2": "0 0010 0011 0110", "HMUL2": "010 0011 0010",
    "HSETP2": "010 0011 0100", "HSET2": "010 0011 0011",
    "FSEL": "010 0000 1000",
    # integer
    "FLO": "011 0000 0000", "IADD3": "010 0001 0000",
    "IMAD": "010 0010 0100", "ISETP": "010 0000 1100",
    "LEA": "010 0001 0001", "LOP3": "010 0001 0010", "POPC": "011 0000 1001",
    "SHF": "010 0001 1001", "VABSDIFF": "010 0001 0100",
    "VABSDIFF4": "010 0001 0101", "BREV": "011 0000 0001",
    "IABS": "010 0001 0011", "IDP": "010 0010 0110",
    "QSPC": "0 0011 1010 1010", "BMSK": "010 0001 1011",
    # conversion / movement
    "MOV": "010 0000 0010", "PRMT": "010 0001 0110", "SEL": "010 0000 0111",
    "SHFL": "0 1001 1000 1001", "P2R": "010 0000 0011",
    "R2P": "010 0000 0100", "GETLMEMBASE": "0 0011 1100 0000",
    # load/store
    "LD": "0 1001 1000 0000", "LDC": "0 1011 1000 0010",
    "LDG": "0 0011 1000 0001", "LDL": "0 1001 1000 0011",
    "LDS": "0 1001 1000 0100", "ST": "0 0011 1000 0101",
    "STG": "0 0011 1000 0110", "STL": "0 0011 1000 0111",
    "STS": "0 0011 1000 1000", "ATOM": "0 0011 1000 1010",
    "ATOMS": "0 0011 1000 1100", "ATOMG": "0 0011 1010 1000",
    "RED": "0 1001 1000 1110", "CCTL": "0 1001 1000 1111",
    "MEMBAR": "0 1001 1001 0010", "ERRBAR": "0 1001 1010 1011",
    "CCTLL": "0 1001 1001 0000", "MATCH": "0 0011 1010 0001",
    # control
    "BRA": "0 1001 0100 0111", "BRX": "0 1001 0100 1001",
    "JMP": "0 1001 0100 1010", "JMX": "0 1001 0100 1100",
    "BSYNC": "0 1001 0100 0001", "WARPSYNC": "011 0100 1000",
    "CALL": "011 0100 0011", "RET": "0 1001 0101 0000",
    "EXIT": "0 1001 0100 1101", "BMOV": "0 0011 0101 0101",
    "YIELD": "0 1001 0100 0110", "RTT": "0 1001 0100 1111",
    "KILL": "0 1001 0101 1011", "IDE": "0 1001 0101 0001",
    "PMTRIG": "0 1000 0000 0001", "BREAK": "0 1001 0100 0010",
    "BSSY": "0 1001 0100 0101",
    # other
    "NOP": "0 1001 0001 1000", "CS2R": "0 1000 0000 0101",
    "S2R": "0 1001 0001 1001", "B2R": "0 0011 0001 1100",
    "BAR": "011 0001 1101", "R2B": "0 0011 0001 1110",
    "VOTE": "0 1000 0000 0110", "TMML": "0 1011 0110 1001",
    "TXD": "0 1011 0110 1100", "SGXT": "010 0001 1010",
}


def opcode_bits(name: str) -> int:
    return len(VOLTA_OPCODES[name].replace(" ", ""))


def opcode_length_histogram() -> Dict[int, int]:
    """Paper §2.3: Volta opcodes vary from 10 to 13 bits."""
    hist: Dict[int, int] = {}
    for name in VOLTA_OPCODES:
        hist[opcode_bits(name)] = hist.get(opcode_bits(name), 0) + 1
    return hist


ENCODING_FACTS = {
    "word_bits": 128,
    "min_instruction_bits": 91,
    "min_control_bits": 23,     # 21-bit section + 2 guard zeros
    "unused_bits": 14,
    "opcode_bits_range": (10, 13),
    "opcode_position": "least-significant bits of the first 64-bit half",
}
