"""Device parameters: the paper's published latency tables and the H100.

``VOLTA_INSTR_LATENCY`` and ``PASCAL_INSTR_LATENCY`` are the paper's
Table 4.1 dependent-issue latencies in cycles, as
``repro/core/hwmodel.py`` transcribes them; ``core.latency``'s scoreboard
model recovers them by the paper's control-word method. ``H100`` holds the
published limits of the card the port runs on, which the GEMM tile
chooser and the serving cost models (``core.autotune``) price against.
"""

from __future__ import annotations

import dataclasses

VOLTA_INSTR_LATENCY = {
    # Table 4.1, Volta rows.
    "IADD3": 4, "SHF": 4, "LOP3": 4, "SEL": 4, "MOV": 4, "FADD": 4,
    "FFMA": 4, "FMUL": 4, "ISETP": 4, "FSET": 4, "FSETP": 4,
    "IMAD": 5, "FMNMX": 5, "DSET": 5, "DSETP": 5,
    "HADD2": 6, "HMUL2": 6, "HFMA2": 6,
    "DADD": 8, "DMUL": 8, "DFMA": 8,
    "POPC": 10,
    "FLO": 14, "BREV": 14, "MUFU": 14,
}

PASCAL_INSTR_LATENCY = {
    # Table 4.1, Pascal rows.
    "BFE": 6, "BFI": 6, "IADD": 6, "IADD32I": 6, "FADD": 6, "FMUL": 6,
    "FFMA": 6, "FMNMX": 6, "HADD2": 6, "HMUL2": 6, "HFMA2": 6, "IMNMX": 6,
    "ISCADD": 6, "LOP": 6, "LOP32I": 6, "LOP3": 6, "MOV": 6, "MOV32I": 6,
    "SEL": 6, "SHL": 6, "SHR": 6, "VADD": 6, "VABSDIFF": 6, "VMNMX": 6,
    "XMAD": 6,
    "DADD": 8, "DMUL": 8, "DFMA": 8, "DMNMX": 8,
    "FSET": 12, "DSET": 12, "DSETP": 12, "ISETP": 12, "FSETP": 12,
    "POPC": 14, "FLO": 14, "MUFU": 14, "F2F": 14, "F2I": 14, "I2F": 14,
    "I2I": 14,
    "IMUL": 86, "IMAD": 86,
}


@dataclasses.dataclass(frozen=True)
class GPUSpec:
    name: str
    sms: int
    smem_per_block: int         # bytes of shared memory one block may use
    regs_per_sm: int            # 32-bit registers
    l2_bytes: int
    hbm_bandwidth: float        # bytes/s
    peak_bf16_flops: float      # tensor cores, dense
    peak_fp32_flops: float      # CUDA cores (FFMA)
    smem_per_sm: int = 233_472  # bytes of shared memory the SM's blocks share
    smem_per_cta_reserved: int = 1024  # bytes the system keeps a block
    max_threads_per_sm: int = 2048
    max_ctas_per_sm: int = 32
    schedulers_per_sm: int = 4  # warp schedulers, one instruction a cycle


# NVIDIA's H100 SXM data sheet and the Hopper white paper (compute
# capability 9.0): 227 KB of the SM's 256 KB of shared memory and L1 to one
# block (dynamic, opted in), 228 KB to all of an SM's blocks, 1 KB of it
# kept by the system for each block; 2048 threads and 32 blocks an SM.
H100 = GPUSpec(name="H100 SXM", sms=132, smem_per_block=232_448,
               regs_per_sm=65_536, l2_bytes=50 * 2**20,
               hbm_bandwidth=3.35e12, peak_bf16_flops=989e12,
               peak_fp32_flops=67e12)
