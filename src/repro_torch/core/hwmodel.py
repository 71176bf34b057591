"""Device parameters: the paper's published cards and the H100.

``VOLTA_INSTR_LATENCY`` and ``PASCAL_INSTR_LATENCY`` are the paper's
Table 4.1 dependent-issue latencies in cycles, as
``repro/core/hwmodel.py`` transcribes them; ``core.latency``'s scoreboard
model recovers them by the paper's control-word method.

``PaperGPUSpec`` is one column of the paper's Table 3.1 with its ch. 4
latency data, and ``V100``, ``P100``, ``P4``, ``M60`` and ``K80`` (in
``GPUS``) are the five columns: the published ground truth that the
device-model dissection (``core.dissect``) must recover from its
simulator (``core.simulator``). It is the reference's ``GPUSpec``, renamed
here because ``GPUSpec`` below is the H100's limits record.

``LinkSpec`` records are the paper's ch. 5 links (Table 5.1, measured,
in ``LINKS``; Table 5.2's host rates in ``HOST_BANDWIDTH_MBS``) and the
H100's NVLink, ``H100_NVLINK4``, which prices the port's collectives
(``core.interconnect``) in place of the reference's TPU ICI record. The
reference's TPU record is not copied.

``H100`` holds the published limits of the card the port runs on, which
the GEMM tile chooser and the serving cost models (``core.autotune``)
price against, and which bound the card's own dissection (``core.card``).

Sizes are in bytes and latencies in cycles.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

KiB = 1024
MiB = 1024 * KiB
GiB = 1024 * MiB

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
class CacheGeometry:
    """Geometry of one cache level, as in paper Table 3.1."""

    size: int                 # capacity in bytes
    line: int                 # line size in bytes
    sets: Optional[int] = None
    ways: Optional[int] = None
    hit_latency: Optional[int] = None   # cycles
    load_granularity: Optional[int] = None
    update_granularity: Optional[int] = None
    policy: str = "lru"       # "lru" | "prio" (Volta's non-LRU) | "random"
    physical_indexed: bool = False

    @property
    def num_lines(self) -> int:
        return self.size // self.line


@dataclasses.dataclass(frozen=True)
class TLBGeometry:
    coverage: int             # bytes covered
    page_entry: int           # bytes per entry
    latency_penalty: int = 0  # extra cycles on miss into next level

    @property
    def entries(self) -> int:
        return self.coverage // self.page_entry


@dataclasses.dataclass(frozen=True)
class RegisterFileSpec:
    banks: int
    bank_width_bits: int
    reuse_slots: int = 4      # register reuse cache slots (paper §2.1)


@dataclasses.dataclass(frozen=True)
class PaperGPUSpec:
    """One column of paper Table 3.1 (+ latency data from ch. 4/5): the
    reference's ``GPUSpec``."""

    name: str
    arch: str
    sms: int                        # "processors per chip (P)"
    max_clock_mhz: float            # f_g
    regfile: RegisterFileSpec
    l1d: CacheGeometry
    l2d: CacheGeometry
    l1c: CacheGeometry              # L1 constant
    l15c: CacheGeometry             # L1.5 constant
    icache_sizes: tuple             # (L0 or L1, L1 or L1.5, L2) bytes
    l1_tlb: TLBGeometry
    l2_tlb: TLBGeometry
    smem_size_per_sm: int
    smem_banks: int
    smem_bank_width: int            # bytes (B_s width w_s)
    smem_no_conflict_latency: int   # cycles
    smem_theoretical_gibs: Optional[float]
    smem_measured_gibs: Optional[float]
    gmem_bus: str
    gmem_size: int
    gmem_clock_mhz: Optional[float]
    gmem_theoretical_gibs: float
    gmem_measured_gibs: float
    l1_bw_bytes_per_cycle: Optional[float] = None   # Table 3.2 measured
    l1_bw_upper_bytes_per_cycle: Optional[float] = None
    l2_bw_gbs: Optional[float] = None               # Table 3.4
    global_latency_l2_miss: Optional[int] = None    # cycles, TLB hit (Fig 3.2)
    global_latency_cold: Optional[int] = None       # cycles, L2+TLB miss
    schedulers_per_sm: int = 4
    fp32_cores_per_sm: int = 64
    # dependent-issue latency table (paper Table 4.1): instr -> cycles
    instr_latency: Optional[dict] = None
    # atomic latency (paper Table 4.2): contention -> (shared, global) cycles
    atomic_latency: Optional[dict] = None


# ----------------------------------------------------------------------------
# Paper Table 3.1, transcribed column by column.
# ----------------------------------------------------------------------------

VOLTA_ATOMIC_LATENCY = {
    # Table 4.2, V100 columns: contention -> (shared, global).
    1: (6, 36), 2: (7, 31), 4: (11, 32), 8: (18, 41), 16: (24, 58),
    32: (66, 76),
}
PASCAL_P100_ATOMIC_LATENCY = {
    1: (15, 26), 2: (17, 31), 4: (19, 48), 8: (30, 48), 16: (46, 50),
    32: (78, 50),
}
MAXWELL_ATOMIC_LATENCY = {
    1: (17, 24), 2: (19, 26), 4: (25, 41), 8: (31, 41), 16: (47, 46),
    32: (79, 46),
}
KEPLER_ATOMIC_LATENCY = {
    1: (93, 29), 2: (214, 69), 4: (460, 96), 8: (952, 152), 16: (1936, 264),
    32: (4257, 488),
}

V100 = PaperGPUSpec(
    name="V100", arch="volta", sms=80, max_clock_mhz=1380.0,
    regfile=RegisterFileSpec(banks=2, bank_width_bits=64),
    l1d=CacheGeometry(size=128 * KiB, line=32, sets=4, hit_latency=28,
                      load_granularity=32, update_granularity=128,
                      policy="prio", physical_indexed=False),
    l2d=CacheGeometry(size=6144 * KiB, line=64, ways=16, hit_latency=193,
                      policy="lru", physical_indexed=True),
    l1c=CacheGeometry(size=2 * KiB, line=64, sets=8, ways=4, hit_latency=27,
                      policy="random"),
    l15c=CacheGeometry(size=64 * KiB, line=256, hit_latency=89),
    icache_sizes=(12 * KiB, 128 * KiB, 6144 * KiB),  # L0 / L1 / L2
    l1_tlb=TLBGeometry(coverage=32 * MiB, page_entry=2 * MiB),
    l2_tlb=TLBGeometry(coverage=8192 * MiB, page_entry=32 * MiB),
    smem_size_per_sm=96 * KiB, smem_banks=32, smem_bank_width=4,
    smem_no_conflict_latency=19,
    smem_theoretical_gibs=13800.0, smem_measured_gibs=12080.0,
    gmem_bus="HBM2", gmem_size=16152 * MiB, gmem_clock_mhz=877.0,
    gmem_theoretical_gibs=900.0, gmem_measured_gibs=750.0,
    l1_bw_bytes_per_cycle=108.3, l1_bw_upper_bytes_per_cycle=256.0,
    l2_bw_gbs=2155.0,
    global_latency_l2_miss=375, global_latency_cold=1029,
    instr_latency=VOLTA_INSTR_LATENCY,
    atomic_latency=VOLTA_ATOMIC_LATENCY,
)

P100 = PaperGPUSpec(
    name="P100", arch="pascal", sms=56, max_clock_mhz=1328.0,
    regfile=RegisterFileSpec(banks=4, bank_width_bits=32),
    l1d=CacheGeometry(size=24 * KiB, line=32, sets=4, hit_latency=82,
                      load_granularity=32, update_granularity=128,
                      policy="lru"),
    l2d=CacheGeometry(size=4096 * KiB, line=32, hit_latency=234, policy="lru",
                      physical_indexed=True),
    l1c=CacheGeometry(size=2 * KiB, line=64, sets=8, ways=4, hit_latency=24,
                      policy="random"),
    l15c=CacheGeometry(size=64 * KiB, line=256, hit_latency=96),
    icache_sizes=(8 * KiB, 128 * KiB, 4096 * KiB),
    l1_tlb=TLBGeometry(coverage=32 * MiB, page_entry=2 * MiB),
    l2_tlb=TLBGeometry(coverage=2048 * MiB, page_entry=32 * MiB),
    smem_size_per_sm=64 * KiB, smem_banks=32, smem_bank_width=4,
    smem_no_conflict_latency=24,
    smem_theoretical_gibs=None, smem_measured_gibs=7763.0,
    gmem_bus="HBM2", gmem_size=16276 * MiB, gmem_clock_mhz=715.0,
    gmem_theoretical_gibs=732.0, gmem_measured_gibs=510.0,
    l1_bw_bytes_per_cycle=31.3, l1_bw_upper_bytes_per_cycle=128.0,
    l2_bw_gbs=1624.0,
    instr_latency=PASCAL_INSTR_LATENCY,
    atomic_latency=PASCAL_P100_ATOMIC_LATENCY,
)

P4 = PaperGPUSpec(
    name="P4", arch="pascal", sms=20, max_clock_mhz=1531.0,
    regfile=RegisterFileSpec(banks=4, bank_width_bits=32),
    l1d=CacheGeometry(size=24 * KiB, line=32, sets=4, hit_latency=82,
                      load_granularity=32, update_granularity=128,
                      policy="lru"),
    l2d=CacheGeometry(size=2048 * KiB, line=32, hit_latency=216, policy="lru",
                      physical_indexed=True),
    l1c=CacheGeometry(size=2 * KiB, line=64, sets=8, ways=4, hit_latency=25,
                      policy="random"),
    l15c=CacheGeometry(size=32 * KiB, line=256, hit_latency=87),
    icache_sizes=(8 * KiB, 32 * KiB, 2048 * KiB),
    l1_tlb=TLBGeometry(coverage=32 * MiB, page_entry=2 * MiB),
    l2_tlb=TLBGeometry(coverage=2048 * MiB, page_entry=32 * MiB),
    smem_size_per_sm=64 * KiB, smem_banks=32, smem_bank_width=4,
    smem_no_conflict_latency=23,
    smem_theoretical_gibs=None, smem_measured_gibs=3555.0,
    gmem_bus="GDDR5", gmem_size=8115 * MiB, gmem_clock_mhz=None,
    gmem_theoretical_gibs=192.0, gmem_measured_gibs=162.0,
    l1_bw_bytes_per_cycle=15.7, l1_bw_upper_bytes_per_cycle=128.0,
    l2_bw_gbs=979.0,
    instr_latency=PASCAL_INSTR_LATENCY,
)

M60 = PaperGPUSpec(
    name="M60", arch="maxwell", sms=16, max_clock_mhz=1177.0,
    regfile=RegisterFileSpec(banks=4, bank_width_bits=32),
    l1d=CacheGeometry(size=24 * KiB, line=32, sets=4, hit_latency=82,
                      load_granularity=32, update_granularity=128,
                      policy="lru"),
    l2d=CacheGeometry(size=2048 * KiB, line=32, hit_latency=207, policy="lru",
                      physical_indexed=True),
    l1c=CacheGeometry(size=2 * KiB, line=64, sets=8, ways=4, hit_latency=25,
                      policy="random"),
    l15c=CacheGeometry(size=32 * KiB, line=256, hit_latency=81),
    icache_sizes=(8 * KiB, 32 * KiB, 2048 * KiB),
    l1_tlb=TLBGeometry(coverage=2 * MiB, page_entry=128 * KiB),
    l2_tlb=TLBGeometry(coverage=128 * MiB, page_entry=2 * MiB),
    smem_size_per_sm=96 * KiB, smem_banks=32, smem_bank_width=4,
    smem_no_conflict_latency=23,
    smem_theoretical_gibs=2410.0, smem_measured_gibs=2122.0,
    gmem_bus="GDDR5", gmem_size=8155 * MiB, gmem_clock_mhz=2505.0,
    gmem_theoretical_gibs=160.0, gmem_measured_gibs=127.0,
    l1_bw_bytes_per_cycle=15.7, l1_bw_upper_bytes_per_cycle=256.0,
    l2_bw_gbs=446.0,
    atomic_latency=MAXWELL_ATOMIC_LATENCY,
)

K80 = PaperGPUSpec(
    name="K80", arch="kepler", sms=13, max_clock_mhz=875.0,
    regfile=RegisterFileSpec(banks=4, bank_width_bits=32),
    l1d=CacheGeometry(size=48 * KiB, line=128, sets=32, hit_latency=35,
                      load_granularity=128, update_granularity=128,
                      policy="prio"),
    l2d=CacheGeometry(size=1536 * KiB, line=32, hit_latency=200, policy="lru",
                      physical_indexed=True),
    l1c=CacheGeometry(size=2 * KiB, line=64, sets=8, ways=4, hit_latency=30,
                      policy="random"),
    l15c=CacheGeometry(size=32 * KiB, line=256, hit_latency=92),
    icache_sizes=(8 * KiB, 32 * KiB, 1536 * KiB),
    l1_tlb=TLBGeometry(coverage=2 * MiB, page_entry=128 * KiB),
    l2_tlb=TLBGeometry(coverage=128 * MiB, page_entry=2 * MiB),
    smem_size_per_sm=48 * KiB, smem_banks=32, smem_bank_width=8,
    smem_no_conflict_latency=26,
    smem_theoretical_gibs=None, smem_measured_gibs=2540.0,
    gmem_bus="GDDR5", gmem_size=12237 * MiB, gmem_clock_mhz=2505.0,
    gmem_theoretical_gibs=240.0, gmem_measured_gibs=191.0,
    l2_bw_gbs=339.0,
    atomic_latency=KEPLER_ATOMIC_LATENCY,
)

GPUS = {g.name: g for g in (V100, P100, P4, M60, K80)}


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
    hbm_bytes: int = 0          # device memory
    smem_per_sm: int = 233_472  # bytes of shared memory the SM's blocks share
    smem_per_cta_reserved: int = 1024  # bytes the system keeps a block
    max_threads_per_sm: int = 2048
    max_ctas_per_sm: int = 32
    schedulers_per_sm: int = 4  # warp schedulers, one instruction a cycle


# NVIDIA's H100 SXM data sheet and the Hopper white paper (compute
# capability 9.0): 227 KB of the SM's 256 KB of shared memory and L1 to one
# block (dynamic, opted in), 228 KB to all of an SM's blocks, 1 KB of it
# kept by the system for each block; 2048 threads and 32 blocks an SM; 80 GB
# of HBM3.
H100 = GPUSpec(name="H100 SXM", sms=132, smem_per_block=232_448,
               regs_per_sm=65_536, l2_bytes=50 * 2**20,
               hbm_bandwidth=3.35e12, peak_bf16_flops=989e12,
               peak_fp32_flops=67e12, hbm_bytes=80 * 10**9)


# ----------------------------------------------------------------------------
# Interconnects (paper ch. 5)
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LinkSpec:
    name: str
    unidir_gbs: float            # GB/s a link, one direction
    latency_us: float
    theoretical_gbs: Optional[float] = None
    links: int = 1               # links of this kind a device has


# Table 5.1: measured peer-to-peer rate and latency, with the theoretical
# rate of one link direction.
PCIE3 = LinkSpec("V100-PCIe", unidir_gbs=10.63, latency_us=7.21,
                 theoretical_gbs=16.0)
NVLINK1 = LinkSpec("P100-NVLink1", unidir_gbs=36.72, latency_us=9.47,
                   theoretical_gbs=40.0)
NVLINK2 = LinkSpec("V100-NVLink2", unidir_gbs=47.99, latency_us=8.55,
                   theoretical_gbs=50.0)
LINKS = {l.name: l for l in (PCIE3, NVLINK1, NVLINK2)}

HOST_BANDWIDTH_MBS = {
    # Table 5.2 (host-to-device, device-to-host) in MB/s.
    "V100-PCIe": (12152.4, 12881.1),
    "P100-NVLink1": (12135.9, 12845.9),
    "V100-NVLink2": (12147.8, 12858.0),
}

# NVIDIA's H100 SXM data sheet: fourth-generation NVLink, 900 GB/s over 18
# links in both directions together, so 25 GB/s a link each way. The data
# sheet gives no latency: the paper's measured V100 NVLink2 latency (Table
# 5.1) stands in for the alpha term until one is measured on the card.
# Not a measurement, so not in ``LINKS``.
H100_NVLINK4 = LinkSpec("H100-NVLink4", unidir_gbs=25.0,
                        latency_us=NVLINK2.latency_us, theoretical_gbs=25.0,
                        links=18)
