"""The engine steps' graph bookkeeping (``repro_torch.serve.graphs``) on
the CPU: the port's kernel names map to the ``ops.LAUNCHES`` key of the
wrapper that launches each, and a step on the CPU runs its function on
every call. Capturing and reading a graph's nodes needs a card
(``tests/test_torch_cuda.py``)."""

import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.serve import graphs

# Kernel node names read back from graphs captured around each wrapper on
# an H100 (nvcc 12.9; the anonymous namespace carries the file's hash).
PA = "_ZN51_GLOBAL__N__caccf2de_18_paged_attention_cu_fed0b86b"
NAMES = [
    (PA + "19decode_split_kernelIfLi64ELi8ENS_11PagedLayoutEEEvPKT_S4_S4_T2_"
     "PKiPfPiPS2_iiif", "flash_decode_paged"),
    (PA + "19decode_split_kernelI13__nv_bfloat16Li64ELi16ENS_11PagedLayoutE"
     "EEvPKT_S5_S5_T2_PKiPfPiPS3_iiif", "flash_decode_paged"),
    (PA + "19decode_split_kernelIfLi64ELi8ENS_16ContiguousLayoutEEEvPKT_S4_"
     "S4_T2_PKiPfPiPS2_iiif", "flash_decode"),
    (PA + "19decode_split_kernelI13__nv_bfloat16Li64ELi16ENS_16ContiguousLa"
     "youtEEEvPKT_S5_S5_T2_PKiPfPiPS3_iiif", "flash_decode"),
    (PA + "14prefill_kernelIfLi64ENS_11PagedLayoutEEEvPKT_S4_S4_T1_PKiibPS2_"
     "iiif", "flash_attention_paged"),
    (PA + "18prefill_mma_kernelILi64ENS_11PagedLayoutEEEvPK13__nv_bfloat16S4"
     "_S4_T0_PKiibPS2_iiif", "flash_attention_paged"),
    (PA + "14prefill_kernelIfLi64ENS_16ContiguousLayoutEEEvPKT_S4_S4_T1_PKii"
     "bPS2_iiif", "flash_attention"),
    (PA + "18prefill_mma_kernelILi64ENS_16ContiguousLayoutEEEvPK13__nv_bfloa"
     "t16S4_S4_T0_PKiibPS2_iiif", "flash_attention"),
    ("_ZN44_GLOBAL__N__70402df9_11_ssd_scan_cu_ssd_scan15ssd_scan_kernelILi"
     "64ELi128EEEvPKfS2_S2_S2_S2_PfS3_Piii", "ssd_scan"),
    ("_ZN44_GLOBAL__N__70402df9_11_ssd_scan_cu_ssd_scan19ssd_scan_mma_kerne"
     "lILi64ELi128EEEvPK13__nv_bfloat16PKfS3_S3_S5_PS1_PfPiii", "ssd_scan"),
    ("_ZN39_GLOBAL__N__a5ceb14d_7_gemm_cu_d6e4d61c11gemm_kernelIfLi64ELi64E"
     "Lb1EEEvPKT_S3_PS1_iii", "gemm"),
    ("_ZN39_GLOBAL__N__a5ceb14d_7_gemm_cu_d6e4d61c17gemm_wgmma_kernelILi128"
     "ELb1EEEv14CUtensorMap_stS1_PK13__nv_bfloat16S4_PS2_iii", "gemm"),
    ("_ZN39_GLOBAL__N__78e2e4a0_9_pchase_cu_pchase13pchase_kernelEPKiPii",
     "pchase"),
    ("_ZN39_GLOBAL__N__78e2e4a0_9_pchase_cu_pchase19pchase_timed_kernelILb1"
     "EEEvPKxxxxiPxPjS3_S3_Pi", "pchase_timed"),
    # Library and PyTorch kernels: none of the port's.
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", None),
    ("nvjet_tst_128x64_64x8_2x1_v_bz_coopB_TNT", None),
    ("_ZN2at6native29vectorized_elementwise_kernelILi4ENS0_11FillFunctorIfE"
     "ESt5arrayIPcLm1EEEEviT0_T1_", None),
    ("_ZN2at6native12_GLOBAL__N_125multi_tensor_apply_kernelINS1_18TensorLi"
     "stMetadataILi2EEENS1_14UnaryOpFunctorIfLi2ELi1ELi1EEEJNS0_4CopyIffEEEE"
     "EvT_T0_DpT1_", None),
]


@pytest.mark.parametrize("name,wrapper", NAMES,
                         ids=[w or f"library{i}"
                              for i, (_, w) in enumerate(NAMES)])
def test_kernel_names_map_to_their_wrappers(name, wrapper):
    assert graphs.wrapper_of(name) == wrapper


def test_count_wrappers_counts_only_the_ports_kernels():
    names = [n for n, _ in NAMES] + [NAMES[0][0]] * 35
    want = {"flash_decode_paged": 37, "flash_decode": 2,
            "flash_attention_paged": 2, "flash_attention": 2,
            "ssd_scan": 2, "gemm": 2, "pchase": 1, "pchase_timed": 1}
    assert graphs.count_wrappers(names) == want
    assert set(want) == set(ops.LAUNCHES)


def test_step_on_the_cpu_runs_its_function_every_call():
    calls = []
    out = torch.zeros(())
    step = graphs.Step(lambda: (calls.append(1), out.add_(1)),
                       torch.device("cpu"), capture=True)
    assert step.graph is None and calls == []
    assert step.launches == step.nodes == {} and step.graph_bytes == 0
    step()
    step()
    assert len(calls) == 2 and float(out) == 2.0
