"""Device operations by kernel family: a frozen copy of
``repro_torch/launch/profile.py``'s ``FAMILIES``. The first entry whose
name fragments all occur in a kernel's (demangled) name wins. The port's
kernels sit in an anonymous namespace, as no library's do, and are told
apart by the layout they are instantiated for; each family is named for
the TPU kernel it replaces."""

from __future__ import annotations

PORT = "(anonymous namespace)::"
FAMILIES = (((PORT + "decode_split_kernel<", "PagedLayout"),
             "flash_decode_paged"),
            ((PORT + "decode_split_kernel<", "ContiguousLayout"),
             "flash_decode"),
            ((PORT + "prefill_kernel<", "PagedLayout"),
             "flash_attention_paged"),
            ((PORT + "prefill_mma_kernel<", "PagedLayout"),
             "flash_attention_paged"),
            ((PORT + "prefill_kernel<", "ContiguousLayout"),
             "flash_attention"),
            ((PORT + "prefill_mma_kernel<", "ContiguousLayout"),
             "flash_attention"),
            ((PORT + "ssd_scan_kernel<",), "ssd_scan"),
            ((PORT + "ssd_scan_mma_kernel<",), "ssd_scan"),
            ((PORT + "gemm_kernel<",), "gemm"),
            ((PORT + "gemm_wgmma_kernel<",), "gemm"),
            ((PORT + "pchase_kernel(",), "pchase"),
            ((PORT + "pchase_timed_kernel<",), "pchase_timed"),
            (("gemm",), "GEMM (cuBLAS)"), (("nvjet",), "GEMM (cuBLAS)"),
            (("xmma",), "GEMM (cuBLAS)"), (("cutlass",), "GEMM (cuBLAS)"),
            (("reduce",), "reductions"), (("index",), "indexing and scatter"),
            (("elementwise",), "elementwise"), (("copy",), "copies and casts"))


def family(name: str) -> str:
    """The family of a kernel's name, "other" where none matches."""
    low = name.lower()
    return next((f for keys, f in FAMILIES
                 if all(k.lower() in low for k in keys)), "other")
