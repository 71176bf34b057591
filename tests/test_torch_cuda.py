"""The CUDA kernels of the PyTorch port against their plain versions.

These tests need a CUDA card and ``nvcc`` (the kernels are compiled at
first use); on a machine without a card they skip. On the card:

    python -m pytest tests/test_torch_cuda.py

This file imports neither JAX nor the reference package, so it runs on a
machine that has only PyTorch.
"""

import pytest
import torch

from repro_torch.kernels import ops, ref


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are compiled by nvcc "
                    "and run only there")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 80, 128])
def test_cuda_kernels_match_plain_versions(cuda_device, dtype, d):
    """Each CUDA kernel against its plain version on the card, at the
    main path's head counts (h 32, kvh 8, page 16), within
    ``ref.TOLERANCE`` (summation order; one rounding step in bf16)."""
    g = torch.Generator(device=cuda_device).manual_seed(d)
    b, h, kvh, ps, n_pages, max_pages = 8, 32, 8, 16, 600, 64
    mk = lambda *s: torch.randn(*s, generator=g, device=cuda_device,   # noqa
                                dtype=torch.float32).to(dtype)
    kp, vp = mk(n_pages, ps, kvh, d), mk(n_pages, ps, kvh, d)
    table = torch.stack([torch.randperm(n_pages - 1, generator=g,
                                        device=cuda_device)[:max_pages] + 1
                         for _ in range(b)]).int()
    lengths = torch.tensor([0, 1, 15, 16, 17, 333, 1000, 1024],
                           dtype=torch.int32, device=cuda_device)
    q = mk(b, h, d)
    ops.reset_launches()
    got = ops.flash_decode_paged(q, kp, vp, table, lengths)
    torch.cuda.synchronize()
    want = ref.flash_decode_paged(q, kp, vp, table, lengths)
    assert ref.compare(got, want)[0]
    starts = torch.tensor([0, 5, 64, 300, 900, 1000, 16, 1],
                          dtype=torch.int32, device=cuda_device)
    qc = mk(b, 100, h, d)
    got = ops.flash_attention_paged(qc, kp, vp, table, starts)
    torch.cuda.synchronize()
    want = ref.flash_attention_paged(qc, kp, vp, table, starts)
    assert ref.compare(got, want)[0]
    assert ops.LAUNCHES == {"flash_decode_paged": 1,
                            "flash_attention_paged": 1}
