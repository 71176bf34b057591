"""The SSD scan of the PyTorch port on the CPU: the host side of the CUDA
kernel (its grid and the hand-off's ints, sized from shapes alone; the
launch arguments) and the plain ``ops.ssd_scan`` at the kernel's own head
shape, (p, n) = (64, 128) and chunk 128, against the reference's Pallas
kernel in interpret mode.

Tolerance: 2e-4 absolute plus relative, as in ``test_torch_kernels.py``:
the two sides sum the same fp32 chunked scan in another order. The CUDA
kernel itself is held against the plain version in
``test_torch_cuda.py``, on a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ssd_scan as jssd

from repro_torch.kernels import _build, ops
from repro_torch.kernels import flash_decode as _decode
from repro_torch.kernels import ssd_scan as _ssd

SSD_TOL = 2e-4


@pytest.mark.parametrize("bt,l,h,p,grid,ints", [
    (1, 1024, 32, 64, (64, 8, 1), 128),     # the engine's prefill
    (1, 1, 32, 64, (64, 1, 1), 128),        # one row: one chunk
    (1, 128, 32, 64, (64, 1, 1), 128),      # one full chunk
    (1, 129, 32, 64, (64, 2, 1), 128),      # one row into the next
    (1, 1536, 32, 64, (64, 12, 1), 128),    # the longest prompt
    (2, 300, 4, 64, (8, 3, 2), 32),
])
def test_grid_and_sync_ints_are_sized_from_shapes(bt, l, h, p, grid, ints):
    """One CTA per (head x p-block of 32, chunk of 128, batch row); a
    ticket and a count per (batch row, head, p-block)."""
    assert _ssd.grid(bt, l, h, p, _ssd.DEFAULT_CHUNK) == grid
    assert _ssd.sync_ints(bt, h, p) == ints


def test_grid_limit_on_y_and_z():
    """Chunks go on the grid's y and batch rows on its z, each at most
    65535: the wrapper raises before a launch CUDA would refuse."""
    chunk = _ssd.DEFAULT_CHUNK
    _ssd.check_grid(65535, 65535 * chunk, 32, 64, chunk)
    with pytest.raises(ValueError, match="65535"):
        _ssd.check_grid(1, 65535 * chunk + 1, 32, 64, chunk)
    with pytest.raises(ValueError, match="65535"):
        _ssd.check_grid(65536, 128, 32, 64, chunk)


class _FakeLib:
    """Records the arguments of each C entry point instead of launching."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        def call(*args):
            assert len(args) == len(_build.SIGNATURES[name]), name
            self.calls[name] = args
            return 0
        return call


def test_launch_passes_the_shapes_and_zeroed_ints(monkeypatch):
    """The wrapper hands the kernel (dtype, p, n, chunk, pointers, sync,
    bt, l, h, stream), with at least ``sync_ints`` zeroed ints from the
    buffer the decodes share per (device, stream)."""
    lib = _FakeLib()
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 5}))
    monkeypatch.setattr(_decode, "_COUNTERS", {})
    bt, l, h, p, n = 2, 300, 4, 64, 128
    x = torch.zeros(bt, l, h, p)
    a = torch.zeros(bt, l, h)
    b = torch.zeros(bt, l, n)
    y, state = torch.empty_like(x), torch.empty(bt, h, p, n)
    _ssd.ssd_scan(x, a, b, b, None, y, state, 64)
    args = lib.calls["ssd_scan"]
    assert args[:4] == (0, p, n, 64)
    assert args[8] is None                      # no h0: a zero state
    assert args[12:] == (bt, l, h, 5)
    sync = _decode._COUNTERS[(x.device, 5)]
    assert args[11] == sync.data_ptr()
    assert sync.numel() >= _ssd.sync_ints(bt, h, p)
    assert sync.dtype == torch.int32 and not sync.any()


def test_plain_ssd_scan_matches_pallas_at_the_kernel_shape():
    """``ops.ssd_scan`` on CPU tensors against the Pallas kernel in
    interpret mode at the CUDA kernel's own (p, n) = (64, 128) and chunk
    128: two chunks of 256 rows, 2 heads, 2 batch rows, from a zero
    state, with the model's decays (dt * A, A from 1 to 16)."""
    rng = np.random.RandomState(17)
    bt, l, h, p, n = 2, 256, 2, 64, 128
    x = rng.randn(bt, l, h, p).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(bt, l, h))).astype(np.float32)
    a = (-dt * np.linspace(1, 16, h)).astype(np.float32)
    b = (0.3 * rng.randn(bt, l, n)).astype(np.float32)
    c = (0.3 * rng.randn(bt, l, n)).astype(np.float32)
    ops.reset_launches()
    y, state = ops.ssd_scan(*(torch.from_numpy(t) for t in (x, a, b, c)))
    assert not any(ops.LAUNCHES.values())
    assert y.shape == (bt, l, h, p) and state.shape == (bt, h, p, n)
    wy, ws = jssd.ssd_scan(*(jnp.asarray(t) for t in (x, a, b, c)),
                           chunk=_ssd.DEFAULT_CHUNK, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), atol=SSD_TOL,
                               rtol=SSD_TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(ws), atol=SSD_TOL,
                               rtol=SSD_TOL)
