"""Host-side page accounting of the PyTorch port against the reference:
the same operations on both allocators hand out the same page ids and
keep the same counters; the allocation units and the page-table gather
agree."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import paged as jpaged

from repro_torch.serve import paged


def _state(a):
    return (dict(a.slot_pages), a.free_pages, a.pages_in_use,
            a.pages_allocated, a.pages_freed, a.high_water)


@pytest.mark.parametrize("seed", range(6))
def test_allocator_matches_reference_on_random_ops(seed):
    rng = np.random.RandomState(seed)
    n_pages = int(rng.randint(2, 24))
    mine = paged.PageAllocator(n_pages, page_size=8)
    ref = jpaged.PageAllocator(n_pages, page_size=8, n_devices=1)
    assert mine.capacity == ref.capacity
    for _ in range(200):
        op = rng.randint(3)
        slot = int(rng.randint(4))
        if op == 0:
            n = int(rng.randint(1, 4))
            assert mine.can_alloc(n) == ref.can_alloc(n)
            if ref.can_alloc(n):
                assert mine.alloc(slot, n) == ref.alloc(slot, n)
            else:
                with pytest.raises(paged.PagePoolExhausted):
                    mine.alloc(slot, n)
                with pytest.raises(jpaged.PagePoolExhausted):
                    ref.alloc(slot, n)
        elif op == 1:
            assert mine.free_slot(slot) == ref.free_slot(slot)
        else:
            n = int(rng.randint(0, n_pages + 1))
            assert mine.can_alloc(n) == ref.can_alloc(n)
        assert _state(mine) == _state(ref)
        assert mine.pages_allocated - mine.pages_freed == mine.pages_in_use
        assert 0 not in mine._ref          # the live pages


def test_allocation_units_match_reference():
    for ps in (1, 4, 8, 16):
        for rows in range(0, 70):
            assert paged.pages_for(rows, ps) == jpaged.pages_for(rows, ps)
        for cursor in range(0, 64, 3):
            for chunk in (1, 8, 16, 40):
                for held in range(0, 6):
                    args = (cursor, chunk, held, ps, 48)
                    assert paged.chunk_page_need(*args) == \
                        jpaged.chunk_page_need(*args), args


def test_gather_kv_matches_reference():
    rng = np.random.RandomState(0)
    kp = rng.randn(9, 4, 2, 3).astype(np.float32)
    vp = rng.randn(9, 4, 2, 3).astype(np.float32)
    pages = np.asarray([[3, 1, 0], [8, 0, 0]], np.int32)
    want_k, want_v = jpaged.gather_kv(jnp.asarray(kp), jnp.asarray(vp),
                                      jnp.asarray(pages))
    got_k, got_v = paged.gather_kv(torch.from_numpy(kp), torch.from_numpy(vp),
                                   torch.from_numpy(pages))
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("seed", range(3))
def test_write_rows_keeps_the_last_write_like_the_reference(seed):
    """Many writes to few pool rows (as free slots and padded chunk rows
    all write the null page): each row holds the last write, as the
    reference's ``.at[page, row].set`` leaves it."""
    rng = np.random.RandomState(seed)
    kp = rng.randn(3, 4, 2, 5).astype(np.float32)
    vp = rng.randn(3, 4, 2, 5).astype(np.float32)
    page = rng.randint(0, 2, size=(3, 16))
    row = rng.randint(0, 4, size=(3, 16))
    k = rng.randn(3, 16, 2, 5).astype(np.float32)
    v = rng.randn(3, 16, 2, 5).astype(np.float32)
    want_k = jnp.asarray(kp).at[page, row].set(jnp.asarray(k))
    want_v = jnp.asarray(vp).at[page, row].set(jnp.asarray(v))
    got_k, got_v = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    paged.write_rows(got_k, got_v, torch.from_numpy(k), torch.from_numpy(v),
                     torch.from_numpy(page), torch.from_numpy(row))
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    src = paged.last_writers(torch.from_numpy(page), torch.from_numpy(row),
                             4, 12).numpy()
    flat = page.reshape(-1) * 4 + row.reshape(-1)
    assert all(src[i] == np.flatnonzero(flat == flat[i]).max()
               for i in range(flat.size))
