"""Public wrappers of the CUDA kernels.

Same arguments and layouts as ``repro/kernels/ops.py``'s
``flash_attention`` / ``flash_decode_paged`` / ``flash_attention_paged`` /
``flash_decode`` / ``ssd_scan`` / ``gemm`` / ``pchase``, and
``pchase_timed``, the chase timed load by load. The attention wrappers
take the reference's ``block_q``/``block_k``, and ``gemm`` its ``block``:
None takes the tile ``core.autotune`` chooses from the shapes alone; a
given tile snaps to one the kernel instantiates (``prefill_tile``,
``decode_tile``), and ``ssd_scan``'s ``chunk`` to one of the kernel's
chunks (``ssd_chunk``). A tensor on the CPU goes to the plain version
(``kernels.ref``); a CUDA tensor goes to the kernel, or the wrapper raises.
There is no fallback from one to the other.

The kernels have no backward, as the reference's Pallas kernels have none
(``jax.grad`` through them raises): every wrapper raises when grad mode is
on and a floating input requires grad, on the CPU as on the card, so a
gradient is never silently cut at a kernel's output. Call them under
``torch.no_grad()``; training runs the plain ``sdpa``.

``LAUNCHES`` counts kernel launches, one per call that reached the kernel;
the plain versions never touch it. ``pchase_timed`` counts under a key of
its own, so a run of one chase path is not read as the other's.

The three kernels the dry run reaches (``flash_decode``, ``ssd_scan``,
``flash_attention``) take meta tensors too: they return empty outputs
of the kernel's shapes and record one op under the kernel's name, with
its bytes and FLOPs (``kernels.cost``), in the op traces that are
recording (``core.op_analysis``). Neither the kernel nor its plain
version runs, and no launch is counted. A launch of one of them on the
card records the same op, so a traced run on the card and its meta
trace have one census. Every other wrapper refuses a
meta tensor, as it refuses any device but the CPU and CUDA.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core import autotune, op_analysis
from repro_torch.kernels import cost
from repro_torch.kernels import flash_attention as _prefill
from repro_torch.kernels import flash_decode as _decode
from repro_torch.kernels import gemm as _gemm
from repro_torch.kernels import pchase_probe as _pchase
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as _ssd

LAUNCHES: Dict[str, int] = {"flash_attention": 0,
                            "flash_decode_paged": 0,
                            "flash_attention_paged": 0,
                            "flash_decode": 0,
                            "ssd_scan": 0,
                            "gemm": 0,
                            "pchase": 0,
                            "pchase_timed": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_no_grad(tensors) -> None:
    """Raise when autograd would need a kernel's backward, which none
    has: grad mode on and an input that requires grad."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        raise RuntimeError(
            "the kernels have no backward: an input requires grad while "
            "grad mode is on; run them under torch.no_grad() (training "
            "goes through the plain sdpa, use_flash=False)")


def _check_device(tensors, dtype, meta: bool = False) -> bool:
    """Common device checks; True when the tensors lie on the CPU (the
    plain path), or on the meta device where ``meta`` allows it (the
    cost branch), after which only the kernels' own limits remain."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"arguments on several devices: {devs}")
    dev = devs.pop()
    if dev.type == "cpu" or (meta and dev.type == "meta"):
        return True
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if dtype not in _decode.DTYPES:
        raise TypeError(f"kernel takes float32/bfloat16, got {dtype}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("kernel arguments must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("kernel arguments must be 16-byte aligned")
    return False


def _check(q, k, v, lens, q_rank: int, page_table=None,
           meta: bool = False) -> None:
    """Raise on anything the attention kernels do not take. Shared by both
    paths, so the CPU tests exercise the same contract the card enforces.
    ``k``/``v`` are a page pool (n_pages, page_size, kvh, d) walked through
    ``page_table``, or, without a table, a contiguous cache
    (b, max_len, kvh, d)."""
    if q.dim() != q_rank or k.dim() != 4:
        raise ValueError(f"q rank {q.dim()} (want {q_rank}), cache rank "
                         f"{k.dim()} (want 4)")
    if k.shape != v.shape:
        raise ValueError(f"k/v differ: {tuple(k.shape)} vs "
                         f"{tuple(v.shape)}")
    b, h, d = q.shape[0], q.shape[-2], q.shape[-1]
    kvh = k.shape[2]
    if k.shape[3] != d or h % kvh:
        raise ValueError(f"q heads/dim ({h}, {d}) vs cache kv heads/dim "
                         f"({kvh}, {k.shape[3]})")
    if tuple(lens.shape) != (b,):
        raise ValueError(f"lengths/starts {tuple(lens.shape)} do not match "
                         f"batch {b}")
    if page_table is None:
        if k.shape[0] != b:
            raise ValueError(f"cache batch {k.shape[0]} != q batch {b}")
    elif page_table.dim() != 2 or page_table.shape[0] != b:
        raise ValueError(f"page_table {tuple(page_table.shape)} does not "
                         f"match batch {b}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"cache dtype {k.dtype} != q dtype {q.dtype}")
    _check_no_grad([q, k, v])
    ints = [lens] + ([] if page_table is None else [page_table])
    if _check_device([q, k, v, *ints], q.dtype, meta):
        return
    if d not in _decode.HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim in {_decode.HEAD_DIMS}, "
                         f"got {d}")
    if any(t.dtype != torch.int32 for t in ints):
        raise TypeError("page_table and lengths/starts must be int32")


def _check_flash(q, k, v, causal: bool) -> None:
    """Raise on anything the full-sequence kernel does not take, where the
    reference asserts or its shapes would not line up."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q rank {q.dim()} and k rank {k.dim()} (want 4)")
    if k.shape != v.shape:
        raise ValueError(f"k/v differ: {tuple(k.shape)} vs "
                         f"{tuple(v.shape)}")
    b, sq, h, d = q.shape
    kb, skv, kvh, kd = k.shape
    if kb != b:
        raise ValueError(f"k/v batch {kb} != q batch {b}")
    if kd != d or h % kvh:
        raise ValueError(f"q heads/dim ({h}, {d}) vs k/v heads/dim "
                         f"({kvh}, {kd})")
    if causal and sq > skv:
        raise ValueError(f"causal attention with sq {sq} > skv {skv} "
                         f"leaves early queries no key")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"k/v dtype {k.dtype}/{v.dtype} != q dtype "
                        f"{q.dtype}")
    _check_no_grad([q, k, v])
    if _check_device([q, k, v], q.dtype, meta=True):
        return
    if d not in _decode.HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim in {_decode.HEAD_DIMS}, "
                         f"got {d}")
    if max(b, h) >= 2**16:
        raise ValueError(f"batch {b} or heads {h} exceed the kernel's grid "
                         f"(65535)")


def _snap(tile: int, instantiated, what: str) -> int:
    """The largest instantiated tile not above ``tile``; below the
    smallest, raise."""
    fits = [t for t in instantiated if t <= int(tile)]
    if not fits:
        raise ValueError(f"{what} {tile} is below the smallest tile the "
                         f"kernel instantiates: {tuple(instantiated)}")
    return max(fits)


def prefill_tile(q, skv: int, causal: bool, block_q=None, block_k=None,
                 choose: bool = True):
    """The tile (``autotune.AttnBlock``) a prefill of q (b, sq, h, d) over
    ``skv`` keys runs. A given ``block_q`` snaps to the largest of
    ``flash_attention.BLOCK_QS`` not above it, ``block_k`` to the key tile
    ``TILE_K`` (the reference snaps to the largest divisor of the length
    instead: the kernel masks ragged edges, so it needs none); a tile below
    the smallest raises. None takes ``autotune.choose_attn_block``'s tile
    for the reference wrappers' problem, from shapes alone; with
    ``choose`` False (the plain path, whose result no tile changes) a None
    stays None."""
    if choose and (block_q is None or block_k is None):
        b, sq, h, d = q.shape
        chosen, _ = autotune.choose_attn_block(autotune.AttnProblem(
            sq=sq, skv=skv, n_heads=h, head_dim=d, batch=b, causal=causal,
            in_bytes=q.element_size()))
        block_q = chosen.block_q if block_q is None else block_q
        block_k = chosen.block_k if block_k is None else block_k
    return autotune.AttnBlock(
        None if block_q is None else _snap(block_q, _prefill.BLOCK_QS,
                                           "block_q"),
        None if block_k is None else _snap(block_k, (_prefill.TILE_K,),
                                           "block_k"))


def decode_tile(q, kvh: int, max_rows: int, page_size: int = 1,
                block_k=None, choose: bool = True):
    """The tile a decode of q (b, h, d) over a cache of ``kvh`` kv heads
    reaching ``max_rows`` rows runs: the dtype's query block by a split of
    ``block_k`` rows. A given ``block_k`` snaps to the largest of
    ``flash_decode.SPLIT_ROWS_SET`` not above it (below the smallest
    raises), and runs rounded to whole pages (``flash_decode.splits``).
    None takes ``autotune.choose_attn_block``'s split for the reference
    wrappers' problem (sq = the group, the kv heads, not causal), from
    shapes alone; with ``choose`` False a None stays None."""
    b, h, d = q.shape
    if choose and block_k is None:
        chosen, _ = autotune.choose_attn_block(autotune.decode_problem(
            b, h, kvh, d, max_rows, q.element_size(), page_size))
        block_k = chosen.block_k
    return autotune.AttnBlock(
        _decode.QUERY_BLOCK.get(q.dtype, 0),
        None if block_k is None else _snap(block_k, _decode.SPLIT_ROWS_SET,
                                           "block_k"))


def flash_attention(q, k, v, causal: bool = True, block_q=None,
                    block_k=None):
    """Full-sequence GQA attention: q (b, sq, h, d) vs k/v (b, skv, kvh,
    d), fp32 online softmax, the output in q's dtype. Causal: query i
    attends keys ``<= i + skv - sq``. Any sq and skv (the kernel masks the
    ragged edges). ``block_q``/``block_k``: the tile (``prefill_tile``).
    Returns (b, sq, h, d)."""
    _check_flash(q, k, v, causal)
    tile = prefill_tile(q, k.shape[1], causal, block_q, block_k,
                        choose=q.device.type != "cpu")
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal)
    b, sq, h, d = q.shape
    out = torch.empty_like(q)
    if out.numel():
        if q.device.type == "cuda":
            _prefill.flash_attention(q, k, v, causal, out, tile.block_q)
            LAUNCHES["flash_attention"] += 1
        _record("flash_attention", [q, k, v], [out],
                lambda: cost.flash_attention(b, sq, k.shape[1], h, k.shape[2],
                                             d, q.element_size(), causal))
    return out


def flash_decode_paged(q, k_pages, v_pages, page_table, lengths,
                       block_k=None):
    """Paged GQA decode: q (b, h, d) vs a (n_pages, page_size, kvh, d)
    pool walked through ``page_table`` (b, max_pages); slot i attends its
    first ``lengths[i]`` rows (0 gives zeros). ``block_k``: the rows of a
    split (``decode_tile``). Returns (b, h, d)."""
    _check(q, k_pages, v_pages, lengths, 3, page_table)
    page_size = k_pages.shape[1]
    tile = decode_tile(q, k_pages.shape[2], page_table.shape[1] * page_size,
                       page_size, block_k, choose=q.device.type != "cpu")
    if q.device.type == "cpu":
        return ref.flash_decode_paged(q, k_pages, v_pages, page_table,
                                      lengths)
    out = torch.empty_like(q)
    if q.shape[0]:
        _decode.paged_decode(q, k_pages, v_pages, page_table, lengths, out,
                             tile.block_k)
        LAUNCHES["flash_decode_paged"] += 1
    return out


def flash_attention_paged(q, k_pages, v_pages, page_table, starts,
                          block_q=None, block_k=None):
    """Causal chunk attention against a paged pool: q (b, sq, h, d) at
    global positions ``starts[i] + [0, sq)``; the chunk's own K/V rows
    must already be written through the table. ``block_q``/``block_k``:
    the tile (``prefill_tile``, over the pool's reach ``max_pages *
    page_size``, as the reference's problem). Returns (b, sq, h, d)."""
    _check(q, k_pages, v_pages, starts, 4, page_table)
    tile = prefill_tile(q, page_table.shape[1] * k_pages.shape[1], True,
                        block_q, block_k, choose=q.device.type != "cpu")
    if q.device.type == "cpu":
        return ref.flash_attention_paged(q, k_pages, v_pages, page_table,
                                         starts)
    out = torch.empty_like(q)
    if q.shape[0] and q.shape[1]:
        _prefill.paged_prefill(q, k_pages, v_pages, page_table, starts, out,
                               tile.block_q)
        LAUNCHES["flash_attention_paged"] += 1
    return out


def flash_decode(q, k, v, lengths, block_k=None, return_lse: bool = False):
    """Contiguous GQA decode: q (b, h, d) vs a ragged (b, max_len, kvh, d)
    cache in q's dtype; slot i attends its first ``min(lengths[i],
    max_len)`` rows (0 gives zeros). ``block_k``: the rows of a split
    (``decode_tile``). Returns (b, h, d), and with ``return_lse`` also
    each row's log-sum-exp of its scaled scores, fp32 (b, h), -inf for a
    zero-length slot. On meta tensors the rows are counted at the cache's
    full length (the dry run's static shapes), with the partials of the
    splits the chosen tile cuts."""
    _check(q, k, v, lengths, 3, meta=True)
    tile = decode_tile(q, k.shape[2], k.shape[1], 1, block_k,
                       choose=q.device.type != "cpu")
    if q.device.type == "cpu":
        return ref.flash_decode(q, k, v, lengths, return_lse=return_lse)
    b, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if b:
        if q.device.type == "cuda":
            _decode.contiguous_decode(q, k, v, lengths, out, lse,
                                      tile.block_k)
            LAUNCHES["flash_decode"] += 1
        n_splits = _decode.splits(k.shape[1], 1, tile.block_k)[1]
        _record("flash_decode", [q, k, v, lengths],
                [out] + ([lse] if return_lse else []),
                lambda: cost.flash_decode(b, h, k.shape[2], d,
                                          q.element_size(), b * k.shape[1],
                                          return_lse, n_splits))
    return (out, lse) if return_lse else out


def _record(name: str, inputs, outputs, work) -> None:
    """A meta call's or a launch's one op, in every op trace that is
    recording (``core.op_analysis``), with ``work()``'s (bytes, FLOPs):
    counted at the shapes alone, every row of a cache, as on meta, and
    only while a trace records."""
    if op_analysis.recording():
        nbytes, flops = work()
        op_analysis.record_kernel(name, inputs, outputs, flops=flops,
                                  nbytes=nbytes)


def ssd_chunk(chunk: int) -> int:
    """The chunk an SSD scan asked for ``chunk`` runs: the largest of
    ``ssd_scan.CHUNKS`` not above it; below the smallest, raise. (The
    reference snaps to the largest divisor of the length instead, down to
    1 at a prime length: the kernel masks a ragged last chunk, so it
    needs no divisor.)"""
    return _snap(chunk, _ssd.CHUNKS, "ssd_scan chunk")


def _check_ssd(x, a_log, b, c, h0, chunk: int) -> None:
    """Raise on anything the SSD scan kernel does not take."""
    if x.dim() != 4 or a_log.dim() != 3 or b.dim() != 3:
        raise ValueError(f"ranks x {x.dim()} (want 4), a_log {a_log.dim()} "
                         f"(want 3), b {b.dim()} (want 3)")
    bt, l, h, p = x.shape
    n = b.shape[-1]
    if tuple(a_log.shape) != (bt, l, h):
        raise ValueError(f"a_log {tuple(a_log.shape)} != {(bt, l, h)}")
    if b.shape != c.shape or tuple(b.shape[:2]) != (bt, l):
        raise ValueError(f"b {tuple(b.shape)} / c {tuple(c.shape)} do not "
                         f"match x {tuple(x.shape)}")
    if h0 is not None and tuple(h0.shape) != (bt, h, p, n):
        raise ValueError(f"h0 {tuple(h0.shape)} != {(bt, h, p, n)}")
    if b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"b/c dtype {b.dtype}/{c.dtype} != x dtype {x.dtype}")
    if a_log.dtype != torch.float32 or (h0 is not None
                                        and h0.dtype != torch.float32):
        raise TypeError("a_log and h0 must be float32")
    if l < 1:
        raise ValueError("ssd_scan needs at least one row")
    _check_no_grad([x, a_log, b, c, h0])
    if _check_device([x, a_log, b, c] + ([] if h0 is None else [h0]),
                     x.dtype, meta=True):
        return
    if (p, n) not in _ssd.SHAPES:
        raise ValueError(f"kernel takes (head_dim, d_state) in "
                         f"{_ssd.SHAPES}, got {(p, n)}")
    _ssd.check_grid(bt, l, h, p, chunk)


def ssd_scan(x, a_log, b, c, h0=None, chunk: int = _ssd.DEFAULT_CHUNK):
    """Chunked Mamba-2 SSD scan: x (bt, l, h, p) dt-scaled inputs, a_log
    (bt, l, h) fp32 log decays, b/c (bt, l, n) in x's dtype shared by all
    heads, h0 (bt, h, p, n) fp32 or None (zeros). Returns y (bt, l, h, p)
    in x's dtype and the final state (bt, h, p, n) fp32. ``chunk`` (the
    reference's default, 128) snaps down to an instantiated chunk
    (``ssd_chunk``), which both the kernel and the plain version run. Any
    l: the last chunk is masked."""
    chunk = ssd_chunk(chunk)
    _check_ssd(x, a_log, b, c, h0, chunk)
    if x.device.type == "cpu":
        return ref.ssd_scan(x, a_log, b, c, h0, chunk=chunk)
    bt, l, h, p = x.shape
    y = torch.empty_like(x)
    state = torch.empty((bt, h, p, b.shape[-1]), dtype=torch.float32,
                        device=x.device)
    if bt and h:
        if x.device.type == "cuda":
            _ssd.ssd_scan(x, a_log, b, c, h0, y, state, chunk)
            LAUNCHES["ssd_scan"] += 1
        _record("ssd_scan", [x, a_log, b, c] + ([] if h0 is None else [h0]),
                [y, state],
                lambda: cost.ssd_scan(bt, l, h, p, b.shape[-1],
                                      x.element_size(), chunk,
                                      h0 is not None))
    return y, state


def _check_gemm(x, y, block) -> tuple:
    """Raise on anything the GEMM kernel does not take; returns the tile,
    ``block`` or, for None, the chooser's (``core.autotune``)."""
    if x.dim() != 2 or y.dim() != 2:
        raise ValueError(f"gemm takes (m, k) @ (k, n), got ranks {x.dim()} "
                         f"and {y.dim()}")
    if x.shape[1] != y.shape[0]:
        raise ValueError(f"inner dims differ: {tuple(x.shape)} @ "
                         f"{tuple(y.shape)}")
    if x.dtype != y.dtype or x.dtype not in _decode.DTYPES:
        raise TypeError(f"gemm takes float32/bfloat16 of one dtype, got "
                        f"{x.dtype} and {y.dtype}")
    _check_no_grad([x, y])
    if block is None:
        cfg, _ = autotune.choose_gemm_block(autotune.GemmProblem(
            m=x.shape[0], k=x.shape[1], n=y.shape[1],
            in_bytes=x.element_size()))
        block = (cfg.bm, cfg.bk, cfg.bn)
    if tuple(block) not in _gemm.TILES[x.dtype]:
        raise ValueError(f"gemm tile {block} is not one the kernel "
                         f"instantiates for {x.dtype}: "
                         f"{_gemm.TILES[x.dtype]}")
    if _check_device([x, y], x.dtype):
        return tuple(block)
    if max(*x.shape, y.shape[1]) >= 2**31:
        raise ValueError(f"gemm dims {tuple(x.shape)} @ {tuple(y.shape)} "
                         f"exceed the kernel's int32 sizes")
    return tuple(block)


def gemm(x, y, block=None):
    """x (m, k) @ y (k, n) in fp32 or bf16 with an fp32 accumulator, the
    output rounded once to x's dtype. ``block`` (bm, bk, bn) names one of
    ``kernels.gemm.TILES[x.dtype]``; None takes the tile ``core.autotune``
    chooses for the problem. Any m, k, n: the kernel masks ragged edges.
    fp32 runs on the CUDA cores, bf16 on the tensor cores."""
    block = _check_gemm(x, y, block)
    if x.device.type == "cpu":
        return ref.gemm(x, y)
    out = torch.empty((x.shape[0], y.shape[1]), dtype=x.dtype,
                      device=x.device)
    if out.numel():
        _gemm.gemm(x, y, out, block)
        LAUNCHES["gemm"] += 1
    return out


def _check_chain(chain, steps) -> None:
    """Raise on a chain the chase kernel cannot follow safely: not a
    contiguous rank-1 int32 tensor, no step, or an entry outside [0, n).
    The entries are checked once per content of the chain (its version
    counter, which every in-place write bumps), so a timed launch over a
    checked chain runs no check."""
    if chain.dim() != 1 or chain.dtype != torch.int32 \
            or not chain.is_contiguous():
        raise ValueError(f"pchase takes a contiguous rank-1 int32 chain, "
                         f"got {chain.dtype} of shape {tuple(chain.shape)}")
    if not 1 <= steps < 2**31:
        raise ValueError(f"pchase takes 1 to 2**31 - 1 steps, got {steps}")
    if chain.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {chain.device}")
    if getattr(chain, "_pchase_checked", None) != chain._version:
        n = chain.shape[0]
        if n == 0 or bool(((chain < 0) | (chain >= n)).any()):
            raise ValueError(f"pchase chain has an entry outside [0, {n})")
        chain._pchase_checked = chain._version


def pchase(chain, steps: int):
    """Follow ``chain`` (int32 next-index array) from position 0 for
    ``steps`` dependent loads; returns the visited positions (steps,)
    int32."""
    _check_chain(chain, steps)
    if chain.device.type == "cpu":
        return ref.pchase(chain, steps)
    out = torch.empty(steps, dtype=torch.int32, device=chain.device)
    _pchase.pchase(chain, out)
    LAUNCHES["pchase"] += 1
    return out


def _check_timed(chain, steps, start, warm, carveout) -> None:
    """Raise on what ``pchase_timed`` does not take. The entries are not
    read here: the kernel stops at an offset outside the chain and the
    wrapper raises after it, so a multi-GB chain costs no host pass."""
    if chain.dim() != 1 or chain.dtype != torch.int64 \
            or not chain.is_contiguous() or chain.shape[0] == 0:
        raise ValueError(f"pchase_timed takes a non-empty contiguous rank-1 "
                         f"int64 chain, got {chain.dtype} of shape "
                         f"{tuple(chain.shape)}")
    if not 1 <= steps < 2**31:
        raise ValueError(f"pchase_timed takes 1 to 2**31 - 1 steps, got "
                         f"{steps}")
    if warm < 0:
        raise ValueError(f"pchase_timed takes warm >= 0, got {warm}")
    if start % 8 or not 0 <= start < 8 * chain.shape[0]:
        raise ValueError(f"start {start} is not an 8-byte slot of the chain")
    if not 0 <= carveout <= 100:
        raise ValueError(f"carveout is a percentage, got {carveout}")
    if chain.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {chain.device}")


def pchase_timed(chain, steps: int, start: int = 0, warm: int = 0,
                 bypass_l1: bool = False, offsets: bool = True,
                 carveout: int = 0):
    """Walk the int64 byte-offset ``chain`` from ``start``: ``warm`` steps
    untimed, then ``steps`` timed one by one. Returns ``(offsets, cycles,
    total)``: the offsets the timed steps loaded ((steps,) int64, None
    unless ``offsets``), each load's cycles ((steps,) int32, clock64
    deltas), and the cycles of the whole timed walk, loads and the work
    between them (a one-element int64). ``bypass_l1`` loads with
    ``ld.global.cg``; ``carveout`` is the kernel's preferred shared-memory
    carveout in percent (0: the largest L1). On the CPU the plain version
    gives the offsets and ``cycles`` and ``total`` are None: there is no
    clock to read."""
    _check_timed(chain, steps, start, warm, carveout)
    if chain.device.type == "cpu":
        return (ref.pchase_timed(chain, steps, start, warm) if offsets
                else None), None, None
    dev = chain.device
    out = (torch.empty(steps, dtype=torch.int64, device=dev) if offsets
           else None)
    cycles = torch.empty(steps, dtype=torch.int32, device=dev)
    total = torch.empty(1, dtype=torch.int64, device=dev)
    status = torch.zeros(1, dtype=torch.int32, device=dev)
    _pchase.pchase_timed(chain, start, warm, out, cycles, total, status,
                         bypass_l1, carveout)
    LAUNCHES["pchase_timed"] += 1
    if int(status.item()):
        raise ValueError("pchase_timed met an offset outside the chain, "
                         "negative or not a multiple of 8")
    return out, cycles, total
