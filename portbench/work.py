"""The work of the traced slice, counted from the harness's own record of
it (each decode step's live rows and their contexts, each paged prefill
chunk's start and valid rows) by the benchmark's own counts
(``cost.py``), priced against the card's peaks (``peaks.py``)."""

from __future__ import annotations

from portbench import cost, peaks


def _dims(m: dict):
    h = m["n_heads"]
    return h, m["n_kv_heads"], m.get("head_dim") or m["d_model"] // h


def model_flops(run) -> float:
    """Model FLOPs of every row the traced slice processed: each decode
    step's live rows with their logits, each chunk's valid rows, and the
    logits of each prompt's last row."""
    m, p = run.cell.model, run.profile
    flops = sum(cost.decode_flops(m, rows, kv) for rows, kv in p.decode_calls)
    for rid, start, rows in p.chunk_calls:
        flops += cost.prefill_flops(m, start, rows)
        rec = run.recs.get(rid)
        if rec is not None and start + rows == len(rec.prompt):
            flops += cost.head_flops(m)
    return float(flops)


def decode_least_s(run) -> float:
    """Least time of the slice's paged decode calls (one an attention
    layer a step): the live rows' q read and output written, their K and V
    rows and page-table entries read."""
    m, p = run.cell.model, run.profile
    h, kvh, d = _dims(m)
    ps = run.cell.spec["engine"].get("page_size", 16)
    total = 0.0
    for rows, kv in p.decode_calls:
        nbytes, flops = cost.flash_decode(rows, h, kvh, d, run.esize, kv)
        total += peaks.least_time(nbytes + 4 * -(-kv // ps), flops)
    return total * cost.attention_layers(m)


def prefill_least_s(run) -> float:
    """Least time of the slice's paged prefill calls (one an attention
    layer a chunk): the valid rows against every key before them."""
    m, p = run.cell.model, run.profile
    h, kvh, d = _dims(m)
    ps = run.cell.spec["engine"].get("page_size", 16)
    total = 0.0
    for _, start, rows in p.chunk_calls:
        nbytes, flops = cost.flash_attention(1, rows, start + rows, h, kvh, d,
                                             run.esize, causal=True)
        total += peaks.least_time(nbytes + 4 * -(-(start + rows) // ps),
                                  flops)
    return total * cost.attention_layers(m)
