"""The benchmark's count of work: bytes and FLOPs of the port's kernels and
of a model's tokens, from shapes alone. A frozen copy of
``repro_torch/kernels/cost.py`` (``flash_decode``, ``ssd_tri``,
``ssd_scan``, ``causal_pairs``, ``flash_attention``), so that a change to
the program cannot move its own yardstick; ``ssd_scan`` counts its FLOPs
at one fixed chunk (``SSD_CHUNK``) whatever chunk the program runs.

Bytes are each input read once and each output written once; the
decode's split partials are left out (``n_splits`` 0), so the count does
not change with a tile or with the kernel that does the work. FLOPs are
useful ones: two a multiply-add of the products, none for exponentials or
the softmax's sums, none for padded rows.
"""

from __future__ import annotations

from typing import Tuple

SSD_CHUNK = 128


def flash_decode(b: int, h: int, kvh: int, d: int, esize: int,
                 kv_rows: int, lse: bool = False) -> Tuple[int, int]:
    """(bytes, FLOPs) of a decode of b query rows of h heads over
    ``kv_rows`` cache rows in all (the sum of the rows' contexts): q read
    and the output written, each row's K and V of ``kvh`` heads read, the
    int32 lengths, with ``lse`` the fp32 log-sum-exps written. The paged
    decode reads the same, its page table aside (one int32 a page)."""
    nbytes = 2 * b * h * d * esize + 2 * kv_rows * kvh * d * esize + 4 * b
    if lse:
        nbytes += 4 * b * h
    return nbytes, 4 * kv_rows * h * d


def ssd_tri(l: int, chunk: int) -> int:
    """(row, earlier row) pairs inside the chunks of an l-row scan, the
    diagonal included."""
    return sum(min(chunk, l - t0) * (min(chunk, l - t0) + 1) // 2
               for t0 in range(0, l, chunk))


def ssd_scan(bt: int, l: int, h: int, p: int, n: int, esize: int,
             h0: bool = False) -> Tuple[int, int]:
    """(bytes, FLOPs) of an SSD scan of ``bt`` rows of l steps at head
    shape (h, p, n): x read and y written, the fp32 a_log, B and C read,
    the fp32 final state written (and with ``h0`` read); FLOPs of the
    chunked algorithm at ``SSD_CHUNK``."""
    nbytes = (2 * l * h * p * esize + 4 * l * h + 2 * l * n * esize
              + 4 * h * p * n * (2 if h0 else 1))
    flops = h * 2 * (ssd_tri(l, SSD_CHUNK) * (n + p) + 2 * l * p * n)
    return bt * nbytes, bt * flops


def causal_pairs(sq: int, skv: int) -> int:
    """(query, key) pairs of a causal attention whose query i sees keys
    ``<= i + skv - sq``."""

    def upto(n: int) -> int:
        if n <= 0:
            return 0
        m = min(n, skv)
        return m * (m + 1) // 2 + (n - m) * skv

    return upto(skv) - upto(skv - sq)


def flash_attention(b: int, sq: int, skv: int, h: int, kvh: int, d: int,
                    esize: int, causal: bool) -> Tuple[int, int]:
    """(bytes, FLOPs) of attention of sq new rows over skv keys: q read
    and the output written, K and V read; 4 d FLOPs a (query head, key)
    pair the mask keeps. A paged prefill chunk of n valid rows written
    from ``start`` is ``flash_attention(1, n, start + n, ...)``."""
    pairs = causal_pairs(sq, skv) if causal else sq * skv
    nbytes = esize * (2 * b * sq * h * d + 2 * b * skv * kvh * d)
    return nbytes, 4 * b * h * d * pairs


# ----------------------------------------------------------------------------
# A model's tokens
# ----------------------------------------------------------------------------

def token_flops(m: dict) -> int:
    """FLOPs of one token's matrix products through every layer of the
    model ``m`` (a config file's ``port_config``), attention scores aside:
    the projections, the dense MLP or the mixture's router and its top-k
    experts, the Mamba mixer's projections and conv. The unembedding is
    counted apart (``head_flops``): only a token whose logits are read
    needs it."""
    d, h, kvh = m["d_model"], m["n_heads"], m["n_kv_heads"]
    hd = m.get("head_dim") or d // h
    f = m["d_ff"]
    pattern = m.get("pattern", ["attn"])
    moe = set(m.get("moe_positions", ()))
    total = 0
    for i in range(m["n_layers"]):
        if pattern[i % len(pattern)] == "attn":
            total += 2 * d * (h + 2 * kvh) * hd + 2 * h * hd * d
        else:
            mh = m["mamba_expand"] * d // m["mamba_head_dim"]
            p, n = m["mamba_head_dim"], m["mamba_d_state"]
            total += 2 * (2 * d * mh * p + 2 * d * n + d * mh + mh * p * d
                          + 4 * mh * p)
        if m.get("n_experts") and i % len(pattern) in moe:
            total += 2 * d * m["n_experts"] + m["top_k"] * 6 * d * f
        elif f:
            total += 6 * d * f
    return total


def head_flops(m: dict) -> int:
    return 2 * m["d_model"] * m["vocab"]


def attention_layers(m: dict) -> int:
    pattern = m.get("pattern", ["attn"])
    return sum(pattern[i % len(pattern)] == "attn"
               for i in range(m["n_layers"]))


def prefill_flops(m: dict, start: int, rows: int) -> int:
    """FLOPs of ``rows`` prompt rows written from ``start`` (a chunk, or
    a whole prompt from 0): their products, causal attention over
    ``start + rows`` keys in every attention layer."""
    h = m["n_heads"]
    hd = m.get("head_dim") or m["d_model"] // h
    attn = 4 * h * hd * causal_pairs(rows, start + rows)
    return rows * token_flops(m) + attention_layers(m) * attn


def decode_flops(m: dict, rows: int, kv_rows: int) -> int:
    """FLOPs of one decode step of ``rows`` live rows attending
    ``kv_rows`` cache rows in all, each row's logits included."""
    h = m["n_heads"]
    hd = m.get("head_dim") or m["d_model"] // h
    return rows * (token_flops(m) + head_flops(m)) + \
        attention_layers(m) * 4 * h * hd * kv_rows
