"""Speculative decoding: draft sources and exact acceptance (port of
``repro/serve/spec.py``, the fixed-k part).

A verify tick scores each slot's pending token and up to ``k`` drafted
tokens in one forward of width ``k + 1`` (``ServingEngine._spec_tick``).
Draft j is accepted while it equals the token the target picks after the
context and drafts ``[:j]``; the target's pick at the first mismatch (or
after the last draft) is emitted as the corrected bonus token, so a tick
emits at least one token and the stream is the plain engine's, greedy or
sampled: the engine keys every emitted position by (request, emitted
index), so the verify draws the same keys as sequential decode.

Draft sources have ``propose(history, k) -> at most k token ids``:

* ``NgramDraft`` — prompt lookup over the trailing ``window`` tokens, no
  second model;
* ``ModelDraft`` — a greedy rollout of a model over a sliding window,
  through contiguous caches on the engine's device;
* ``ScriptedDraft`` — a forced accept/reject pattern against a known
  stream, for tests.

The per-row sampler and the key folds are ``serve.sampling``'s
(``per_row_sampler`` is its ``sampler``). ``rechoose_k`` feeds a measured
accept rate back into the speculation cost model
(``core.autotune.choose_spec_k``): the engine's adaptive width.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.configs import ModelConfig
from repro_torch.dist import sharding
from repro_torch.models import transformer as T
from repro_torch.serve.sampling import (fold_row_keys, fold_span_keys,
                                        sampler)

per_row_sampler = sampler

__all__ = ["NgramDraft", "ModelDraft", "ScriptedDraft", "longest_accept",
           "rechoose_k", "resolve_draft", "per_row_sampler",
           "fold_row_keys", "fold_span_keys"]


def longest_accept(drafts: Sequence[int],
                   targets: Sequence[int]) -> Tuple[int, List[int]]:
    """Exact-match acceptance: ``drafts`` are the k proposed tokens,
    ``targets`` the k + 1 verify picks (``targets[j]`` follows the context
    and ``drafts[:j]``). Returns (accepted, emitted): the accepted prefix
    plus ``targets[accepted]``, at least one token."""
    a = 0
    while a < len(drafts) and int(drafts[a]) == int(targets[a]):
        a += 1
    return a, [int(t) for t in drafts[:a]] + [int(targets[a])]


def rechoose_k(cfg: ModelConfig, page_size: int, lengths,
               accept_rate: float, k_max: int,
               in_bytes: Optional[int] = None,
               constants=None) -> Tuple[int, dict]:
    """The draft width for a *measured* accept rate: the engine measures
    accepted / proposed over a window of verify ticks and re-prices the
    width against its slots' current lengths here, candidates 1..k_max
    (the verify step's width is k_max + 1). 0 when no width beats plain
    decode, the regime a collapsed accept rate lands in. ``in_bytes``
    defaults to the model's compute type (the reference prices 4)."""
    from repro_torch.core import autotune

    if in_bytes is None:
        in_bytes = cfg.dtype.itemsize
    param_bytes = float(T.active_param_count(cfg)) * in_bytes
    k, terms = autotune.choose_spec_k(
        [int(n) for n in lengths], cfg.n_heads, cfg.n_kv_heads, cfg.dhead,
        page_size, float(accept_rate), param_bytes,
        ks=tuple(range(1, k_max + 1)), in_bytes=in_bytes,
        constants=constants)
    return min(k, k_max), terms


@dataclasses.dataclass
class NgramDraft:
    """Prompt-lookup drafting: the k tokens that followed the most recent
    earlier occurrence of the history's trailing ``n``-gram, backing off
    to shorter n-grams down to ``min_n``; nothing when the history never
    repeats. Only the trailing ``window`` tokens are scanned, so the host
    work per tick does not grow with the context."""

    n: int = 3
    min_n: int = 1
    window: int = 1024

    def propose(self, history: np.ndarray, k: int) -> np.ndarray:
        h = np.asarray(history, np.int32).ravel()[-self.window:]
        length = len(h)
        for n in range(min(self.n, length - 1), self.min_n - 1, -1):
            pat = h[length - n:]
            windows = np.lib.stride_tricks.sliding_window_view(h, n)
            hits = np.nonzero((windows == pat).all(axis=1))[0]
            hits = hits[hits < length - n]      # not the query itself
            if not hits.size:
                continue
            # The most recent hit with k whole continuation tokens; else
            # the tail repeats a short cycle, extended cyclically to k.
            full = hits[hits + n + k <= length]
            start = int(full[-1] if full.size else hits[-1]) + n
            cont = h[start:start + k]
            if len(cont) < k:
                cycle = h[start:]
                cont = np.tile(cycle, -(-k // len(cycle)))[:k]
            return cont
        return np.zeros((0,), np.int32)


class ModelDraft:
    """Greedy k-token rollout of a model over the history's last
    ``window`` tokens: the window, right-padded, prefilled into fresh
    batch-1 contiguous caches of ``window + k`` rows on ``device`` (by
    default the weights' device), the write position set to the window's
    true length, then k - 1 one-token steps (each through
    ``kernels.ops.flash_decode``). Positions are
    window-relative, which only the proposals see: the verify keeps the
    stream exact."""

    def __init__(self, params, cfg: ModelConfig, window: int = 32,
                 device=None):
        if window < 1:
            raise ValueError(f"window {window} < 1")
        self.params, self.cfg, self.window = params, cfg, window
        self.device = resolve_device(
            params["embed"]["embedding"].device if device is None
            else device)

    @torch.no_grad()
    def propose(self, history: np.ndarray, k: int) -> np.ndarray:
        # Whole weights on one rank: never the serving mesh's sharded
        # layers, even when an engine on a mesh asks.
        with sharding.use_ruleset(None):
            return self._propose(history, k)

    def _propose(self, history: np.ndarray, k: int) -> np.ndarray:
        h = np.asarray(history, np.int64).ravel()
        n = min(len(h), self.window)
        if n == 0 or k == 0:
            return np.zeros((0,), np.int32)
        tokens = np.zeros((1, self.window), np.int64)
        tokens[0, :n] = h[len(h) - n:]
        caches = T.init_caches(self.cfg, 1, self.window + k,
                               per_slot_index=True, device=self.device)
        logits, caches = T.forward(self.params, self.cfg,
                                   torch.from_numpy(tokens).to(self.device),
                                   caches=caches)
        # Padded rows sit at positions >= n: the write position masks them.
        caches = T.set_cache_lengths(caches, n)
        tok = logits[0, n - 1].argmax(-1)
        out = [tok]
        for _ in range(k - 1):
            logits, caches = T.forward(self.params, self.cfg,
                                       tok.reshape(1, 1), caches=caches)
            tok = logits[0, -1].argmax(-1)
            out.append(tok)
        return torch.stack(out).cpu().numpy().astype(np.int32)


class ScriptedDraft:
    """Forced accept/reject pattern (tests): at emitted position t it
    proposes the true token of ``stream`` when ``pattern[t % len]`` is
    truthy, a wrong one otherwise. Position = len(history) -
    ``prompt_len``, so it serves one request and reads its full history."""

    def __init__(self, prompt_len: int, stream: Sequence[int],
                 pattern: Sequence[int], vocab: int):
        if not pattern:
            raise ValueError("empty pattern")
        self.prompt_len = prompt_len
        self.stream = np.asarray(stream, np.int32)
        self.pattern = [bool(p) for p in pattern]
        self.vocab = vocab

    def propose(self, history: np.ndarray, k: int) -> np.ndarray:
        pos = len(np.asarray(history).ravel()) - self.prompt_len
        out = []
        for t in range(pos, min(pos + k, len(self.stream))):
            tok = int(self.stream[t])
            if not self.pattern[t % len(self.pattern)]:
                tok = (tok + 1) % self.vocab
            out.append(tok)
        return np.asarray(out, np.int32)


def resolve_draft(draft: Any, cfg: ModelConfig, params,
                  device=None) -> Any:
    """``ServeConfig.draft`` -> a draft source: ``None`` or ``"ngram"``
    (``NgramDraft``), ``"self"`` (``ModelDraft`` of the target itself),
    an arch name among the port's configs (a ``ModelDraft`` of that arch
    with random weights from a generator seeded 0: its smoke config, or
    its full one when the smoke vocabulary cannot cover the target's), or
    an object with ``propose``."""
    if draft is None:
        draft = "ngram"
    if not isinstance(draft, str):
        if not callable(getattr(draft, "propose", None)):
            raise TypeError(f"draft {draft!r} has no propose()")
        return draft
    if draft == "ngram":
        return NgramDraft()
    if draft == "self":
        return ModelDraft(params, cfg, device=device)
    dcfg = configs.get_smoke(draft)
    if dcfg.vocab < cfg.vocab:
        dcfg = configs.get_config(draft)
    if dcfg.vocab < cfg.vocab:
        raise ValueError(f"draft vocabulary {dcfg.vocab} does not cover "
                         f"the target's {cfg.vocab}")
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    return ModelDraft(T.init_params(dcfg, gen, device=device), dcfg,
                      device=device)
