"""Continuous-batching serving engine (port of ``repro/serve/engine.py``:
its contiguous mode, its paged core, and the module-level generation loop).

Requests join free slots; each ``tick`` admits, runs prefill, and runs one
batched decode step for every decode-active slot. Two cache layouts:

* **Contiguous** (``ServeConfig(paged=False)``, the default, as in the
  reference): every slot owns ``max_len`` rows of K/V (and its Mamba
  state). Admission prefills one whole prompt per free slot per tick:
  attention stacks pad the prompt to a power-of-two bucket
  (``bucket_for``), SSM stacks prefill at exact length; the prompt runs
  through a fresh batch-1 row cache, which is then installed in the slot.
* **Paged** (``paged=True``): K/V rows live in a shared page pool.

  - **Admission** reserves only the first chunk's pages and leaves
    headroom for what already-admitted slots take this tick; a short pool
    holds the request (it stays queued) instead of failing. A request
    that could not fit even an empty pool raises ``PagePoolExhausted``.
  - **Chunked prefill** writes a prompt in place through the page table,
    ``chunk_size`` rows at a time, on a batch-1 view of the pools.
  - **Preemption**: a pool that runs short evicts a victim slot (least
    progress first, youngest on ties); its pages return to the pool and
    the request re-queues at the head with its generated tokens, which
    are prefilled again as prompt on re-admission.

The page table and the per-slot write positions live on the host (numpy)
and are sent to the device with each step: every change to them is a host
decision, so the engine never reads them back. Decoding is greedy; sampled
decoding (``temperature > 0``) is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.serve import paged as paged_mod

# The reference's default ``ServeConfig.preempt_cooldown``: a slot
# re-admitted within this many ticks ranks behind its peers as a victim.
PREEMPT_COOLDOWN = 2


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_len: int
    batch: int
    temperature: float = 0.0     # only 0 (greedy) is ported
    eos_id: int = 1
    min_bucket: int = 8          # smallest prefill bucket (power of two)
    paged: bool = False          # K/V rows from a shared page pool
    page_size: int = 16          # rows per page (paged)
    n_pages: Optional[int] = None  # pool incl. null page (paged); None ->
    # the contiguous equivalent, 1 + batch * max_len / page_size
    chunk_size: Optional[int] = None  # prefill chunk rows (paged; a
    # page_size multiple). The reference's None (an autotuned choice) is
    # not ported: paged mode requires it.


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    preempt_count: int = 0       # times evicted back to the queue
    readmitted_at: Optional[int] = None  # tick of the last re-admission


@torch.no_grad()
def prefill(params, cfg: ModelConfig, tokens, caches):
    """Run the prompt through the model, filling the caches. Returns the
    last position's logits and the new caches."""
    logits, caches = T.forward(params, cfg, tokens, caches=caches)
    return logits[:, -1], caches


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, last_tokens, caches):
    """One decode step: (b,) token ids -> (b, vocab) logits + new caches."""
    logits, caches = T.forward(params, cfg, last_tokens[:, None],
                               caches=caches)
    return logits[:, -1], caches


def make_serve_step(cfg: ModelConfig, temperature: float = 0.0) -> Callable:
    """The greedy decode step as a plain function (the reference jits it):
    ``step(params, last_tokens, caches) -> (next ids, new caches)``."""
    if temperature > 0:
        raise NotImplementedError(
            "sampled decoding is not ported; use temperature=0")

    def step(params, last_tokens, caches):
        logits, caches = decode_step(params, cfg, last_tokens, caches)
        return logits.argmax(-1), caches

    return step


@torch.no_grad()
def greedy_generate(params, cfg: ModelConfig, prompt: torch.Tensor,
                    max_new: int, max_len: Optional[int] = None):
    """The generation loop the engines are compared with: prompt (b, s)
    on the model's device -> (b, max_new) greedy ids, through contiguous
    caches with one position shared by every row."""
    b, s = prompt.shape
    max_len = max_len or (s + max_new)
    caches = T.init_caches(cfg, b, max_len, device=prompt.device)
    logits, caches = prefill(params, cfg, prompt, caches)
    tok = logits.argmax(-1)
    out = [tok]
    step = make_serve_step(cfg)
    for _ in range(max_new - 1):
        tok, caches = step(params, tok, caches)
        out.append(tok)
    return torch.stack(out, dim=1)


class ServingEngine:
    """Slot-based continuous batching over a fixed decode batch."""

    def __init__(self, params, cfg: ModelConfig, serve_cfg: ServeConfig,
                 device=None):
        self.device = resolve_device(device)
        if serve_cfg.temperature > 0:
            raise NotImplementedError(
                "sampled decoding is not ported; use temperature=0")
        self.cfg, self.scfg, self.params = cfg, serve_cfg, params
        self._step = make_serve_step(cfg)
        max_len = serve_cfg.max_len
        # Bucketing pads the prompt on the right, which only attention
        # layers mask; SSM stacks carry state through every position, so
        # they prefill at exact length.
        self._bucketed = all(k == "attn" for k in cfg.pattern)
        if serve_cfg.paged:
            if not self._bucketed:
                raise ValueError("paged serving needs an attention-only "
                                 f"stack, not {cfg.pattern}")
            ps, chunk = serve_cfg.page_size, serve_cfg.chunk_size
            if chunk is None:
                raise NotImplementedError(
                    "chunk_size=None (an autotuned chunk) is not ported; "
                    "pass a chunk size")
            if max_len % ps:
                raise ValueError(f"max_len {max_len} is not a multiple of "
                                 f"page_size {ps}")
            if chunk % ps or not 0 < chunk <= max_len:
                raise ValueError(f"chunk_size {chunk} must be a page_size "
                                 f"multiple in (0, max_len]")
            self.chunk: Optional[int] = chunk
            n_pages = serve_cfg.n_pages or 1 + serve_cfg.batch * max_len // ps
            self.pool: Optional[paged_mod.PageAllocator] = \
                paged_mod.PageAllocator(n_pages, ps)
            self.caches = T.init_paged_caches(cfg, serve_cfg.batch, max_len,
                                              ps, n_pages, device=self.device)
            self.max_pages = max_len // ps
        else:
            self.chunk = None
            self.pool = None
            self.caches = T.init_caches(cfg, serve_cfg.batch, max_len,
                                        per_slot_index=True,
                                        device=self.device)
            self.max_pages = 0
        # Host copies of the page table and the write positions.
        self.pages = np.zeros((serve_cfg.batch, self.max_pages), np.int32)
        self.index = np.zeros((serve_cfg.batch,), np.int32)
        self.last_tok = np.zeros((serve_cfg.batch,), np.int64)
        self.slots: List[Optional[Request]] = [None] * serve_cfg.batch
        self.queue: List[Request] = []
        self.finished: Dict[int, List[int]] = {}
        self.outcome: Dict[int, str] = {}
        self.ticks = 0
        self._prefilling: Dict[int, int] = {}   # slot -> prompt rows written
        self._slot_seq: Dict[int, int] = {}     # slot -> admission sequence
        self._admit_seq = 0
        self.preemptions = 0
        self.admission_rejections = 0
        self.chunk_steps = 0
        self.decode_steps = 0
        self.prefill_buckets: Dict[int, int] = {}  # bucket -> prefills run

    # -- device steps ---------------------------------------------------------

    def _step_caches(self, pages: np.ndarray, index: np.ndarray):
        """Per-layer cache views with this step's write positions (and,
        when paged, page table)."""
        i = torch.from_numpy(np.ascontiguousarray(index)).to(self.device)
        if self.pool is None:
            return [dict(c, index=i) for c in self.caches]
        p = torch.from_numpy(np.ascontiguousarray(pages)).to(self.device)
        return [dict(c, pages=p, index=i) for c in self.caches]

    @torch.no_grad()
    def _chunk_step(self, tokens: np.ndarray, start: int, slot: int,
                    last_in_chunk: int) -> torch.Tensor:
        """One ``chunk``-row slice of one slot's prompt, written in place
        through the slot's table row (a batch-1 view, write position
        ``start``). Returns the greedy token at ``last_in_chunk`` as a
        device scalar: the host reads it only after the final chunk."""
        caches = self._step_caches(self.pages[slot:slot + 1],
                                   np.asarray([start], np.int32))
        toks = torch.from_numpy(tokens).to(self.device)
        logits, _ = T.forward(self.params, self.cfg, toks, caches=caches)
        self.chunk_steps += 1
        return logits[0, last_in_chunk].argmax(-1)

    @torch.no_grad()
    def _decode_step(self) -> np.ndarray:
        """One token for every slot (free and mid-prefill slots ride
        along: their rows land in the null page, are overwritten, or are
        never attended)."""
        caches = self._step_caches(self.pages, self.index)
        toks = torch.from_numpy(self.last_tok).to(self.device)
        nxt, new_caches = self._step(self.params, toks, caches)
        if self.pool is None:
            # Mamba layers return new state tensors; K/V were written in
            # place. The host keeps the positions.
            self.caches = [{k: v for k, v in c.items() if k != "index"}
                           for c in new_caches]
        self.decode_steps += 1
        self.index += 1
        return nxt.cpu().numpy()

    def bucket_for(self, prompt_len: int) -> int:
        """Prefill length of a prompt: the smallest power-of-two multiple
        of ``min_bucket`` that holds it, capped at ``max_len``, for
        attention stacks; the exact length for SSM stacks."""
        if not self._bucketed:
            return prompt_len
        b = self.scfg.min_bucket
        while b < prompt_len:
            b *= 2
        return min(b, self.scfg.max_len)

    @torch.no_grad()
    def _prefill_into_slot(self, prompt: np.ndarray, slot: int) -> int:
        """Prefill one prompt through a fresh batch-1 row cache at its
        bucket length, install the row in ``slot`` and return the greedy
        token at the prompt's last position. The padded rows past the
        prompt sit at positions >= its length, which the slot's write
        position masks out and decode overwrites."""
        true_len = len(prompt)
        bucket = self.bucket_for(true_len)
        if not true_len <= bucket <= self.scfg.max_len:
            raise ValueError(f"prompt of {true_len} rows does not fit "
                             f"max_len {self.scfg.max_len}")
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :true_len] = prompt
        row = T.init_caches(self.cfg, 1, self.scfg.max_len,
                            per_slot_index=True, device=self.device)
        logits, row = T.forward(self.params, self.cfg,
                                torch.from_numpy(padded).to(self.device),
                                caches=row)
        self.prefill_buckets[bucket] = self.prefill_buckets.get(bucket, 0) + 1
        for full, part in zip(self.caches, row):
            for name, t in full.items():
                if name != "index":
                    t[slot].copy_(part[name][0])
        self.index[slot] = true_len
        return int(logits[0, true_len - 1].argmax(-1))

    # -- page-table plumbing --------------------------------------------------

    def _append_pages(self, slot: int, pages: List[int]) -> None:
        """Extend the slot's table with freshly allocated pages (entries
        [have, have + n); live entries are never overwritten)."""
        if not pages:
            return
        have = len(self.pool.slot_pages[slot]) - len(pages)
        self.pages[slot, have:have + len(pages)] = pages

    def _pages_through_tick(self, req: Request) -> int:
        """Table entries a decode-active slot needs for this tick's write
        at position prompt + generated - 1 (writes past max_len spill to
        the null page)."""
        length = len(req.prompt) + len(req.generated) - 1
        return min(length // self.scfg.page_size + 1, self.max_pages)

    def _ensure_decode_pages(self) -> None:
        """Grow each decode-active slot's table so this tick's write lands
        in a real page; a short pool preempts another slot, and a pool
        with nothing left to preempt raises ``PagePoolExhausted``."""
        for i, slot in enumerate(self.slots):
            if slot is None or i in self._prefilling:
                continue
            target = self._pages_through_tick(slot)
            while len(self.pool.slot_pages.get(i, ())) < target:
                if not self._preempt_for(1, protect={i}):
                    raise paged_mod.PagePoolExhausted(
                        f"slot {i} needs a decode page and no other slot "
                        f"is left to preempt; raise n_pages")
                self._append_pages(i, self.pool.alloc(i, 1))

    # -- preemption -----------------------------------------------------------

    def _choose_victim(self, victims: List[int]) -> int:
        """The slot with the least completion progress loses; a slot
        re-admitted within ``PREEMPT_COOLDOWN`` ticks ranks behind its
        peers; ties go to the youngest admission."""
        def score(i):
            req = self.slots[i]
            ra = req.readmitted_at
            cooling = ra is not None and self.ticks - ra < PREEMPT_COOLDOWN
            done = len(req.generated) / max(1, req.max_new)
            return (cooling, done, -self._slot_seq[i])

        return min(victims, key=score)

    def _preempt_for(self, need: int, protect: set) -> bool:
        """Preempt slots outside ``protect`` until ``need`` pages are
        free. False when no victim is left."""
        while not self.pool.can_alloc(need):
            victims = [i for i, s in enumerate(self.slots)
                       if s is not None and i not in protect]
            if not victims:
                return False
            self._preempt(self._choose_victim(victims))
        return True

    def _finish(self, req: Request, outcome: str) -> None:
        req.done = True
        self.finished[req.rid] = req.generated
        self.outcome[req.rid] = outcome

    def _preempt(self, i: int) -> None:
        """Evict slot ``i``: pages back to the pool, the request back to
        the head of the queue with its generated tokens. A context that
        already reaches max_len has nothing left to re-prefill: it
        finishes with what it generated."""
        req = self.slots[i]
        self.free_slot(i)
        self.last_tok[i] = 0
        if len(req.prompt) + len(req.generated) >= self.scfg.max_len:
            self._finish(req, "forced:max_len")
            return
        self.preemptions += 1
        req.preempt_count += 1
        self.queue.insert(0, req)

    # -- request lifecycle ----------------------------------------------------

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    @staticmethod
    def _effective_prompt(req: Request) -> np.ndarray:
        """Rows a (re-)admission prefills: prompt + tokens generated
        before a preemption."""
        prompt = np.asarray(req.prompt, np.int32)
        if req.generated:
            prompt = np.concatenate(
                [prompt, np.asarray(req.generated, np.int32)])
        return prompt

    @staticmethod
    def _effective_len(req: Request) -> int:
        return len(req.prompt) + len(req.generated)

    def _record(self, i: int, req: Request, tok: int) -> bool:
        """Append ``tok``; finish and free the slot on EOS or max_new."""
        req.generated.append(tok)
        if tok == self.scfg.eos_id or len(req.generated) >= req.max_new:
            self._finish(req, "done")
            self.free_slot(i)
            return True
        return False

    def free_slot(self, i: int) -> None:
        """Release slot ``i``: its write position zeroed (decode stops
        reading the dead context) and, when paged, its pages back to the
        pool and its table row zeroed, so its drifting writes land in the
        null page."""
        self.slots[i] = None
        self._prefilling.pop(i, None)
        self._slot_seq.pop(i, None)
        self.index[i] = 0
        if self.pool is not None:
            self.pool.free_slot(i)
            self.pages[i] = 0

    def _imminent_page_need(self) -> int:
        """Pages admitted slots take this tick: decode growth for
        decode-active slots, the next chunk for mid-prefill ones."""
        ps, max_len = self.scfg.page_size, self.scfg.max_len
        total = 0
        for i, slot in enumerate(self.slots):
            if slot is None:
                continue
            have = len(self.pool.slot_pages.get(i, ()))
            if i in self._prefilling:
                cursor = self._prefilling[i]
                total += paged_mod.chunk_page_need(
                    cursor, min(self.chunk, self._effective_len(slot) - cursor),
                    have, ps, max_len)
            else:
                total += max(0, self._pages_through_tick(slot) - have)
        return total

    def _admit(self) -> None:
        if self.pool is None:
            self._admit_whole()
            return
        ps, max_len = self.scfg.page_size, self.scfg.max_len
        for i, slot in enumerate(self.slots):
            if slot is not None or not self.queue:
                continue
            req = self.queue[0]
            plen = self._effective_len(req)
            if plen > max_len:
                raise ValueError(f"request {req.rid}: {plen} rows > "
                                 f"max_len {max_len}")
            # Whole prompt plus its first decode write: a request that
            # cannot fit the empty pool could never finish.
            with_decode = paged_mod.pages_for(min(plen + 1, max_len), ps)
            if with_decode > self.pool.capacity:
                raise paged_mod.PagePoolExhausted(
                    f"request {req.rid}: needs {with_decode} pages but the "
                    f"pool holds {self.pool.capacity}; raise n_pages or "
                    f"page_size")
            first = paged_mod.chunk_page_need(0, min(self.chunk, plen), 0,
                                              ps, max_len)
            if not self.pool.can_alloc(first + self._imminent_page_need()):
                self.admission_rejections += 1
                return                # hold: everyone waits for pages
            self.queue.pop(0)
            self.slots[i] = req
            if req.preempt_count:
                req.readmitted_at = self.ticks
            self._prefilling[i] = 0
            self._slot_seq[i] = self._admit_seq
            self._admit_seq += 1
            self._append_pages(i, self.pool.alloc(i, first))

    def _admit_whole(self) -> None:
        """Contiguous admission: the queue's head goes to each free slot,
        its whole prompt prefilled and installed now and its first token
        recorded (a request that finishes on it leaves the slot free until
        the next tick)."""
        for i, slot in enumerate(self.slots):
            if slot is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            tok = self._prefill_into_slot(self._effective_prompt(req), i)
            self.slots[i] = req
            self._slot_seq[i] = self._admit_seq
            self._admit_seq += 1
            if not self._record(i, req, tok):
                self.last_tok[i] = tok

    def _prefill_order(self) -> List[int]:
        """Mid-prefill slots, fewest chunks left first (admission order
        breaks ties)."""
        def key(i):
            remaining = -(-(self._effective_len(self.slots[i])
                            - self._prefilling[i]) // self.chunk)
            return (remaining, self._slot_seq[i])

        return sorted(self._prefilling, key=key)

    def _prefill_tick(self) -> None:
        """One chunk for every mid-prefill slot. Each chunk's pages are
        allocated right before it; a short pool preempts another slot or,
        with none left, stalls this slot for the tick."""
        ps, max_len = self.scfg.page_size, self.scfg.max_len
        for i in self._prefill_order():
            if i not in self._prefilling:      # preempted by an earlier
                continue                       # slot's chunk this tick
            req = self.slots[i]
            cursor = self._prefilling[i]
            prompt = self._effective_prompt(req)
            true_len = len(prompt)
            n = min(self.chunk, true_len - cursor)
            need = paged_mod.chunk_page_need(
                cursor, n, len(self.pool.slot_pages.get(i, ())), ps, max_len)
            if need:
                if not self._preempt_for(need, protect={i}):
                    continue                   # stalled, retry next tick
                self._append_pages(i, self.pool.alloc(i, need))
            chunk_toks = np.zeros((1, self.chunk), np.int64)
            chunk_toks[0, :n] = prompt[cursor:cursor + n]
            end = cursor + n
            # A padded final chunk: the sampled row is the prompt's last
            # token, and the write position resets to `end` so the padded
            # rows are never attended.
            last_in = (true_len - 1 - cursor) if end == true_len else n - 1
            tok = self._chunk_step(chunk_toks, cursor, i, last_in)
            self.index[i] = end
            if end < true_len:
                self._prefilling[i] = end
                continue
            del self._prefilling[i]            # prefill complete
            tok = int(tok)
            if not self._record(i, req, tok):
                self.last_tok[i] = tok

    def _decode_tick(self, active: List[int]) -> None:
        nxt = self._decode_step()
        active_set = set(active)
        for i in range(self.scfg.batch):
            if i in active_set:
                if not self._record(i, self.slots[i], int(nxt[i])):
                    continue
            # Freed or empty slot: feed back 0 so stale output never
            # aliases eos_id.
            nxt[i] = 0
        self.last_tok = nxt.astype(np.int64)

    def _reset_prefill_positions(self) -> None:
        """The decode step advanced every slot's write position and wrote
        a garbage row at each mid-prefill slot's cursor (the next chunk
        overwrites it); put their positions back."""
        for i, cursor in self._prefilling.items():
            self.index[i] = cursor

    @torch.no_grad()
    def tick(self) -> int:
        """Admit, advance prefill chunks (paged), one decode step for the
        decode-active slots; returns the number of slots making progress."""
        self.ticks += 1
        self._admit()
        if self.pool is not None:
            self._prefill_tick()
            self._ensure_decode_pages()
        active = [i for i, s in enumerate(self.slots)
                  if s is not None and i not in self._prefilling]
        if not active:
            return len(self._prefilling)
        n = len(active) + len(self._prefilling)
        self._decode_tick(active)
        self._reset_prefill_positions()
        return n

    def run_until_drained(self, max_ticks: int = 10000) -> Dict[int, List[int]]:
        for _ in range(max_ticks):
            if self.tick() == 0 and not self.queue:
                break
        return self.finished
