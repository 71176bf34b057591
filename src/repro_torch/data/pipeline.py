"""Deterministic, sharded, resumable synthetic LM data pipeline.

Port of ``repro/data/pipeline.py``: numpy only, so its batches are
bit-equal to the reference's. Design goals:
  * **Determinism**: batch(step, dp_rank) is a pure function of the seed —
    restarts and elastic re-sharding reproduce the exact token stream.
  * **Shardability**: each data-parallel rank draws only its slice; global
    batch order is invariant to the number of ranks.
  * **Resumability**: pipeline state is one integer (the step), carried in
    the checkpoint manifest.
  * **Prefetch**: a background thread keeps ``prefetch`` batches ready.

Tokens follow a Zipf-like distribution (realistic softmax pressure) with a
parity-markov structure so tiny models can measurably learn (loss decreases
— asserted by integration tests).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3


class SyntheticLMData:
    def __init__(self, cfg: DataConfig, dp_rank: int = 0, dp_size: int = 1,
                 start_step: int = 0, prefetch: int = 2):
        if cfg.global_batch % dp_size:
            raise ValueError(f"global batch {cfg.global_batch} is not a "
                             f"multiple of dp_size {dp_size}")
        self.cfg = cfg
        self.dp_rank = dp_rank
        self.dp_size = dp_size
        self.step = start_step
        self._local_batch = cfg.global_batch // dp_size
        # Zipf-ish unigram distribution, fixed by seed.
        rng = np.random.RandomState(cfg.seed)
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_a)
        self._probs = probs / probs.sum()
        self._queue: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- pure batch function --------------------------------------------------
    def batch_at(self, step: int) -> Tuple[np.ndarray, np.ndarray]:
        """(tokens, labels) for this rank at ``step`` — pure in (seed, step,
        rank); independent of dp_size re-partitioning at the sample level."""
        cfg = self.cfg
        tokens = np.empty((self._local_batch, cfg.seq_len + 1), np.int32)
        for i in range(self._local_batch):
            sample = self.dp_rank * self._local_batch + i
            rng = np.random.RandomState(
                (cfg.seed * 1_000_003 + step * 1009 + sample) % (2 ** 31))
            row = rng.choice(cfg.vocab, size=cfg.seq_len + 1, p=self._probs)
            # Inject learnable structure: token t+1 repeats token t on a
            # fixed schedule, so models beat the unigram entropy.
            mask = (np.arange(cfg.seq_len + 1) % 4) == 3
            row[mask] = row[np.maximum(np.arange(cfg.seq_len + 1) - 1, 0)][mask]
            tokens[i] = row
        return tokens[:, :-1], tokens[:, 1:]

    # -- iteration + prefetch --------------------------------------------------
    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        return self

    def __next__(self):
        b = self.batch_at(self.step)
        self.step += 1
        return b

    def start_prefetch(self):
        if self._thread is not None:
            return

        def worker():
            step = self.step
            while not self._stop.is_set():
                try:
                    self._queue.put((step, self.batch_at(step)), timeout=0.2)
                    step += 1
                except queue.Full:
                    continue

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def next_prefetched(self):
        step, batch = self._queue.get()
        self.step = step + 1
        return batch

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    # -- checkpointable state --------------------------------------------------
    def state_dict(self) -> dict:
        return {"step": self.step, "seed": self.cfg.seed}

    def load_state_dict(self, state: dict):
        if state["seed"] != self.cfg.seed:
            raise ValueError(f"data seed mismatch: checkpoint "
                             f"{state['seed']}, pipeline {self.cfg.seed}")
        self.step = int(state["step"])
