"""Whether what the timed path served is right: a sample of the requests
the window finished, drawn from the run's seed with the one that served
the most tokens in it, is run through the plain reference
(``reference/<name>.py``, named by the config file), teacher-forced on
each prompt and its served tokens. At every served position the gap is
how far the served token's reference logit lies below the reference's
best; the number compared is the widest gap. Greedy decoding serves the
best token of the program's own logits, so only a token that the
program's arithmetic got wrong lies far below.

``control_gaps`` reads the same positions for the control: the reference
in fp8 put in the program's place, the gap of the token it puts first.
"""

from __future__ import annotations

import importlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

Served = Tuple[int, np.ndarray, Sequence[int]]     # rid, prompt, tokens


def sample(finished: List[Served], seed: int, min_tokens: int
           ) -> List[Served]:
    """The request that served the most tokens (the lowest rid on ties),
    then others in an order drawn from ``seed`` until the sample holds
    ``min_tokens`` served tokens or every request."""
    if not finished:
        return []
    ordered = sorted(finished, key=lambda r: r[0])
    longest = max(ordered, key=lambda r: len(r[2]))
    rest = [r for r in ordered if r[0] != longest[0]]
    order = np.random.default_rng([int(seed), 0x7D6E]).permutation(len(rest))
    out, n = [longest], len(longest[2])
    for i in order:
        if n >= min_tokens:
            break
        out.append(rest[int(i)])
        n += len(rest[int(i)][2])
    return out


def reference(cfg: dict):
    """The reference module the config file names (``reference``)."""
    return importlib.import_module(f"portbench.reference.{cfg['reference']}")


def _inputs(sampled: List[Served], device):
    """Each request's teacher-forced sequence (prompt and every served
    token but the last) and the position its first token is read at."""
    seqs, starts = [], []
    for _, prompt, toks in sampled:
        seq = np.concatenate([np.asarray(prompt, np.int64),
                              np.asarray(list(toks)[:-1], np.int64)])
        seqs.append(torch.from_numpy(seq).to(device))
        starts.append(len(prompt) - 1)
    return seqs, starts


def _gaps(logits: torch.Tensor, picks: torch.Tensor) -> torch.Tensor:
    return logits.max(dim=-1).values - logits.gather(
        1, picks[:, None]).squeeze(1)


@torch.no_grad()
def served_gaps(weights: dict, cfg: dict, sampled: List[Served], device
                ) -> torch.Tensor:
    """The gap of every served token of the sample, in request order."""
    seqs, starts = _inputs(sampled, device)
    out = []
    for logits, (_, _, toks) in zip(
            reference(cfg).logits(weights, cfg, seqs, starts), sampled):
        picks = torch.as_tensor(list(toks), dtype=torch.int64, device=device)
        out.append(_gaps(logits, picks).cpu())
    return torch.cat(out) if out else torch.zeros(0)


@torch.no_grad()
def control_gaps(weights: dict, cfg: dict, sampled: List[Served], device,
                 quant=None) -> torch.Tensor:
    """The gap, under the fp32 reference, of the token the control (the
    reference with every product's inputs in fp8) puts first at each
    served position."""
    ref = reference(cfg)
    seqs, starts = _inputs(sampled, device)
    exact = ref.logits(weights, cfg, seqs, starts)
    low = ref.logits(weights, cfg, seqs, starts, quant=quant or ref.fp8)
    return torch.cat([_gaps(e, lo.argmax(-1)).cpu()
                      for e, lo in zip(exact, low)])


def verdict(gaps: torch.Tensor, limit: Optional[float]) -> Dict[str, object]:
    """The number compared (the widest gap) beside its limit; with no
    served token to judge there is no number, and the run is not
    correct."""
    widest = float(gaps.max()) if gaps.numel() else None
    ok = limit is not None and widest is not None and widest <= limit
    return {"max_gap": widest, "limit": limit, "tokens": int(gaps.numel()),
            "correct": bool(ok)}
