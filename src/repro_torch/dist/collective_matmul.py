"""Collective matmuls over a mesh axis (port of
``repro/dist/collective_matmul.py``).

``ag_matmul`` and ``rs_matmul`` compute ``x @ w`` with ``x`` sharded along
its contracting dim, as rings of point-to-point transfers
(``torch.distributed.batch_isend_irecv``) in place of the all-gather or
all-reduce an SPMD lowering would use: each rank multiplies the block it
holds while the next block travels to it. Like the reference's
``shard_map`` bodies they take the *global* ``x`` on every rank and keep
this rank's column block of it (the input spec ``P(None, axis)``). A
dimension that does not divide the ranks falls back to the plain product,
replicated: the reference's divisibility rule.

``serve_unembed`` is the serving engine's logits product under the vocab
rule: ``lm_head`` stays sharded by vocab columns on each rank, each rank
computes its columns' logits, and the logits are gathered over vocab by
one ``all_reduce`` of a zero-padded tensor (``serve.dist.all_gather_dim``,
exact). The reference rings ``x`` through ``ag_matmul`` against a
gathered ``lm_head``; the port's serving path uses only ``all_reduce`` and
``broadcast``, the two collectives gloo runs on CUDA tensors, so the
rings run on CPU tensors (the tests), and on the card only once a
backend with send and receive on the device (NCCL, which needs a device
a rank) serves.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.serve import dist as serve_dist


def _peer(mesh, axis: str, idx: int) -> int:
    """The global rank at coordinate ``idx`` of this rank's ``axis`` line."""
    group = mesh.group(axis)
    idx %= mesh.shape[axis]
    return idx if group is None else dist.get_global_rank(group, idx)


def _shift(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``t`` sent one step around the ring (to coordinate i + 1); returns
    what coordinate i - 1 sent."""
    i = mesh.index(axis)
    out = torch.empty_like(t)
    ops = [dist.P2POp(dist.isend, t.contiguous(), _peer(mesh, axis, i + 1),
                      mesh.group(axis)),
           dist.P2POp(dist.irecv, out, _peer(mesh, axis, i - 1),
                      mesh.group(axis))]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def ag_matmul(x: torch.Tensor, w: torch.Tensor, mesh, axis: str = "model"
              ) -> torch.Tensor:
    """``x @ w`` with the all-gather of ``x`` replaced by a ring.

    x: (m, k), the global tensor (this rank keeps column block i of it);
    w: (k, n) replicated; returns (m, n) replicated. Rank i starts with
    block i; after s shifts it holds block (i - s) mod n, which contracts
    against rows [(i - s) kb, (i - s + 1) kb) of w. The next block's
    transfer is posted before this block's product."""
    n = int(mesh.shape[axis])
    k = x.shape[-1]
    if n == 1 or k % n:
        return x @ w
    kb = k // n
    i = mesh.index(axis)
    block = x[:, i * kb:(i + 1) * kb].contiguous()
    acc = torch.zeros((x.shape[0], w.shape[-1]),
                      dtype=torch.promote_types(x.dtype, w.dtype),
                      device=x.device)
    for s in range(n):
        src = (i - s) % n
        nxt = _shift(block, mesh, axis) if s + 1 < n else None
        acc = acc + block @ w[src * kb:(src + 1) * kb]
        if nxt is not None:
            block = nxt
    return acc


def rs_matmul(x: torch.Tensor, w: torch.Tensor, mesh, axis: str = "model"
              ) -> torch.Tensor:
    """``x @ w`` as a reduce-scatter ring, the dual of ``ag_matmul``.

    x: (m, k), the global tensor (this rank keeps column block i); w:
    (k, n) replicated; returns this rank's (m, n / ranks) block of the
    output columns, fully reduced. The partial sums travel: at step s the
    accumulator on rank i is bound for output block (i - 1 - s) mod n;
    each rank adds its ``x_block @ w_block`` for that block and passes it
    on, so after n - 1 hops rank i holds block i. Falls back to the plain
    product (replicated, all of n) when k or n does not divide."""
    ranks = int(mesh.shape[axis])
    m, k = x.shape
    n = w.shape[-1]
    if ranks == 1 or k % ranks or n % ranks:
        return x @ w
    kb, nb = k // ranks, n // ranks
    i = mesh.index(axis)
    xb = x[:, i * kb:(i + 1) * kb]
    acc = torch.zeros((m, nb), dtype=torch.promote_types(x.dtype, w.dtype),
                      device=x.device)
    for s in range(ranks):
        dest = (i - 1 - s) % ranks
        acc = acc + xb @ w[i * kb:(i + 1) * kb, dest * nb:(dest + 1) * nb]
        if s + 1 < ranks:
            acc = _shift(acc, mesh, axis)
    return acc


def serve_unembed(mesh, axis: str = "model"):
    """The serving logits product under the vocab rule:
    ``unembed_fn(unembed_params, x)`` with ``lm_head`` this rank's
    (d_model, vocab / ranks) column block; x (b, s, d_model) replicated;
    returns the whole (b, s, vocab) logits on every rank (this rank's
    columns' logits gathered over vocab, exact), so the engine's sampling
    and streams are those of one rank."""

    def unembed_fn(unembed_params, x):
        local = x @ unembed_params["lm_head"].to(x.dtype)
        return serve_dist.all_gather_dim(local, -1, mesh, axis)

    return unembed_fn
