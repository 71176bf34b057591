"""Rank functions for ``tests/test_torch_dist_serve.py``: each runs in a
process that ``repro_torch.launch.mesh.run_ranks`` spawned and joined to
a gloo group, and returns plain Python values. This module imports
neither JAX nor the reference, so a spawned rank starts quickly."""

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.bridge import params_from_jax
from repro_torch.dist import collective_matmul as cm
from repro_torch.launch import mesh as mesh_lib
from repro_torch.serve import dist as serve_dist
from repro_torch.serve import paged
from repro_torch.serve.engine import Request, ServeConfig, ServingEngine


def primitives(rank, world):
    """The page scatter and gather, the page copy, the dim gather and the
    ring matmuls against their one-rank results; returns the checks that
    ran."""
    mesh = mesh_lib.make_serving_mesh(world)
    rng = np.random.RandomState(0)
    done = []
    # A pool of 4 pages a rank, written through a table that spans ranks.
    n_pages, ps, kvh, hd, b = 4 * world, 4, 2, 8, 3
    full = torch.from_numpy(rng.randn(n_pages, ps, kvh, hd).astype(
        np.float32))
    fullv = full * 2 + 1
    block = n_pages // world
    kp = full[rank * block:(rank + 1) * block].clone()
    vp = fullv[rank * block:(rank + 1) * block].clone()
    pages = torch.from_numpy(rng.permutation(n_pages)[:b * 2].reshape(
        b, 2).astype(np.int32))
    ck, cv = serve_dist.gather_pages(kp, vp, pages, mesh, "model")
    want_k, want_v = paged.gather_kv(full, fullv, pages)
    assert torch.equal(ck, want_k) and torch.equal(cv, want_v)
    done.append("gather")
    k = torch.from_numpy(rng.randn(b, 5, kvh, hd).astype(np.float32))
    page = pages[:, :1].long().expand(b, 5).contiguous()
    row = torch.arange(5)[None, :].expand(b, 5) % ps
    page = torch.where(torch.arange(5)[None, :] < ps, page,
                       pages[:, 1:2].long())
    serve_dist.scatter_pages(kp, vp, k, 2 * k, page, row, mesh, "model")
    full[page, row] = k
    fullv[page, row] = 2 * k
    assert torch.equal(kp, full[rank * block:(rank + 1) * block])
    assert torch.equal(vp, fullv[rank * block:(rank + 1) * block])
    done.append("scatter")
    caches = [{"kp": kp, "vp": vp}]
    old, new = 1, n_pages - 1                # rank 0's page to the last
    serve_dist.copy_page(caches, old, new, mesh, "model")
    full[new], fullv[new] = full[old], fullv[old]
    assert torch.equal(kp, full[rank * block:(rank + 1) * block])
    assert torch.equal(vp, fullv[rank * block:(rank + 1) * block])
    done.append("copy_page")
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(rng.randn(3, 2 * world, 5).astype(
            np.float32)).to(dtype)
        got = serve_dist.all_gather_dim(x[:, 2 * rank:2 * rank + 2], 1,
                                        mesh, "model")
        assert torch.equal(got, x)
    done.append("all_gather_dim")
    x = torch.from_numpy(rng.randn(16, 64).astype(np.float32))
    w = torch.from_numpy(rng.randn(64, 128).astype(np.float32))
    ref = x @ w
    torch.testing.assert_close(cm.ag_matmul(x, w, mesh), ref, rtol=1e-4,
                               atol=1e-4)
    nb = 128 // world
    torch.testing.assert_close(cm.rs_matmul(x, w, mesh),
                               ref[:, rank * nb:(rank + 1) * nb],
                               rtol=1e-4, atol=1e-4)
    w_odd = torch.from_numpy(rng.randn(64, 131).astype(np.float32))
    assert torch.equal(cm.rs_matmul(x, w_odd, mesh), x @ w_odd)
    x_odd = torch.from_numpy(rng.randn(16, 63).astype(np.float32))
    assert torch.equal(cm.ag_matmul(x_odd, w_odd[:63], mesh),
                       x_odd @ w_odd[:63])
    done.append("rings")
    lm = torch.from_numpy(rng.randn(64, 32 * world).astype(np.float32))
    h = torch.from_numpy(rng.randn(2, 3, 64).astype(np.float32))
    got = cm.serve_unembed(mesh)(
        {"lm_head": lm[:, 32 * rank:32 * (rank + 1)]}, h)
    torch.testing.assert_close(got, h @ lm, rtol=1e-5, atol=1e-5)
    done.append("serve_unembed")
    return done


PROMPT_LENS = (9, 13, 6, 11)


def _prompts(vocab):
    prng = np.random.RandomState(1)
    return [prng.randint(2, vocab, n).astype(np.int32) for n in PROMPT_LENS]


def shared_prompts(vocab):
    """Two equal prompts and one sharing their first two pages of 4: with
    one slot, the second hits the whole prompt (its last row re-prefills
    through a copy-on-write of the last page) and the third two pages."""
    prng = np.random.RandomState(2)
    head = prng.randint(2, vocab, 12).astype(np.int32)
    return [head, head.copy(), np.concatenate(
        [head[:8], prng.randint(2, vocab, 5).astype(np.int32)])]


def serve_scenarios(rank, world, np_params, scenarios):
    """The qwen3-4b smoke engine on a ``world``-rank mesh through each
    scenario ``(name, ServeConfig fields, requests, max_new, prompts)``
    (prompts None: ``_prompts``): its streams, the ranks a slot's pages
    spanned, and its counters."""
    cfg = configs.get_smoke("qwen3-4b")
    params = params_from_jax(np_params, cfg, device="cpu")
    mesh = mesh_lib.make_serving_mesh(world)
    out = {}
    for name, kw, n_req, max_new, prompts in scenarios:
        eng = ServingEngine(params, cfg, ServeConfig(**kw), device="cpu",
                            mesh=mesh)
        prompts = prompts or _prompts(cfg.vocab)
        for i, p in enumerate(prompts[:n_req]):
            eng.submit(Request(rid=i, prompt=p.copy(), max_new=max_new))
        spans = {}
        while eng.queue or any(s is not None for s in eng.slots):
            eng.tick()
            for rid, pages in eng.pool.slot_pages.items():
                spans.setdefault(rid, set()).update(
                    eng.pool.device_of(p) for p in pages)
        out[name] = {
            "streams": {k: list(v) for k, v in eng.finished.items()},
            "spans": {k: sorted(v) for k, v in spans.items()},
            "decode_traces": eng.decode_traces,
            "verify_traces": eng.verify_traces,
            "preemptions": eng.preemptions,
            "prefix_hits": eng.prefix_hits,
            "cow_copies": eng.cow_copies,
            "n_devices": eng.pool.n_devices,
            "capacity": eng.pool.capacity,
            "local_pages": int(eng.caches[0]["kp"].shape[0]),
        }
    return out


def mesh_lines(rank, world):
    """A 2 x 2 ("data", "model") mesh over four ranks: each rank's
    coordinates, and a sum over each axis's line of the rank ids."""
    mesh = mesh_lib.make_mesh((2, 2), ("data", "model"))
    sums = {}
    for axis in ("data", "model"):
        x = torch.tensor([float(rank)])
        dist.all_reduce(x, group=mesh.group(axis))
        sums[axis] = float(x)
    return (mesh.index("data"), mesh.index("model")), sums


def fail_on_rank_one(rank, world):
    """Rank 1 raises while the others wait for it in a collective."""
    if rank == 1:
        raise ValueError("planted failure on rank 1")
    dist.all_reduce(torch.ones(4))
    return rank


def bandwidth(rank, world):
    """``core.collectives.bandwidth_curve`` of both serving collectives at
    two small sizes; returns (kind, payload, wire bytes, measured s)."""
    from repro_torch.core import collectives

    mesh = mesh_lib.make_serving_mesh(world)
    rows = []
    for kind in ("all_reduce", "broadcast"):
        for r in collectives.bandwidth_curve(mesh, kind, "model",
                                             [4096, 65536], repeats=2):
            rows.append((r.kind, r.payload_bytes, r.wire_bytes,
                         r.measured_time_s))
    return rows
