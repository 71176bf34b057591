"""Rank functions for ``tests/test_torch_attn_knobs.py``: each runs in a
process that ``repro_torch.launch.mesh.run_ranks`` spawned and joined to
a gloo group, and returns plain Python values. This module imports
neither JAX nor the reference."""

import dataclasses

from repro_torch import configs
from repro_torch.bridge import params_from_jax
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import layers
from repro_torch.serve.engine import Request, ServeConfig, ServingEngine

import _torch_model_axis_workers as axis_workers


def serve_streams(np_params, fields, prompts, max_new, mesh=None):
    """The qwen3-4b smoke paged engine (``fields`` replaced in its
    config), on ``mesh`` or one device: its greedy streams. On a mesh its
    chunks (s > 1) attend through the masked plain ``sdpa`` of the
    sharded pool and its decode steps through ``flash_decode``; on one
    device through the paged kernels."""
    cfg = dataclasses.replace(configs.get_smoke("qwen3-4b"), **fields)
    params = params_from_jax(np_params, cfg, device="cpu")
    eng = ServingEngine(params, cfg, ServeConfig(
        paged=True, page_size=4, chunk_size=4, max_len=32, batch=2),
        device="cpu", mesh=mesh)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p.copy(), max_new=max_new))
    while eng.queue or any(s is not None for s in eng.slots):
        eng.tick()
    return {k: list(v) for k, v in eng.finished.items()}


def knob_group(rank, world, grad_cases, serve):
    """Every train-step case of ``grad_cases`` (``model_axis_cases``) and
    the serving case ``serve`` (np_params, fields, prompts, max_new) on
    this rank, with ``layers.sdpa`` wrapped to record the flags each
    call received: (expand_kv, probs_fp32) pairs, per part."""
    real = layers.sdpa
    seen = []

    def recording(q, k, v, mask=None, expand_kv=False, probs_fp32=True):
        seen.append((expand_kv, probs_fp32))
        return real(q, k, v, mask=mask, expand_kv=expand_kv,
                    probs_fp32=probs_fp32)

    layers.sdpa = recording
    try:
        grads = axis_workers.model_axis_cases(rank, world, grad_cases)
        train_flags = sorted(set(seen))
        seen.clear()
        streams = serve_streams(*serve, mesh=mesh_lib.make_serving_mesh())
        serve_flags = sorted(set(seen))
    finally:
        layers.sdpa = real
    return {"grads": grads, "train_flags": train_flags,
            "streams": streams, "serve_flags": serve_flags}
