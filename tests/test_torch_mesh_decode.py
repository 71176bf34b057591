"""The contiguous cached forward of the PyTorch port over a (data, model)
mesh, against the reference's single-device ``T.forward`` with caches.

Ranks are gloo CPU processes started by ``launch.mesh.run_ranks`` (rank
functions in ``tests/_torch_mesh_workers.py``, no JAX): one group
of 2 ranks runs every case at (data 1, model 2) and (2, 1), one of 4
ranks every case at (2, 2). Each rank holds its shard of the parameters
(``sharding.shard_tree``) and of the caches
(``T.init_caches(..., ruleset=)``: its slots, its kv heads or SSM heads,
its block of rows where ``cache_seq`` is mapped to an axis) and runs a
prefill and three decode steps under the serving ruleset. The reference
runs the same calls on one device under ``JAX_PLATFORMS=cpu``, from the
same numpy weights (``bridge.params_from_jax``; the cross-attention's
gate, zero at init, set to seeded non-zero values).

Cases, each at the three meshes: qwen3-4b smoke (2 kv heads, which
divide the model axis), qwen3-4b smoke with one kv head (replicated over
the model axis: each rank's q heads read it), mamba2-370m smoke (the conv
and SSM state split by SSM heads), jamba smoke at batch 1 with
``cache_seq`` over ``data`` (sequence-parallel attention: each rank's
block of the 16 rows, combined by log-sum-exp; the decode steps cross
the blocks' boundary), qwen3-4b smoke with ``cache_seq`` over
``model`` (the rows and the q heads split over one axis: each rank
attends every head over its rows), and llama-3.2-vision smoke with a
``cross_kv`` cut by the batch like the tokens.

Tolerance: fp32 logits within 1e-5 of the reference's largest (at least
1); every rank of a data block holds the same rows.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT

from repro_torch.kernels import ref
from repro_torch.launch import mesh as mesh_lib

import _torch_mesh_workers as workers

DEADLINE_S = 120.0
TOL = 1e-5
ARCHS = {
    "qwen3": ("qwen3-4b", {}),
    "qwen3_mqa": ("qwen3-4b", {"n_kv_heads": 1}),
    "qwen3_rows": ("qwen3-4b", {}),
    "mamba": ("mamba2-370m", {}),
    "jamba": ("jamba-v0.1-52b", {}),
    "vision": ("llama-3.2-vision-90b", {}),
}
SHAPES = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2)}
RULES = {"jamba": {"cache_seq": "data"}, "qwen3_rows": {"cache_seq": "model"}}


def _inputs(key):
    arch, fields = ARCHS[key]
    jcfg = jconfigs.get_smoke(arch)
    jcfg = jcfg.__class__(**{**jcfg.__dict__, **fields,
                             "compute_dtype": "float32"})
    rng = np.random.RandomState(3)
    b = 1 if key == "jamba" else 2
    prompt = rng.randint(0, jcfg.vocab, (b, 6)).astype(np.int32)
    steps = [rng.randint(0, jcfg.vocab, (b,)).astype(np.int32)
             for _ in range(3)]
    frontend = None
    if jcfg.n_frontend_tokens:
        frontend = rng.randn(b, jcfg.n_frontend_tokens,
                             jcfg.d_model).astype(np.float32)
    return jcfg, prompt, steps, frontend


def _params(jcfg):
    rng = np.random.RandomState(1)

    def leaf(path, a):
        a = np.array(a)
        if getattr(path[-1], "key", None) == "gate":
            return np.asarray(0.5 + 0.1 * rng.randn(*a.shape), np.float32)
        return a

    return jax.tree_util.tree_map_with_path(
        leaf, JT.init_params(jax.random.PRNGKey(0), jcfg))


def _reference(jcfg, params, prompt, steps, frontend, max_len):
    caches = JT.init_caches(jcfg, prompt.shape[0], max_len)
    fe = None if frontend is None else jnp.asarray(frontend)
    fwd = jax.jit(lambda p, t, c: JT.forward(p, jcfg, t, caches=c,
                                             frontend_embeds=fe)[:2])
    p = jax.tree.map(jnp.asarray, params)
    logits, caches = fwd(p, jnp.asarray(prompt), caches)
    out = [np.asarray(logits)]
    for tok in steps:
        logits, caches = fwd(p, jnp.asarray(tok)[:, None], caches)
        out.append(np.asarray(logits))
    return out


@pytest.fixture(scope="module")
def runs():
    cases, want, params = {}, {}, {}
    for key, (arch, fields) in ARCHS.items():
        jcfg, prompt, steps, frontend = _inputs(key)
        max_len = 16
        params[key] = jax.tree.map(np.asarray, _params(jcfg))
        want[key] = _reference(jcfg, params[key], prompt, steps, frontend,
                               max_len)
        for name, shape in SHAPES.items():
            cases[f"{key}_{name}"] = dict(
                arch=arch, arch_key=key, fields=fields, shape=shape,
                prompt=prompt, steps=steps, frontend=frontend,
                max_len=max_len,
                rules=RULES.get(key, {}))
    got = {}
    for world in (2, 4):
        names = [n for n, c in cases.items()
                 if math.prod(c["shape"]) == world]
        ranks = mesh_lib.run_ranks(
            workers.decode_group, world,
            args=([cases[n] for n in names], params), deadline_s=DEADLINE_S)
        for i, n in enumerate(names):
            got[n] = [r[i] for r in ranks]
    return cases, got, want


@pytest.mark.parametrize("name", [f"{k}_{s}" for k in ARCHS for s in SHAPES])
def test_mesh_decode_matches_the_reference(runs, name):
    cases, got, want = runs
    case = cases[name]
    ref_logits = want[case["arch_key"]]
    assert len(got[name]) == math.prod(case["shape"])
    for rank in got[name]:
        r0, n = rank["rows"]
        for step, (g, w) in enumerate(zip(rank["logits"], ref_logits)):
            w = w[r0:r0 + n]
            scale = max(1.0, float(np.abs(w).max()))
            err = float(np.abs(g - w).max())
            assert err <= TOL * scale, (name, step, err, scale)
    if case["arch_key"] == "jamba" and case["shape"][0] == 2:
        # The 16 rows split over data: sequence-parallel attention.
        assert got[name][0]["spec"][0][:2] == [None, "data"]
    if case["arch_key"] == "qwen3_rows" and case["shape"][1] == 2:
        assert got[name][0]["spec"][0][1:3] == ["model", None]


def test_plain_decode_lse_is_the_scores_logsumexp():
    g = torch.Generator().manual_seed(0)
    b, h, kvh, d, rows = 3, 8, 2, 64, 40
    q = torch.randn(b, h, d, generator=g)
    k = torch.randn(b, rows, kvh, d, generator=g)
    v = torch.randn(b, rows, kvh, d, generator=g)
    lens = torch.tensor([0, 17, 40], dtype=torch.int32)
    out, lse = ref.flash_decode(q, k, v, lens, return_lse=True)
    assert torch.equal(out, ref.flash_decode(q, k, v, lens))
    kx = k.repeat_interleave(h // kvh, dim=2)
    scores = torch.einsum("bhd,bkhd->bhk", q, kx) / math.sqrt(d)
    for i, n in enumerate(lens.tolist()):
        if n == 0:
            assert torch.isneginf(lse[i]).all()
        else:
            torch.testing.assert_close(
                lse[i], torch.logsumexp(scores[i, :, :n], dim=-1),
                rtol=0, atol=1e-5)
