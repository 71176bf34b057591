"""The reference's attention and cache knobs in the PyTorch port, against
the reference: ``ModelConfig.attn_probs_fp32`` (bf16 scores and
probabilities in the plain ``sdpa``), ``ModelConfig.expand_kv`` (kv
heads repeated to the query heads before the plain ``sdpa``'s scores)
and int8 caches (``init_caches(dtype=torch.int8)``: attention K/V and
Mamba's conv and SSM state, written with the reference's saturation).

Inputs are made from numpy seeds; weights come from the reference's
``init_params`` through ``bridge.params_from_jax``. The reference runs
under ``JAX_PLATFORMS=cpu``.

Tolerances, each stated where it is used:

* ``sdpa`` in fp32: 1e-5 absolute (outputs O(1); the two frameworks'
  fp32 sums differ in the last bits).
* ``sdpa`` in bf16 with ``probs_fp32`` False: 4e-3 absolute. A torch
  transcription of the reference's bf16 chain lands within 1.95e-3 of
  it on these inputs, while the two modes differ by 3.1e-2: ignoring the
  knob fails (``test_bf16_probabilities_are_told_apart`` holds that
  gap above the tolerance).
* ``sdpa`` in bf16 with fp32 probabilities: 2 bf16 roundings (2^-7) of
  the output's largest element: the scores' bf16 einsum and the
  output's rounding may each land a unit apart between the frameworks.
* bf16 smoke models: logits within 2^-6 of their largest (four bf16
  roundings: every layer's products round apart), the loss within 1e-3
  relative, gradients within 2^-4 of each leaf's largest (sixteen
  roundings: the backward runs every product twice more; ``b_k``'s,
  zero but for rounding, within 2^-4 of the whole gradient's largest).
  At these sizes that noise equals the probabilities' own effect on the
  logits, so the model-level check is parity, and the wiring (which
  flags each path hands ``sdpa``) is checked by recording the calls.
* fp32 models: logits within 1e-5 of their largest (at least 1); the
  flag ``attn_probs_fp32`` changes nothing, bit for bit.
* int8 caches in fp32 compute: the caches equal the reference's element
  for element (saturated elements included: the K norm's scale and the
  V and Mamba input projections are scaled by 60 so that rows leave the
  int8 range), logits within 1e-5 of their largest.
* Two ranks against one (the model axis, fp32): loss within 1e-6
  relative, gradients within 1e-5 of each leaf's largest, as in
  ``tests/test_torch_model_axis_families.py``; the served streams equal.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.train import steps as jsteps

from repro_torch import configs
from repro_torch.bridge import params_from_jax
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.kernels import ops as kernel_ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train as train_launch
from repro_torch.models import layers
from repro_torch.models import transformer as T
from repro_torch.train import steps
from repro_torch.tree import tree_items, tree_map

import _torch_knob_workers as knob_workers

FP32_TOL = 1e-5
BF16_PROBS_TOL = 4e-3
BF16_OUT_ULPS = 2 ** -7
BF16_LOGIT_TOL = 2 ** -6
BF16_LOSS_RTOL = 1e-3
BF16_GRAD_TOL = 2 ** -4
LOSS_RTOL, GRAD_TOL = 1e-6, 1e-5
INT8_SCALE = 60.0
SATURATING = [300.0, -300.0, 1.7, -1.7, 127.9, -128.9, float("nan")]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
KNOBS = {"probs_bf16": {"attn_probs_fp32": False},
         "probs_bf16_expand_kv": {"attn_probs_fp32": False,
                                  "expand_kv": True}}


def _pair(arch, **fields):
    """The reference's and the port's smoke configs of ``arch`` with
    ``fields`` replaced."""
    return (dataclasses.replace(jconfigs.get_smoke(arch), **fields),
            dataclasses.replace(configs.get_smoke(arch), **fields))


def _nonzero(tree, scaled=(), seed=1):
    """The reference's parameters as numpy, the cross-attention's gate
    (zero at init) set to 0.5 plus noise, and each leaf named in
    ``scaled`` (a path suffix) multiplied by ``INT8_SCALE``."""
    rng = np.random.RandomState(seed)

    def leaf(path, a):
        names = tuple(getattr(k, "key", None) for k in path)
        a = np.array(a)
        if names[-1] == "gate":
            return np.asarray(0.5 + 0.1 * rng.randn(*a.shape), np.float32)
        if any(names[-len(s):] == s for s in scaled):
            return (a * INT8_SCALE).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _max_err(got, want):
    return float(np.abs(np.asarray(got, np.float64)
                        - np.asarray(want, np.float64)).max())


# ----------------------------------------------------------------------------
# sdpa
# ----------------------------------------------------------------------------

def _sdpa_inputs(mask_kind):
    """b 2, s 64, 8 query heads over 2 kv heads of 64, inputs x 2; the
    mask None, causal (s, s) or per slot (b, s, s) at offsets 0 and 5."""
    rng = np.random.RandomState(0)
    b, s, h, kvh, d = 2, 64, 8, 2, 64
    q = rng.randn(b, s, h, d).astype(np.float32) * 2
    k = rng.randn(b, s, kvh, d).astype(np.float32) * 2
    v = rng.randn(b, s, kvh, d).astype(np.float32) * 2
    kj, qi = np.arange(s)[None, :], np.arange(s)[:, None]
    mask = {"none": None,
            "causal": np.where(kj <= qi, 0.0, -1e30),
            "slots": np.where(kj[None] <= qi[None] + np.array(
                [0, 5])[:, None, None], 0.0, -1e30)}[mask_kind]
    return q, k, v, None if mask is None else mask.astype(np.float32)


def _both_sdpa(dtype, mask_kind, **flags):
    """(the reference's, the port's) ``sdpa`` output as fp32 numpy."""
    tdt, jdt = DTYPES[dtype]
    q, k, v, mask = _sdpa_inputs(mask_kind)
    want = JL.sdpa(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)),
                   mask=None if mask is None else jnp.asarray(mask),
                   **flags)
    got = layers.sdpa(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                      mask=None if mask is None else torch.from_numpy(mask),
                      **flags)
    assert got.dtype == tdt and got.shape == want.shape
    return np.asarray(want.astype(jnp.float32)), got.float().numpy()


@pytest.mark.parametrize("mask_kind", ["none", "causal", "slots"])
@pytest.mark.parametrize("expand_kv", [False, True])
@pytest.mark.parametrize("probs_fp32", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sdpa_matches_the_reference(dtype, probs_fp32, expand_kv,
                                    mask_kind):
    want, got = _both_sdpa(dtype, mask_kind, probs_fp32=probs_fp32,
                           expand_kv=expand_kv)
    if dtype == "float32":
        tol = FP32_TOL
    elif not probs_fp32:
        tol = BF16_PROBS_TOL
    else:
        tol = BF16_OUT_ULPS * float(np.abs(want).max())
    assert _max_err(got, want) <= tol


@pytest.mark.parametrize("mask_kind", ["none", "causal", "slots"])
def test_bf16_probabilities_are_told_apart(mask_kind):
    """The two modes differ by more than the bf16 tolerance, in the
    reference and in the port: the parity test above would fail a port
    that ignored ``probs_fp32``."""
    ref_true, port_true = _both_sdpa("bfloat16", mask_kind, probs_fp32=True)
    ref_false, port_false = _both_sdpa("bfloat16", mask_kind,
                                       probs_fp32=False)
    assert _max_err(ref_true, ref_false) > 4 * BF16_PROBS_TOL
    assert _max_err(port_true, ref_false) > 4 * BF16_PROBS_TOL
    assert _max_err(port_false, ref_false) <= BF16_PROBS_TOL


def test_fp32_probability_flag_changes_nothing():
    """fp32 compute: ``probs_fp32`` False is bit-equal to True, in
    ``sdpa`` and through a model's logits, loss and gradients."""
    q, k, v, mask = (None if a is None else torch.from_numpy(a)
                     for a in _sdpa_inputs("slots"))
    assert torch.equal(layers.sdpa(q, k, v, mask),
                       layers.sdpa(q, k, v, mask, probs_fp32=False))
    jcfg, cfg = _pair("qwen3-4b")
    params = params_from_jax(jax.tree.map(np.asarray, JT.init_params(
        jax.random.PRNGKey(0), jcfg)), cfg, device="cpu")
    batch = _batch(cfg)
    out = {}
    for flag in (True, False):
        c = dataclasses.replace(cfg, attn_probs_fp32=flag)
        tracked = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, _ = steps.loss_fn(tracked, c, batch)
        grads = torch.autograd.grad(loss, [p for _, p in tree_items(tracked)])
        with torch.no_grad():
            logits = T.forward(params, c, batch["tokens"])[0]
        out[flag] = (logits, loss.detach(), grads)
    assert torch.equal(out[True][0], out[False][0])
    assert torch.equal(out[True][1], out[False][1])
    assert all(torch.equal(a, b) for a, b in zip(out[True][2], out[False][2]))


# ----------------------------------------------------------------------------
# Models: cache-less logits, the loss and its gradients
# ----------------------------------------------------------------------------

def _batch(cfg, b=2, s=16):
    tokens, labels = SyntheticLMData(DataConfig(
        vocab=cfg.vocab, seq_len=s, global_batch=b)).batch_at(0)
    return {"tokens": torch.from_numpy(tokens),
            "labels": torch.from_numpy(labels)}


@pytest.mark.parametrize("knobs", list(KNOBS))
@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen2-0.5b"])
def test_bf16_model_matches_the_reference(arch, knobs):
    """A bf16 smoke model under the knobs: cache-less logits, the train
    loss and its gradients (fp32 masters, bf16 compute) against the
    reference's ``forward`` and ``jax.value_and_grad`` of its
    ``loss_fn`` under the same knobs."""
    jcfg, cfg = _pair(arch, compute_dtype="bfloat16", **KNOBS[knobs])
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu", dtype=torch.float32)
    batch = _batch(cfg)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    want = np.asarray(JT.forward(jparams, jcfg, jbatch["tokens"])[0]
                      .astype(jnp.float32))
    with torch.no_grad():
        got = T.forward(params, cfg, batch["tokens"])[0].float().numpy()
    assert _max_err(got, want) <= BF16_LOGIT_TOL * float(np.abs(want).max())
    (jloss, _), jgrads = jax.value_and_grad(
        jsteps.loss_fn, has_aux=True)(jparams, jcfg, jbatch)
    tracked = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, _ = steps.loss_fn(tracked, cfg, batch)
    jl = float(jloss)
    assert abs(float(loss.detach()) - jl) <= BF16_LOSS_RTOL * abs(jl)
    grads = torch.autograd.grad(loss, [p for _, p in tree_items(tracked)])
    wgrads = dict(tree_items(params_from_jax(
        jax.tree.map(np.asarray, jgrads), cfg, device="cpu",
        dtype=torch.float32)))
    assert len(grads) == len(wgrads)
    largest = max(float(w.abs().max()) for w in wgrads.values())
    for (key, w), g in zip(wgrads.items(), grads):
        # b_k's gradient is zero but for rounding (a shift of a row's
        # scores leaves its softmax as it is): its noise has no scale of
        # its own, so it is held to the whole gradient's largest.
        scale = largest if key.endswith("b_k") else float(w.abs().max())
        assert _max_err(g, w) <= BF16_GRAD_TOL * scale, key


def test_cross_attention_keeps_fp32_probabilities():
    """llama-3.2-vision smoke (gate seeded non-zero), bf16: the gated
    cross-attention gives the same bits under either flag, and the
    reference's output (whose ``cross_attention_apply`` passes neither
    flag); the whole model under both flags against the reference's."""
    jcfg, cfg = _pair("llama-3.2-vision-90b", compute_dtype="bfloat16",
                      attn_probs_fp32=False, expand_kv=True)
    np_params = _nonzero(JT.init_params(jax.random.PRNGKey(0), jcfg))
    params = params_from_jax(np_params, cfg, device="cpu",
                             dtype=torch.float32)
    rng = np.random.RandomState(4)
    x = rng.randn(2, 8, cfg.d_model).astype(np.float32)
    kv = rng.randn(2, cfg.n_frontend_tokens, cfg.d_model).astype(np.float32)
    tx, tkv = (torch.from_numpy(a).bfloat16() for a in (x, kv))
    xattn = params["blocks"][0]["xattn"]
    outs = [layers.cross_attention_apply(xattn, T.attn_cfg(c, causal=False),
                                         tx, tkv)
            for c in (cfg, dataclasses.replace(cfg, attn_probs_fp32=True,
                                               expand_kv=False))]
    assert torch.equal(outs[0], outs[1])
    jxattn = jax.tree.map(lambda a: jnp.asarray(a[0]),
                          np_params["blocks"][0]["xattn"])
    want = np.asarray(JL.cross_attention_apply(
        jxattn, jcfg.attn_cfg(causal=False),
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (x, kv)))
        .astype(jnp.float32))
    assert _max_err(outs[0].float(), want) \
        <= BF16_OUT_ULPS * float(np.abs(want).max())
    tokens = rng.randint(0, cfg.vocab, (2, 8)).astype(np.int32)
    frontend = rng.randn(2, cfg.n_frontend_tokens,
                         cfg.d_model).astype(np.float32)
    want = np.asarray(JT.forward(
        jax.tree.map(jnp.asarray, np_params), jcfg, jnp.asarray(tokens),
        frontend_embeds=jnp.asarray(frontend))[0].astype(jnp.float32))
    with torch.no_grad():
        got = T.forward(params, cfg, torch.from_numpy(tokens),
                        frontend_embeds=torch.from_numpy(frontend))[0]
    assert _max_err(got.float(), want) \
        <= BF16_LOGIT_TOL * float(np.abs(want).max())


@pytest.fixture
def recorded(monkeypatch):
    """The flags every ``layers.sdpa`` call receives and the kernels
    called, in order: ("sdpa", expand_kv, probs_fp32) or (kernel,)."""
    calls = []
    real = layers.sdpa

    def sdpa(q, k, v, mask=None, expand_kv=False, probs_fp32=True):
        calls.append(("sdpa", expand_kv, probs_fp32))
        return real(q, k, v, mask=mask, expand_kv=expand_kv,
                    probs_fp32=probs_fp32)

    monkeypatch.setattr(layers, "sdpa", sdpa)
    for name in ("flash_decode", "flash_decode_paged",
                 "flash_attention_paged", "flash_attention"):
        def kernel(*args, _name=name, _real=getattr(kernel_ops, name),
                   **kwargs):
            calls.append((_name,))
            return _real(*args, **kwargs)
        monkeypatch.setattr(kernel_ops, name, kernel)
    return calls


def test_every_plain_path_hands_sdpa_the_flags(recorded):
    """Which flags each path gives ``sdpa``, and which paths keep their
    kernels under ``expand_kv``: the cache-less forward of a vision
    model (self-attention with the flags, the cross-attention without),
    whisper's encoder, the contiguous prefill (with), the contiguous and
    paged decodes and the paged prefill (the kernels, no ``sdpa``)."""
    on = {"attn_probs_fp32": False, "expand_kv": True}
    flags = ("sdpa", True, False)
    plain = ("sdpa", False, True)
    cfg = dataclasses.replace(configs.get_smoke("llama-3.2-vision-90b"),
                              **on)
    params = T.init_params(cfg, device="cpu")
    frontend = torch.zeros(1, cfg.n_frontend_tokens, cfg.d_model)
    tokens = torch.zeros((1, 4), dtype=torch.long)
    with torch.no_grad():
        T.forward(params, cfg, tokens, frontend_embeds=frontend)
    assert recorded == [flags, plain] + [flags] * (cfg.n_layers - 1)
    recorded.clear()
    cfg = dataclasses.replace(configs.get_smoke("whisper-medium"), **on)
    params = T.init_params(cfg, device="cpu")
    with torch.no_grad():
        T.encode(params, cfg, torch.zeros(1, cfg.encoder.n_ctx, cfg.d_model))
    assert recorded == [flags] * cfg.encoder.n_layers
    cfg = dataclasses.replace(configs.get_smoke("qwen3-4b"), **on)
    params = T.init_params(cfg, device="cpu")
    n = cfg.n_layers
    for caches in (T.init_caches(cfg, 2, 16, device="cpu"),
                   T.init_paged_caches(cfg, 2, 16, 4, 9, device="cpu")):
        recorded.clear()
        paged = "kp" in caches[0]
        if paged:
            caches[0]["pages"].copy_(torch.arange(1, 9).reshape(2, 4))
        with torch.no_grad():
            _, caches = T.forward(params, cfg, torch.zeros(
                (2, 5), dtype=torch.long), caches=caches)
            T.forward(params, cfg, torch.zeros((2, 1), dtype=torch.long),
                      caches=caches)
        prefill = ("flash_attention_paged",) if paged else flags
        decode = ("flash_decode_paged",) if paged else ("flash_decode",)
        assert recorded == [prefill] * n + [decode] * n


def test_train_launcher_parses_the_flags():
    cfg = train_launch.apply_overrides(
        configs.get_smoke("qwen3-4b"),
        {"attn_probs_fp32": "false", "expand_kv": "True"})
    assert (cfg.attn_probs_fp32, cfg.expand_kv) == (False, True)
    assert T.attn_cfg(cfg).probs_fp32 is False
    assert T.attn_cfg(cfg).expand_kv is True
    with pytest.raises(ValueError, match="not a boolean"):
        train_launch.apply_overrides(cfg, {"attn_probs_fp32": "no"})


# ----------------------------------------------------------------------------
# int8 caches
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_writes_saturate_like_the_reference(dtype):
    """``cast_to`` and a contiguous write (``layers._write_rows``) of the
    planted values into an int8 cache against the reference's
    ``astype(int8)`` and ``.at[].set``: NaN to 0, the range's bounds
    past it, truncation toward zero inside (bf16 rounds 127.9 to 128
    first). torch's own cast wraps, which the first assertion shows."""
    tdt, jdt = DTYPES[dtype]
    vals = np.array(SATURATING, np.float32)
    want = np.asarray(jnp.asarray(vals).astype(jdt).astype(jnp.int8))
    assert want.tolist() == [127, -128, 1, -1, 127, -128, 0]
    t = torch.from_numpy(vals).to(tdt)
    assert torch.equal(layers.cast_to(t, torch.int8), torch.tensor(want))
    b, rows, kvh, d = 2, 6, 1, len(vals)
    rng = np.random.RandomState(7)
    k = (rng.randn(b, 3, kvh, d) * 100).astype(np.float32)
    k[0, 1, 0] = vals
    v = k[:, :, :, ::-1].copy()
    idx = np.array([1, 4])          # slot 1's last row is past the cache
    cols = idx[:, None] + np.arange(3)[None]
    jk = jnp.zeros((b, rows, kvh, d), jnp.int8).at[
        np.arange(b)[:, None], cols].set(jnp.asarray(k).astype(jdt)
                                         .astype(jnp.int8))
    jv = jnp.zeros((b, rows, kvh, d), jnp.int8).at[
        np.arange(b)[:, None], cols].set(jnp.asarray(v).astype(jdt)
                                         .astype(jnp.int8))
    ck = torch.zeros((b, rows, kvh, d), dtype=torch.int8)
    cv = torch.zeros_like(ck)
    layers._write_rows(ck, cv, torch.from_numpy(k).to(tdt),
                       torch.from_numpy(v).to(tdt), torch.from_numpy(cols))
    assert np.array_equal(ck.numpy(), np.asarray(jk))
    assert np.array_equal(cv.numpy(), np.asarray(jv))
    assert ck[0, 2, 0].tolist() == want.tolist()


@pytest.mark.parametrize("arch", ["qwen3-4b", "mamba2-370m"])
def test_int8_caches_match_the_reference(arch):
    """fp32 compute, int8 caches: a prefill of 8 tokens and two decode
    steps through the cached forward against the reference's, with the K
    norm's scale, ``wv`` and Mamba's ``w_x`` scaled so that rows
    saturate. The caches equal the reference's element for element (and
    some elements sit at the int8 bounds), the logits within 1e-5."""
    jcfg, cfg = _pair(arch)
    np_params = _nonzero(JT.init_params(jax.random.PRNGKey(0), jcfg),
                         scaled=(("k_norm", "scale"), ("wv",), ("w_x",)))
    params = params_from_jax(np_params, cfg, device="cpu")
    jparams = jax.tree.map(jnp.asarray, np_params)
    rng = np.random.RandomState(5)
    b, max_len = 2, 16
    calls = [rng.randint(0, cfg.vocab, (b, 8))] + [
        rng.randint(0, cfg.vocab, (b, 1)) for _ in range(2)]
    jcaches = JT.init_caches(jcfg, b, max_len, dtype=jnp.int8)
    caches = T.init_caches(cfg, b, max_len, device="cpu", dtype=torch.int8)
    fwd = jax.jit(lambda p, t, c: JT.forward(p, jcfg, t, caches=c)[:2])
    for tokens in calls:
        want, jcaches = fwd(jparams, jnp.asarray(tokens, jnp.int32), jcaches)
        with torch.no_grad():
            got, caches = T.forward(params, cfg, torch.from_numpy(tokens),
                                    caches=caches)
        want = np.asarray(want)
        assert _max_err(got, want) <= FP32_TOL * max(
            1.0, float(np.abs(want).max()))
    saturated = 0
    for i, c in enumerate(caches):
        pos, period = i % len(cfg.pattern), i // len(cfg.pattern)
        for name in ("k", "v", "conv", "ssm"):
            if name in c:
                assert c[name].dtype == torch.int8
                w = np.asarray(jcaches[pos][name][period])
                assert np.array_equal(c[name].numpy(), w), (i, name)
                saturated += int(((w == 127) | (w == -128)).sum())
    assert saturated > 0


@pytest.mark.parametrize("arch", ["qwen3-4b", "jamba-v0.1-52b"])
def test_expand_kv_cached_forward_matches_the_reference(arch):
    """fp32, ``expand_kv``: a prefill and two decode steps through the
    contiguous caches against the reference's, whose cached paths leave
    their kernels for the gathered ``sdpa`` under the flag; the port's
    decode keeps ``flash_decode`` (its plain version here). jamba smoke
    (attention beside Mamba and experts) also at the flag off."""
    jcfg, cfg = _pair(arch, expand_kv=True)
    np_params = _nonzero(JT.init_params(jax.random.PRNGKey(0), jcfg))
    params = params_from_jax(np_params, cfg, device="cpu")
    jparams = jax.tree.map(jnp.asarray, np_params)
    rng = np.random.RandomState(6)
    b = 1 if arch == "jamba-v0.1-52b" else 2
    calls = [rng.randint(0, cfg.vocab, (b, 6))] + [
        rng.randint(0, cfg.vocab, (b, 1)) for _ in range(2)]
    jcaches = JT.init_caches(jcfg, b, 16)
    caches = T.init_caches(cfg, b, 16, device="cpu")
    plain = T.init_caches(dataclasses.replace(cfg, expand_kv=False), b, 16,
                          device="cpu")
    fwd = jax.jit(lambda p, t, c: JT.forward(p, jcfg, t, caches=c)[:2])
    for tokens in calls:
        want, jcaches = fwd(jparams, jnp.asarray(tokens, jnp.int32), jcaches)
        t = torch.from_numpy(tokens)
        with torch.no_grad():
            got, caches = T.forward(params, cfg, t, caches=caches)
            off, plain = T.forward(params, dataclasses.replace(
                cfg, expand_kv=False), t, caches=plain)
        want = np.asarray(want)
        scale = max(1.0, float(np.abs(want).max()))
        assert _max_err(got, want) <= FP32_TOL * scale
        assert _max_err(got, off) <= FP32_TOL * scale


# ----------------------------------------------------------------------------
# Two ranks against one
# ----------------------------------------------------------------------------

TWO_RANK = {"qwen3_kv2": {}, "qwen3_kv1": {"n_kv_heads": 1}}


@pytest.fixture(scope="module")
def two_ranks():
    """One gloo group of two CPU ranks: qwen3-4b smoke train steps at
    (data 1, model 2) with both knobs on, its 2 kv heads split over the
    ranks or its one kv head replicated; and the paged engine on a
    two-rank serving mesh with both knobs."""
    on = {"attn_probs_fp32": False, "expand_kv": True}
    cases, one = [], {}
    for name, fields in TWO_RANK.items():
        jcfg, cfg = _pair("qwen3-4b", **fields)
        np_params = jax.tree.map(np.asarray, JT.init_params(
            jax.random.PRNGKey(0), jcfg))
        batch = {k: v.numpy() for k, v in _batch(cfg, b=4).items()}
        cases.append(dict(kind="grad", arch="qwen3-4b", shape=(1, 2),
                          fields={**fields, **on}, params=np_params,
                          batch=batch))
        c = dataclasses.replace(cfg, **on)
        full = params_from_jax(np_params, c, device="cpu",
                               dtype=torch.float32)
        loss, _, grads, _ = steps.make_grad_fn(c)(
            full, {k: torch.from_numpy(v) for k, v in batch.items()})
        one[name] = (float(loss), {k: v.numpy()
                                   for k, v in tree_items(grads)})
    jcfg = jconfigs.get_smoke("qwen3-4b")
    np_params = jax.tree.map(np.asarray, JT.init_params(
        jax.random.PRNGKey(0), jcfg))
    rng = np.random.RandomState(8)
    prompts = [rng.randint(2, jcfg.vocab, n).astype(np.int32)
               for n in (7, 11)]
    serve = (np_params, on, prompts, 5)
    ranks = mesh_lib.run_ranks(knob_workers.knob_group, 2,
                               args=(cases, serve), deadline_s=120.0)
    alone = knob_workers.serve_streams(np_params, on, prompts, 5)
    return ranks, one, alone


@pytest.mark.parametrize("name", list(TWO_RANK))
def test_two_rank_train_step_with_the_knobs_matches_one_rank(two_ranks,
                                                             name):
    ranks, one, _ = two_ranks
    j = list(TWO_RANK).index(name)
    loss1, grads1 = one[name]
    for r in ranks:
        got = r["grads"][j]
        assert abs(got["loss"] - loss1) <= LOSS_RTOL * abs(loss1)
        assert set(got["grads"]) == set(grads1)
        for key, w in grads1.items():
            scale = float(np.abs(w).max())
            assert _max_err(got["grads"][key], w) <= GRAD_TOL * scale, key
        # _attention_train handed sdpa both flags, and nothing else.
        assert r["train_flags"] == [(True, False)]


def test_two_rank_paged_engine_with_the_knobs_serves_one_ranks_streams(
        two_ranks):
    ranks, _, alone = two_ranks
    for r in ranks:
        assert r["streams"] == alone
        # The sharded pool's chunks attend through sdpa with both flags.
        assert r["serve_flags"] == [(True, False)]
    assert math.prod(len(s) for s in alone.values()) > 0
