"""The plain reference against the port on the CPU at a smoke size: the
same weights (the benchmark's), the same tokens, fp32 on both sides."""

import json

import pytest

import torch

from portbench import judge, weights
from portbench.reference import dense
from portbench.tests.smoke import ROOT, SMOKE_MODEL


def test_dense_reference_matches_the_ports_forward():
    from repro_torch.configs import ModelConfig
    from repro_torch.models import transformer as T
    cfg = json.loads((ROOT / "portbench/configs/granite-3-8b.json")
                     .read_text())
    cfg["port_config"] = SMOKE_MODEL
    w = weights.make(SMOKE_MODEL, 2**32 + 9, torch.device("cpu"),
                     torch.float32)
    toks = [torch.randint(2, 256, (n,), generator=torch.Generator()
                          .manual_seed(n)) for n in (37, 5)]
    port = ModelConfig(name="smoke", **SMOKE_MODEL)
    ref = dense.logits(w, cfg, toks, [0, 2])
    for t, r, s in zip(toks, ref, [0, 2]):
        with torch.no_grad():
            got = T.forward(w, port, t[None])[0][0, s:]
        torch.testing.assert_close(r, got, atol=2e-5, rtol=2e-5)


def test_fp8_control_moves_the_logits_and_gaps_read_the_served_token():
    cfg = json.loads((ROOT / "portbench/configs/granite-3-8b.json")
                     .read_text())
    cfg["port_config"] = SMOKE_MODEL
    w = weights.make(SMOKE_MODEL, 4, torch.device("cpu"), torch.float32)
    prompt = torch.randint(2, 256, (20,), generator=torch.Generator()
                           .manual_seed(1)).numpy()
    exact = dense.logits(w, cfg, [torch.from_numpy(prompt).long()], [19])[0]
    best = int(exact.argmax())
    worst = int(exact.argmin())
    served = [(0, prompt, [best])]
    assert float(judge.served_gaps(w, cfg, served, "cpu").max()) == 0.0
    gap = judge.served_gaps(w, cfg, [(0, prompt, [worst])], "cpu")
    assert float(gap[0]) == float(exact.max() - exact.min())
    low = dense.logits(w, cfg, [torch.from_numpy(prompt).long()], [0],
                       quant=dense.fp8)[0]
    high = dense.logits(w, cfg, [torch.from_numpy(prompt).long()], [0])[0]
    assert 1e-3 < float((low - high).abs().max()) < 10.0


def test_sample_holds_the_longest_and_reaches_its_token_count():
    done = [(i, None, [0] * (10 + i)) for i in range(30)]
    s = judge.sample(done, 2**33, 100)
    assert s[0][0] == 29
    assert sum(len(t) for _, _, t in s) >= 100
    assert judge.sample(done, 2**33, 100) == s
    assert judge.sample(done, 7, 100) != s or len(s) < 3


JAMBA_SMOKE = dict(n_layers=8, d_model=32, n_heads=4, n_kv_heads=2,
                   head_dim=8, d_ff=64, vocab=128,
                   pattern=["mamba", "mamba", "mamba", "mamba", "attn",
                            "mamba", "mamba", "mamba"],
                   moe_positions=[1, 3, 5, 7], n_experts=4, top_k=2,
                   moe_impl="capacity", mamba_d_state=8, mamba_head_dim=8,
                   mamba_expand=2, rope_theta=10000.0,
                   compute_dtype="float32")


@pytest.mark.parametrize("factor", [1.25, 0.5])
def test_hybrid_reference_matches_the_ports_forward(factor):
    """The Jamba period at a smoke size, capacity routing at the config's
    factor and at 0.5 (where experts drop choices), against the port's
    cache-less forward (its Mamba layers through the SSD scan's plain
    version)."""
    from repro_torch.configs import ModelConfig
    from repro_torch.models import moe, transformer as T
    from portbench.reference import hybrid
    m = dict(JAMBA_SMOKE, moe_capacity_factor=factor)
    cfg = json.loads((ROOT / "portbench/configs/jamba-v0.1-52b.json")
                     .read_text())
    cfg["port_config"] = m
    w = weights.make(m, 2**31 + 5, torch.device("cpu"), torch.float32)
    port = ModelConfig(name="smoke", **{k: tuple(v) if isinstance(v, list)
                                        else v for k, v in m.items()})
    toks = torch.randint(2, 128, (150,), generator=torch.Generator()
                         .manual_seed(3))
    x = torch.randn(150, 32, generator=torch.Generator().manual_seed(4))
    dropped = int(moe.dropped(w["blocks"][1]["moe"], port.moe_cfg(),
                              x[None]))
    assert (dropped > 0) == (factor < 1)
    ref = hybrid.logits(w, cfg, [toks], [149])[0]   # the whole prompt
    with torch.no_grad():
        got = T.forward(w, port, toks[None])[0][0, 149:]
    # fp32 on both sides, the scan's sums in another order (chunks of 64
    # here, the port's plain scan there): within 1e-4 of the largest logit.
    scale = float(ref.abs().max())
    assert scale > 1.0
    torch.testing.assert_close(ref, got, atol=1e-4 * scale, rtol=0)
