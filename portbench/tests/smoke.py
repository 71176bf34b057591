"""A smoke-sized copy of a checkout for the CPU tests: ``BENCHMARK.json``
and ``portbench/`` copied into a temporary directory, ``src`` linked, and
a granite-family smoke configuration with a closed-loop and an open-loop
cell added as files and entries, as a later change would add them."""

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

SMOKE_MODEL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                   head_dim=16, d_ff=96, vocab=256, rope_theta=10000.0,
                   compute_dtype="float32")
ENGINE = dict(paged=True, batch=4, max_len=64, page_size=8, chunk=16)


def make_checkout(tmp: Path, with_src: bool = True) -> Path:
    root = tmp / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    if with_src:
        (root / "src").symlink_to(ROOT / "src")
    return root


def add_smoke_cells(root: Path, limit: float = 1e-3,
                    min_tokens: int = 24) -> None:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "granite-smoke",
        "source": "https://huggingface.co/ibm-granite/granite-3.0-8b-base",
        "file": "portbench/configs/granite-smoke.json",
        "reduced": ["num_hidden_layers", "hidden_size"], "why": "smoke"})
    conf = json.loads((root / "portbench/configs/granite-3-8b.json")
                      .read_text())
    conf.update(name="granite-smoke", port_config=SMOKE_MODEL)
    (root / "portbench/configs/granite-smoke.json").write_text(
        json.dumps(conf))
    base = {"closed": "granite-3-8b.chat-closed192",
            "open": "granite-3-8b.rag-open"}
    for loop, src in base.items():
        name = f"granite-smoke.{loop}"
        bench["workloads"].append({"name": name, "config": "granite-smoke",
                                   "traffic": loop, "chips": 1,
                                   "why": "smoke"})
        spec = json.loads((root / f"portbench/traffic/{src}.json")
                          .read_text())
        spec.update(prompt=[8, 40], output=[4, 12], round=8, engine=ENGINE,
                    judge={"min_tokens": min_tokens, "limit": limit})
        spec.update(clients=4, ramp_ticks=5) if loop == "closed" else \
            spec.update(rate=8.0, warmup_requests=2, shuffle_block=8)
        (root / f"portbench/traffic/{name}.json").write_text(
            json.dumps(spec))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
