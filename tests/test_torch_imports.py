"""The PyTorch port stands alone: no module of ``repro_torch`` and not
``chip_smoke.py`` imports JAX or the reference package ``repro``, and its
entry points refuse to fall back to the CPU on their own."""

import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__"):
            for arg in node.args:
                if isinstance(arg, ast.Constant) and isinstance(
                        arg.value, str) and _forbidden(arg.value):
                    bad.append(arg.value)
    assert not bad, f"{path.name} imports {bad}"


def test_port_files_are_found():
    for rel in (("serve", "engine.py"), ("serve", "sampling.py"),
                ("serve", "graphs.py"), ("serve", "spec.py"),
                ("serve", "paged.py"), ("serve", "telemetry.py"),
                ("serve", "traffic.py"), ("serve", "faults.py"),
                ("models", "mamba.py"), ("models", "moe.py"),
                ("configs", "granite_3_8b.py"), ("configs", "phi3_mini_3_8b.py"),
                ("configs", "dbrx_132b.py"),
                ("configs", "llama4_maverick_400b.py"),
                ("configs", "jamba_v0_1_52b.py"),
                ("configs", "whisper_medium.py"),
                ("configs", "llama_3_2_vision_90b.py"),
                ("kernels", "ssd_scan.py"), ("configs", "mamba2_370m.py"),
                ("kernels", "gemm.py"), ("kernels", "pchase_probe.py"),
                ("core", "latency.py"), ("core", "autotune.py"),
                ("core", "hwmodel.py"), ("core", "calibrate.py"),
                ("core", "simulator.py"), ("core", "pchase.py"),
                ("core", "dissect.py"), ("core", "regbank.py"),
                ("core", "regremap.py"), ("core", "scheduler.py"),
                ("core", "atomics.py"), ("core", "tensorcore.py"),
                ("core", "isa.py"), ("core", "card.py"),
                ("configs", "v100_microbench.py"), ("launch", "dissect.py"),
                ("launch", "calibrate.py"), ("launch", "serve.py"),
                ("launch", "autotune_gemm.py"),
                ("launch", "latency.py"), ("launch", "train.py"),
                ("train", "steps.py"), ("train", "trainer.py"),
                ("optim", "adamw.py"), ("optim", "schedule.py"),
                ("data", "pipeline.py"), ("dist", "compression.py"),
                ("checkpoint", "manager.py"), ("dist", "sharding.py"),
                ("dist", "collective_matmul.py"), ("serve", "dist.py"),
                ("launch", "mesh.py"), ("core", "interconnect.py"),
                ("core", "collectives.py"), ("dist", "pipeline.py"),
                ("train", "dist.py")):
        assert PORT.joinpath(*rel) in FILES
    assert (ROOT / "chip_smoke.py").exists()


def test_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    from repro_torch import configs
    from repro_torch.launch import train
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import ServeConfig, ServingEngine
    from repro_torch.train import steps

    cfg = configs.get_smoke("qwen3-4b")
    with pytest.raises(RuntimeError, match="CUDA"):
        T.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.init_paged_caches(cfg, 2, 32, 8, 9)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        T.init_caches(cfg, 2, 32)
    for paged in (False, True):
        with pytest.raises(RuntimeError, match="CUDA"):
            ServingEngine(params, cfg, ServeConfig(
                max_len=32, batch=2, paged=paged, chunk_size=8, page_size=8))
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(params, cfg, ServeConfig(
            max_len=32, batch=2, paged=True, chunk_size=8, page_size=8,
            spec_k=2, prefix_cache=True))
    from repro_torch.serve import spec
    with pytest.raises(RuntimeError, match="CUDA"):
        spec.resolve_draft("qwen2-0.5b", cfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        steps.init_state(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "qwen3-4b", "--smoke", "--steps", "1",
                    "--ckpt", str(tmp_path)])
    assert not list(tmp_path.iterdir())
    from repro_torch.core import card
    from repro_torch.launch import dissect
    with pytest.raises(RuntimeError, match="CUDA"):
        card.CardHierarchy()
    with pytest.raises(RuntimeError, match="CUDA"):
        card.dissect_card()
    with pytest.raises(RuntimeError, match="CUDA"):
        dissect.main([])
