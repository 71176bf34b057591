"""The PyTorch port's dry run: its shapes, the op census that replaces
``hlo_analysis`` (``core.op_analysis``), the roofline priced on the H100
(``core.roofline``), the kernels' meta branches and the launcher
(``launch.dryrun``), against the reference where the reference has the
same thing.

* ``configs.shapes`` equals the reference's; ``compute_terms`` and
  ``collective_matmul_terms`` equal the reference's when handed the
  reference's v5e constants (197e12 FLOP/s, 819e9 B/s, 2 links of
  50 GB/s), and hand-computed terms with the H100 defaults.
* ``OpTrace`` on a hand-built op sequence over a fake 4-rank group:
  census, FLOPs, bytes, collective kinds, group sizes and the peak of
  live bytes.
* The traced FLOPs of a one-device train step and decode step (qwen3-4b
  and mamba2-370m smoke, remat off) equal ``FlopCounterMode``'s (rel
  1e-9) and the reference's ``hlo_analysis.parsed_flops`` of the same
  jitted function: qwen3 within 1e-9; mamba2's train step within 3 %,
  since its chunked scan's three-operand einsums are contracted in
  another order by torch than by XLA (2.35 % fewer FLOPs here).
* A (data 1, model 2) train step traced on a fake 2-rank group (meta
  tensors) has rank 0's collectives (kind, group size, payload, in
  order), census (less the CPU's free ``lift_fresh`` of constants) and
  FLOPs of a real 2-rank gloo run of it on the CPU
  (``launch.mesh.run_ranks``, rank function in
  ``tests/_torch_mesh_workers.py``).
* The meta branches of ``flash_decode``, ``ssd_scan`` and
  ``flash_attention`` give the plain versions' output shapes and record
  one op with ``kernels.cost``'s count; the other kernels refuse meta.
* The launcher in subprocesses (their fake groups of 256 and 512 ranks
  never live in the test process): qwen2-0.5b ``train_4k`` on both
  meshes, mamba2-370m ``decode_32k``, jamba ``long_500k`` (its attention
  caches held 1/16 a rank: ``cache_seq`` over ``data``), qwen3-4b
  ``long_500k`` skipped with its reason; and the reference's memory
  knobs, each cell traced with and without its flag: ``--kv-dtype int8``
  halves qwen3-4b's ``decode_32k`` K/V bytes and mamba2-370m's conv and
  SSM state, ``--bf16-probs`` lowers qwen2-0.5b's ``train_4k`` temp
  bytes, ``--expand-kv`` raises them by exactly the repeated kv heads
  of one layer and leaves the decode cell (the kernel's path) as it is.
"""

import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro import configs as jconfigs
from repro.configs import shapes as jshapes
from repro.core import hlo_analysis
from repro.core import hwmodel as jhwmodel
from repro.core import roofline as jroofline
from repro.models import transformer as JT
from repro.train import steps as jsteps

from repro_torch import configs
from repro_torch.bridge import params_from_jax
from repro_torch.configs import shapes
from repro_torch.core import hwmodel, op_analysis, roofline
from repro_torch.kernels import cost, ops
from repro_torch.kernels import flash_decode as _decode
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.train import steps

import _torch_mesh_workers as workers

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V5E = types.SimpleNamespace(peak_bf16_flops=197e12, hbm_bandwidth=819e9)
V5E_LINK = hwmodel.LinkSpec("v5e-ici", unidir_gbs=50.0, latency_us=1.0,
                            links=2)
FLOP_TOL = {"qwen3-4b": 1e-9, "mamba2-370m": 3e-2}


def test_shapes_equal_the_reference():
    assert {k: vars(v) for k, v in shapes.SHAPES.items()} == \
        {k: vars(v) for k, v in jshapes.SHAPES.items()}
    assert shapes.SUBQUADRATIC == jshapes.SUBQUADRATIC
    assert configs.list_archs() == jconfigs.list_archs()
    archs = [configs.canonical_id(a) for a in configs.list_archs()]
    assert archs == [jconfigs.canonical_id(a) for a in jconfigs.list_archs()]
    assert shapes.cells(archs) == jshapes.cells(archs)
    for a in archs:
        for s in shapes.SHAPES:
            assert shapes.runnable(a, s) == jshapes.runnable(a, s)
    assert [configs.canonical_id(a) for a in archs] == archs
    assert configs.canonical_id("qwen3_4b") == "qwen3-4b"


def _terms(t):
    return {k: v for k, v in t.to_dict().items() if k != "peak_flops"}


def test_roofline_terms_equal_the_reference_at_its_constants():
    args = ("a", "s", "m", 4, 1e12, 1e9, 1e8, 5e14)
    want = jroofline.compute_terms(*args)
    got = roofline.compute_terms(*args, gpu=V5E, link=V5E_LINK)
    assert _terms(got) == pytest.approx(want.to_dict())
    for m, k, n, f in ((4096, 8192, 2048, 16), (128, 1024, 4096, 4)):
        want = jroofline.collective_matmul_terms(m, k, n, f)
        got = roofline.collective_matmul_terms(m, k, n, f, gpu=V5E,
                                               link=V5E_LINK)
        assert got.keys() == want.keys()
        for v in want:
            assert _terms(got[v]) == pytest.approx(want[v].to_dict()), v
    assert jhwmodel.DEFAULT_TPU.peak_bf16_flops == V5E.peak_bf16_flops


def test_roofline_terms_on_the_h100():
    t = roofline.compute_terms("a", "s", "m", 4, 1e12, 1e9, 1e8, 5e14)
    assert t.compute_s == 1e12 / 989e12
    assert t.memory_s == 1e9 / 3.35e12
    assert t.collective_s == 1e8 / (25e9 * 18)
    assert t.dominant == "compute"
    assert t.step_time_overlapped_s == t.compute_s
    assert t.roofline_fraction == pytest.approx(
        (5e14 / 4 / 989e12) / t.compute_s)
    assert t.flops_efficiency == 5e14 / 4e12
    ag = roofline.collective_matmul_terms(1024, 4096, 1024, 8)["all_gather"]
    assert ag.hlo_flops == 2.0 * 1024 * 4096 * 1024 / 8
    assert ag.collective_bytes == 1024 * 4096 * 2 * 7 / 8
    assert hwmodel.H100.hbm_bytes == 80 * 10**9


def test_roofline_rows_round_trip(tmp_path):
    rows = [roofline.compute_terms("a", "s", "m", 4, 1e12, 1e9, 1e8, 5e14),
            roofline.compute_terms("b", "t", "n", 8, 2e12, 3e9, 0.0, 1e15,
                                   gpu=V5E, link=V5E_LINK)]
    path = str(tmp_path / "rows.json")
    roofline.save_rows(rows, path)
    back = roofline.load_rows(path)
    assert [r.to_dict() for r in back] == [r.to_dict() for r in rows]
    table = roofline.format_table(back).splitlines()
    assert len(table) == 4 and table[0].startswith("| arch | shape")
    assert "| a | s | m |" in table[2] and "compute" in table[2]


def test_op_trace_of_a_hand_built_sequence():
    with mesh_lib.fake_group(4):
        pair = torch.distributed.new_group([0, 1])
        w = torch.ones(8, 16)
        x = torch.ones(4, 8)

        def step(w, x):
            h = x @ w                       # mm: 2 * 4 * 8 * 16 FLOPs
            h = torch.relu(h)
            torch.distributed.all_reduce(h, group=pair)
            flat = h.view(-1)               # a view: free
            del h
            return flat.sum()

        trace = op_analysis.OpTrace()
        out = trace.run(step, w, x)
    assert not torch.distributed.is_initialized()
    assert op_analysis.op_census(trace) == {
        "aten.mm": 1, "aten.relu": 1, "c10d.allreduce_": 1,
        "aten.view": 1, "aten.sum": 1}
    assert op_analysis.trace_flops(trace) == 2 * 4 * 8 * 16
    assert op_analysis.dot_flops_census(trace) == 1
    assert op_analysis.fusion_count(trace) == 3      # mm, relu, sum
    h = 4 * 16 * 4
    assert op_analysis.trace_bytes(trace) == (
        (8 * 16 + 4 * 8) * 4 + h) + 2 * h + 2 * h + (h + 4)
    stats = op_analysis.collective_stats(trace)
    assert stats.bytes_by_kind == {"all-reduce": h}
    assert stats.count_by_kind == {"all-reduce": 1}
    assert [op.group for op in trace.ops if op.kind] == [2]
    assert trace.peak_bytes == 2 * h           # mm's and relu's results
    mem = op_analysis.memory_analysis_bytes(trace)
    assert mem["argument_bytes"] == (8 * 16 + 4 * 8) * 4
    assert mem["output_bytes"] == out.numel() * 4 == 4
    assert mem["alias_bytes"] == 0 and mem["code_bytes"] == 0


def _smoke_runs(arch):
    jcfg, cfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tokens = np.random.RandomState(0).randint(
        0, jcfg.vocab, (4, 16)).astype(np.int32)
    trips = jcfg.periods if jcfg.scan_layers else 1
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(tokens)}
    jstate = jsteps.init_state(jax.random.PRNGKey(0), jcfg).tree()
    want_train = hlo_analysis.parsed_flops(jax.jit(jsteps.make_train_step(
        jcfg)).lower(jstate, jb).compile().as_text(), trips)

    def decode(p, t, c):
        logits, c2, _ = JT.forward(p, jcfg, t[:, None], caches=c)
        return jnp.argmax(logits[:, -1], -1), c2

    want_decode = hlo_analysis.parsed_flops(jax.jit(decode).lower(
        jp, jnp.asarray(tokens[:, 0]), JT.init_caches(jcfg, 4, 32)
    ).compile().as_text(), trips)
    full = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu",
                           dtype=torch.float32)
    state = steps.TrainState(params=full, opt=adamw.adamw_init(full),
                             step=torch.zeros((), dtype=torch.int32)).tree()
    tb = {"tokens": torch.from_numpy(tokens),
          "labels": torch.from_numpy(tokens)}
    got = {}
    for name, fn in (
            ("train", lambda: steps.make_train_step(cfg)(state, tb)),
            ("decode", lambda: T.forward(
                full, cfg, tb["tokens"][:, :1],
                caches=T.init_caches(cfg, 4, 32, device="cpu")
            )[0].argmax(-1))):
        trace = op_analysis.OpTrace()
        with torch.set_grad_enabled(name == "train"), \
                FlopCounterMode(display=False) as fc:
            trace.run(fn)
        got[name] = (op_analysis.trace_flops(trace), fc.get_total_flops())
    return got, {"train": want_train, "decode": want_decode}


@pytest.mark.parametrize("arch", ["qwen3-4b", "mamba2-370m"])
def test_traced_flops_equal_flop_counter_and_the_reference(arch):
    got, want = _smoke_runs(arch)
    for name in ("train", "decode"):
        traced, counted = got[name]
        assert traced == pytest.approx(counted, rel=1e-9, abs=0)
        tol = FLOP_TOL[arch] if name == "train" else 1e-9
        assert traced == pytest.approx(want[name], rel=tol), name


def test_fake_group_trace_equals_a_real_two_rank_run():
    case = dict(arch="qwen3-4b", shape=(1, 2), batch=(2, 16), fsdp=False,
                remat=True)
    real = mesh_lib.run_ranks(workers.census_rank, 2,
                              args=(dict(case, device="cpu"),),
                              deadline_s=120.0)
    with mesh_lib.fake_group(2):
        fake = workers.census(dict(case, device="meta"))
    assert fake["collectives"] == real[0]["collectives"]
    assert len(fake["collectives"]) > 0
    # torch.tensor of a Python number is lifted on the CPU (a free
    # ``aten.lift_fresh``) and made at once on meta (AdamW's constants).
    lifted = {k: v for k, v in real[0]["census"].items()
              if k != "aten.lift_fresh"}
    assert fake["census"] == lifted
    assert fake["flops"] == real[0]["flops"]


def test_meta_branches_give_the_plain_shapes_and_their_cost():
    g = torch.Generator().manual_seed(0)
    q, k = torch.randn(2, 8, 64, generator=g), torch.randn(2, 40, 2, 64,
                                                            generator=g)
    lens = torch.tensor([3, 40], dtype=torch.int32)
    x, a = torch.randn(1, 20, 4, 64, generator=g), -torch.rand(1, 20, 4)
    bc = torch.randn(1, 20, 16, generator=g)
    qf, kf = torch.randn(1, 24, 4, 64), torch.randn(1, 24, 2, 64)

    def meta(*ts):
        return [torch.empty_like(t, device="meta") for t in ts]

    # The launch records the partials of the splits its chosen tile cuts.
    tile = ops.decode_tile(q, 2, 40, block_k=None)
    n_splits = _decode.splits(40, 1, tile.block_k)[1]

    calls = [
        ("flash_decode", lambda *t: ops.flash_decode(*t, lens.to(t[0].device),
                                                     return_lse=True),
         (q, k, k), cost.flash_decode(2, 8, 2, 64, 4, 80, lse=True,
                                      n_splits=n_splits)),
        ("ssd_scan", ops.ssd_scan, (x, a, bc, bc),
         cost.ssd_scan(1, 20, 4, 64, 16, 4, 128)),
        ("flash_attention", ops.flash_attention, (qf, kf, kf),
         cost.flash_attention(1, 24, 24, 4, 2, 64, 4, True)),
    ]
    for name, fn, args, (nbytes, flops) in calls:
        plain = fn(*args)
        trace = op_analysis.OpTrace()
        with trace:
            got = fn(*meta(*args))
        plain = plain if isinstance(plain, tuple) else (plain,)
        got = got if isinstance(got, tuple) else (got,)
        assert [(t.shape, t.dtype) for t in got] == \
            [(t.shape, t.dtype) for t in plain], name
        kernel = [op for op in trace.ops if op.kernel]
        assert [op.name for op in kernel] == [name]
        assert (kernel[0].nbytes, kernel[0].flops) == (nbytes, flops)
    assert cost.flash_decode(2, 8, 2, 64, 4, 80)[1] == 4 * 80 * 8 * 64
    assert ops.LAUNCHES["flash_decode"] == 0
    table = torch.zeros(2, 3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.flash_decode_paged(*meta(q, k, k), table, lens.to("meta"))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.gemm(*meta(torch.ones(8, 8), torch.ones(8, 8)), block=None)


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """The launcher's cells, each in its own process, run together."""
    out = tmp_path_factory.mktemp("dryrun")
    qwen2 = ["--arch", "qwen2-0.5b", "--shape", "train_4k"]
    mamba2 = ["--arch", "mamba2-370m", "--shape", "decode_32k"]
    qwen3 = ["--arch", "qwen3-4b", "--shape", "decode_32k"]
    runs = {"qwen2": qwen2 + ["--mesh", "both"],
            "mamba2": mamba2,
            "jamba": ["--arch", "jamba-v0.1-52b", "--shape", "long_500k"],
            "qwen3": ["--arch", "qwen3-4b", "--shape", "long_500k"],
            "qwen3_decode": qwen3,
            "qwen3_decode_int8": qwen3 + ["--kv-dtype", "int8"],
            "qwen3_decode_expand_kv": qwen3 + ["--expand-kv"],
            "mamba2_int8": mamba2 + ["--kv-dtype", "int8"],
            "qwen2_bf16_probs": qwen2 + ["--bf16-probs"],
            "qwen2_expand_kv": qwen2 + ["--expand-kv"]}
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *argv,
         "--out", str(out / f"{name}.json")], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, argv in runs.items()}
    got = {}
    for name, p in procs.items():
        log = p.communicate(timeout=300)[0]
        assert p.returncode == 0, log
        with open(out / f"{name}.json") as f:
            got[name] = (json.load(f), log)
    return got


def _checked(cell, mesh):
    assert cell["ok"] and not cell["skipped"], cell["reason"]
    assert cell["mesh"] == mesh
    assert cell["cost"]["flops"] > 0
    assert cell["memory"]["argument_bytes"] > 0
    assert cell["roofline"]["dominant"] in ("compute", "memory",
                                            "collective")
    assert cell["collective_bytes"] > 0
    return cell


def test_cli_train_cell_on_both_meshes(cli):
    (single, multi), log = cli["qwen2"]
    _checked(single, "data=16xmodel=16")
    _checked(multi, "pod=2xdata=16xmodel=16")
    assert single["collective_count"]["all-reduce"] > 0
    assert "2 ok, 0 skipped, 0 failed" in log
    # The multi-pod mesh halves each data rank's rows.
    assert multi["cost"]["flops"] < single["cost"]["flops"]


def test_cli_decode_cells(cli):
    (mamba,), _ = cli["mamba2"]
    _checked(mamba, "data=16xmodel=16")
    (jamba,), log = cli["jamba"]
    _checked(jamba, "data=16xmodel=16")
    cfg = configs.get_config("jamba-v0.1-52b")
    whole = 2 * T.n_attention_layers(cfg) * 524288 * cfg.n_kv_heads \
        * cfg.dhead * 2
    assert jamba["cache_bytes"]["kv"] == whole / 16
    assert "1 ok, 0 skipped, 0 failed" in log
    (qwen3,), log = cli["qwen3"]
    assert qwen3["ok"] and qwen3["skipped"]
    assert qwen3["reason"] == jshapes.runnable("qwen3-4b", "long_500k")[1]
    assert "[skip] qwen3-4b x long_500k" in log


def _knob_cells(cli, name):
    """(the cell with the flag, the same cell without it), single mesh."""
    base = {"qwen3_decode_int8": "qwen3_decode",
            "qwen3_decode_expand_kv": "qwen3_decode",
            "mamba2_int8": "mamba2", "qwen2_bf16_probs": "qwen2",
            "qwen2_expand_kv": "qwen2"}[name]
    (cell,), log = cli[name]
    assert "1 ok, 0 skipped, 0 failed" in log
    return _checked(cell, "data=16xmodel=16"), cli[base][0][0]


@pytest.mark.parametrize("name", ["qwen3_decode_int8", "mamba2_int8",
                                  "qwen2_bf16_probs", "qwen2_expand_kv",
                                  "qwen3_decode_expand_kv"])
def test_cli_memory_knobs_move_the_counts(cli, name):
    """Each of the reference's memory knobs, traced in a subprocess
    against the same cell without it."""
    cell, base = _knob_cells(cli, name)
    mem, mem0 = cell["memory"], base["memory"]
    if name == "qwen3_decode_int8":
        # The bf16 K/V halved; the arguments lose exactly that.
        assert cell["cache_bytes"]["kv"] * 2 == base["cache_bytes"]["kv"] > 0
        assert mem0["argument_bytes"] - mem["argument_bytes"] \
            == cell["cache_bytes"]["kv"]
    elif name == "mamba2_int8":
        assert cell["cache_bytes"]["state"] * 2 \
            == base["cache_bytes"]["state"] > 0
        assert cell["cache_bytes"]["kv"] == base["cache_bytes"]["kv"] == 0
    elif name == "qwen2_bf16_probs":
        # bf16 scores and probabilities: fewer temp bytes, same arguments.
        assert mem["temp_bytes"] < 0.9 * mem0["temp_bytes"]
        assert mem["argument_bytes"] == mem0["argument_bytes"]
    elif name == "qwen2_expand_kv":
        # The repeat of one layer's K and V to the query heads lives at
        # the peak: 2 x rows x seq x (h - kvh) x d bf16 more. qwen2's 14
        # q heads do not divide model 16, so each rank holds every head.
        cfg = configs.get_config("qwen2-0.5b")
        spec = shapes.SHAPES["train_4k"]
        rows = spec.global_batch // 16
        repeat = 2 * rows * spec.seq_len * (cfg.n_heads - cfg.n_kv_heads) \
            * cfg.dhead * 2
        assert mem["temp_bytes"] - mem0["temp_bytes"] == repeat
        assert mem["argument_bytes"] == mem0["argument_bytes"]
    else:
        # The decode step's attention is the kernel's under expand_kv too.
        assert cell["cost"] == base["cost"] and mem == mem0
