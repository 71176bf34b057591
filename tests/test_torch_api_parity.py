"""The port's public API against the reference's, read from the sources.

For every module of ``src/repro/`` the counterpart at the same path under
``src/repro_torch/`` must hold every public top-level name (a definition,
an assignment or an import), every public member of each public class
(methods, properties, dataclass fields, class attributes; ``__init__``
and ``__call__`` too) and every named parameter of each public function
and method. Both packages are read with ``ast``; neither is imported.

What the port leaves out on purpose is listed below, each entry with its
reason; an entry that no longer matches a gap fails too, so the table
shrinks with the gaps. To extend it, add the gap's key (printed by the
failing test) to the table that fits, with a one-line reason:

* ``MODULES``: a reference module with no counterpart;
* ``NAMES``: ``"path::name"`` or ``"path::Class.member"``;
* ``PARAMS``: a parameter name left out wherever it appears (a TPU or
  JAX argument), or ``"path::function(param)"`` for one function;
* ``ELSEWHERE``: a name the port defines in another module (checked
  there), ``RENAMED``: a class the port renamed (its members checked);
* a reference module that builds a Pallas kernel (it calls
  ``pl.pallas_call``) is reached in the port through
  ``kernels/ops.py``: each of its public functions must be there, and
  its own argument list (blocks, ``interpret``) is the wrapper's.
"""

import ast
import pathlib

import pytest

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
REF, PORT = SRC / "repro", SRC / "repro_torch"
REF_MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))

MODULES = {
    "core/hlo_analysis.py": "XLA's compiled-HLO analysis; core/op_analysis "
                            "counts the port's aten and c10d ops instead",
}
TPU = "a TPU record or an XLA hook: the port prices the H100 (GPUSpec)"
INIT = ("a JAX-key initialiser: the port draws the same distributions "
        "from a torch.Generator inside the owning module's init")
NAMES = {
    "core/autotune.py::mxu_efficiency": "the TPU MXU's tile efficiency",
    "core/autotune.py::GemmConfig.vmem_bytes": "a Pallas block's VMEM; "
                                               "the port's GEMM tiles are "
                                               "priced by shared memory",
    "core/autotune.py::AttnBlock.vmem_bytes": "a Pallas block's VMEM; the "
                                              "port prices warps and CTAs",
    "core/autotune.py::ServeConstants.apply_tpu": TPU,
    "core/collectives.py::CollectiveBench.hlo_bytes": "bytes read off "
                                                      "XLA's HLO",
    "core/hwmodel.py::TPUSpec": TPU,
    "core/hwmodel.py::TPU_V5E": TPU,
    "core/hwmodel.py::TPUS": TPU,
    "core/hwmodel.py::DEFAULT_TPU": TPU,
    "core/roofline.py::terms_from_compiled": TPU,
    "dist/sharding.py::shard": "a GSPMD sharding constraint; the port "
                               "shards explicitly over torch.distributed",
    "launch/dryrun.py::state_shardings": TPU,
    "launch/dryrun.py::batch_shardings": TPU,
    "launch/dryrun.py::lower_cell": "XLA's lower-and-compile of a cell; "
                                    "the port traces it on meta tensors",
    "serve/dist.py::pool_sharding": "a GSPMD sharding of the page pool; "
                                    "serve.dist shards it by pages",
    "models/transformer.py::caches_index": "the reference reads slot 0's "
                                           "index for every slot (ROADMAP "
                                           "Queue 3); each slot keeps its "
                                           "own",
    **{f"models/layers.py::{n}_init": INIT
       for n in ("rmsnorm", "layernorm", "norm", "attention",
                 "cross_attention", "mlp", "embedding", "unembed")},
}
PARAMS = {
    "tpu": TPU,
    "ici_links": "the TPU's ICI links: the port's interconnect is NVLink",
    "inter_pod": "the TPU pods' DCN: the port's interconnect is NVLink",
    "key": "a JAX PRNG key: the port takes a torch.Generator",
    "core/autotune.py::candidate_blocks(p)": "the port's candidates are "
                                             "the tiles instantiated for "
                                             "the input type",
    "core/autotune.py::candidate_blocks(vmem_fraction)": TPU,
    "core/autotune.py::candidate_attn_blocks(vmem_fraction)": TPU,
    "models/layers.py::attention_apply(positions)": "the port computes "
                                                    "positions inside "
                                                    "(ROADMAP Queue 3)",
    "models/transformer.py::forward(positions)": "the port computes "
                                                 "positions inside",
    "models/transformer.py::forward(unembed_fn)": "layers routes the "
                                                  "unembedding itself",
    "serve/engine.py::decode_step(unembed_fn)": "layers routes the "
                                                "unembedding itself",
    "serve/engine.py::make_serve_step(donate)": "XLA buffer donation; "
                                                "PyTorch updates caches "
                                                "in place",
    "models/transformer.py::init_paged_caches(mesh)": "a JAX mesh: the "
                                                      "port shards the "
                                                      "pool by ranks "
                                                      "(serve.dist)",
    "models/transformer.py::init_paged_caches(pool_axis)": "the same",
}
ELSEWHERE = {
    "kernels/flash_attention.py::NEG_INF": "kernels/ref.py",
    "kernels/flash_decode.py::NEG_INF": "kernels/ref.py",
    "models/transformer.py::EncoderConfig": "configs/__init__.py",
    "launch/train.py::maybe_init_distributed": "launch/mesh.py",
}
RENAMED = {
    # The reference's Table 3.1 record; the port's GPUSpec is the H100's.
    "core/hwmodel.py::GPUSpec": "PaperGPUSpec",
}


def _params(fn):
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs
            if x.arg not in ("self", "cls")] + \
        [x.arg for x in (a.vararg, a.kwarg) if x is not None]


def _api(path: pathlib.Path) -> dict:
    """{name: params (a function), {member: params or None} (a class), or
    None (anything else)}: a module's top level, imports included."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef):
            members = {}
            for b in node.body:
                if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    members[b.name] = _params(b)
                elif isinstance(b, ast.AnnAssign) \
                        and isinstance(b.target, ast.Name):
                    members[b.target.id] = None
                elif isinstance(b, ast.Assign):
                    members.update((t.id, None) for t in b.targets
                                   if isinstance(t, ast.Name))
            out[node.name] = members
        elif isinstance(node, ast.Assign):
            out.update((t.id, None) for t in node.targets
                       if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name):
            out[node.target.id] = None
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                out.setdefault((alias.asname or alias.name).split(".")[0],
                               "import")
    return out


def _public(name: str) -> bool:
    return not name.startswith("_") or name in ("__init__", "__call__")


def _builds_pallas(path: pathlib.Path) -> bool:
    """Whether the module calls ``pallas_call``: a Pallas kernel's own."""
    return any(isinstance(n, ast.Attribute) and n.attr == "pallas_call"
               for n in ast.walk(ast.parse(path.read_text())))


def _missing_params(key: str, want, have) -> list:
    if want is None or have is None or have == "import":
        return []
    return [f"{key}({p})" for p in want if p not in have]


def gaps(module: str) -> list:
    """Every reference API entry of ``module`` the port lacks, as the
    keys the tables use."""
    ref = _api(REF / module)
    port_path = PORT / module
    if not port_path.exists():
        return [module]
    port = _api(port_path)
    ops = _api(PORT / "kernels/ops.py")
    pallas = _builds_pallas(REF / module)
    out = []
    for name, want in ref.items():
        if not _public(name) or want == "import":
            continue
        key = f"{module}::{name}"
        if pallas and isinstance(want, list):
            if name not in ops:
                out.append(key)
            continue
        have = port.get(RENAMED.get(key, name), "absent")
        if have == "absent":
            out.append(key)
        elif isinstance(want, dict):
            if not isinstance(have, dict):
                continue              # a re-export: its module is checked
            for m, mp in want.items():
                if not _public(m):
                    continue
                if m not in have:
                    out.append(f"{key}.{m}")
                else:
                    out += _missing_params(f"{key}.{m}", mp, have[m])
        else:
            out += _missing_params(key, want, have)
    return out


def _excepted(gap: str) -> bool:
    if gap in MODULES or gap in NAMES or gap in PARAMS \
            or gap in ELSEWHERE:
        return True
    return gap.endswith(")") and gap[gap.rindex("(") + 1:-1] in PARAMS


@pytest.mark.parametrize("module", REF_MODULES)
def test_port_holds_the_reference_api(module):
    left = [g for g in gaps(module) if not _excepted(g)]
    assert not left, f"the port lacks {left}: port them, or add each to " \
                     f"a table of tests/test_torch_api_parity.py with why"


def test_every_exception_names_a_gap_and_a_reason():
    """No stale entry: each keyed exception still matches a gap, and
    each reason is a sentence, not a blank."""
    every = {g for m in REF_MODULES for g in gaps(m)}
    keyed = [k for k in (*MODULES, *NAMES, *PARAMS, *ELSEWHERE) if
             "::" in k or k.endswith(".py")]
    assert [k for k in keyed if k not in every] == []
    for name in PARAMS:
        if "::" not in name:
            assert any(g.endswith(f"({name})") for g in every), name
    reasons = [*MODULES.values(), *NAMES.values(), *PARAMS.values()]
    assert all(isinstance(r, str) and len(r.split()) >= 2 for r in reasons)


@pytest.mark.parametrize("key", sorted(ELSEWHERE))
def test_relocated_names_live_where_the_table_says(key):
    name = key.split("::")[1]
    assert name in _api(PORT / ELSEWHERE[key])


def test_renamed_class_keeps_the_reference_members():
    for key, new in RENAMED.items():
        module, name = key.split("::")
        want = _api(REF / module)[name]
        have = _api(PORT / module)[new]
        assert [m for m in want if _public(m) and m not in have] == []
