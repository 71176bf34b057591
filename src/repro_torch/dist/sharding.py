"""Sharding rules: logical axis names -> mesh axes, with divisibility
fallback (port of ``repro/dist/sharding.py``).

The model's tensors name their dimensions with *logical* axes ("batch",
"heads", "mlp", ...). A ``Ruleset`` maps those names onto the axes of the
active mesh (``launch.mesh.Mesh``: a grid over the ranks of a process
group), replicating any dimension whose size does not divide its mesh
axes, so the same model code runs on one rank or many and a head count
that does not divide the model axis replicates those heads instead of
failing.

Entry points:

* ``ruleset.spec(names, shapes)``: the spec of an activation or batch;
* ``param_spec(path, shape, ruleset)``: a parameter's spec from its leaf
  name (``_LEAF_NAMES``), with optional FSDP over the "data" axis;
* ``use_ruleset`` / ``current_ruleset``: the ambient ruleset the
  serving layers read (``serve.dist.active_pool_mesh``; a train step has
  its own switch, ``train.dist.use_mesh``);
* ``local_shard(x, spec, mesh)``: this rank's block of a full tensor,
  and ``shard_tree`` the same for every leaf of a tree by its
  ``param_spec``; ``local_shape`` the block's shape alone;
* ``gather_leaf(x, spec, mesh)``: the full tensor back from the blocks
  (exact: an ``all_reduce`` of this rank's block placed in zeros), and
  ``gather_tree`` the same for a tree, given the specs of its leaves
  (``leaf_specs``).

A spec is a tuple with one entry a dimension: None (replicated), an axis
name, or a tuple of axis names composed left to right (the reference's
``PartitionSpec`` entries).

The reference's ``shard(x, *names)`` has no eager counterpart: it asks
XLA to place an activation, and XLA inserts whatever collective the
placement needs. The port writes each of those collectives where the
data must move (``serve.dist``, ``models.layers``,
``dist.collective_matmul``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.tree import tree_items, tree_unflatten

Spec = Tuple[Any, ...]

# Logical axis -> mesh axis (or tuple of axes, composed left to right).
# None means always replicate. Overridable per Ruleset through ``rules``.
_DEFAULT_RULES: Dict[str, Any] = {
    "batch": ("pod", "data"),
    "seq": None,
    "cache_seq": None,
    "embed": None,
    "head_dim": None,
    "heads": "model",
    "kv_heads": "model",
    "ssm_heads": "model",
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "expert_capacity": None,
    "stage": "stage",
    # Serving: the paged K/V pool shards over its page dim (serve.dist):
    # pages, not slots, are the shard unit, so one slot's table can span
    # ranks and the pool's capacity grows with the mesh.
    "kv_pages": "model",
}

# Parameter leaf name -> logical names of its *trailing* dims. Leading
# extra dims are replicated; leaves not listed (norm scales, biases,
# scalars) replicate, FSDP aside.
_LEAF_NAMES: Dict[str, Tuple[Optional[str], ...]] = {
    # attention: 3-D weights keep the true head counts visible.
    "wq": ("embed", "heads", "head_dim"),
    "wk": ("embed", "kv_heads", "head_dim"),
    "wv": ("embed", "kv_heads", "head_dim"),
    "wo": ("heads", "head_dim", "embed"),
    "b_q": ("heads", "head_dim"),
    "b_k": ("kv_heads", "head_dim"),
    "b_v": ("kv_heads", "head_dim"),
    # mlp
    "w_gate": ("embed", "mlp"),
    "w_up": ("embed", "mlp"),
    "b_up": ("mlp",),
    "w_down": ("mlp", "embed"),
    # embeddings
    "embedding": ("vocab", "embed"),
    "lm_head": ("embed", "vocab"),
    # moe: the expert dim first; the inner dims replicate because "model"
    # is taken by the expert-parallel axis.
    "router": ("embed", "experts"),
    "expert_gate": ("experts", "embed", "mlp"),
    "expert_up": ("experts", "embed", "mlp"),
    "expert_down": ("experts", "mlp", "embed"),
    # mamba
    "w_x": ("embed", "ssm_heads", "head_dim"),
    "w_z": ("embed", "ssm_heads", "head_dim"),
    "w_B": ("embed", None),
    "w_C": ("embed", None),
    "w_dt": ("embed", "ssm_heads"),
    "dt_bias": ("ssm_heads",),
    "A_log": ("ssm_heads",),
    "D": ("ssm_heads",),
    "conv_w": (None, "ssm_heads", "head_dim"),
    "w_ssm_out": ("ssm_heads", "head_dim", "embed"),
}

# FSDP pays only on large leaves: sharding every norm scale adds gathers.
_FSDP_MIN_ELEMENTS = 1 << 16


@dataclasses.dataclass
class Ruleset:
    """Sharding rules bound to a mesh.

    mesh:  anything with a ``.shape`` mapping of axis name -> size (a
           ``launch.mesh.Mesh``, or a stub in the tests); None disables
           sharding.
    rules: overrides merged over ``_DEFAULT_RULES``.
    fsdp:  also shard each large parameter's largest replicated dim over
           the "data" axis (ZeRO-3 style; training only in practice).
    """

    mesh: Any = None
    rules: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    fsdp: bool = False

    def _rule(self, name: Optional[str]):
        if name is None:
            return None
        if name in self.rules:
            return self.rules[name]
        return _DEFAULT_RULES.get(name)

    def _axis_for(self, name: Optional[str], dim: Optional[int], used: set):
        """One logical dim's mesh axes, with divisibility fallback: the
        whole composed tuple, then the tuple less its outermost axis, and
        so on, else replicated. An axis already in ``used`` is skipped (a
        mesh axis shards one dim of a tensor at most)."""
        target = self._rule(name)
        if target is None or self.mesh is None:
            return None
        axes = (target,) if isinstance(target, str) else tuple(target)
        sizes = dict(self.mesh.shape)
        axes = tuple(a for a in axes
                     if a in sizes and sizes[a] > 1 and a not in used)
        while axes:
            prod = math.prod(sizes[a] for a in axes)
            if dim is not None and dim % prod == 0:
                used.update(axes)
                return axes if len(axes) > 1 else axes[0]
            axes = axes[1:]
        return None

    def spec(self, names: Sequence[Optional[str]],
             shapes: Sequence[Optional[int]]) -> Spec:
        """The spec of a tensor whose dims carry logical ``names``: each
        mesh axis used once at most, non-divisible dims replicated."""
        used: set = set()
        return tuple(self._axis_for(n, d, used)
                     for n, d in zip(names, shapes))

    def sharded(self, name: str, size: int) -> Optional[str]:
        """The mesh axis a lone dim named ``name`` of ``size`` shards over,
        or None where it replicates: how the layers read the rule that
        placed a weight's dim (a composed tuple is not used by serving)."""
        axis = self._axis_for(name, size, set())
        if isinstance(axis, tuple):
            raise ValueError(f"{name} shards over {axis}; serving reads a "
                             f"single mesh axis")
        return axis


def param_spec(path: Sequence[Any], shape: Sequence[int],
               ruleset: Ruleset) -> Spec:
    """The spec of a parameter leaf, keyed on its leaf name: only the last
    entry of ``path`` is read, so optimizer mirrors ({"m": params, ...})
    and stacked blocks resolve as the parameters do. With
    ``ruleset.fsdp`` the largest still-replicated dim that divides the
    "data" axis of a large leaf is also sharded over "data"."""
    leaf = str(path[-1]) if len(path) else ""
    names = _LEAF_NAMES.get(leaf, ())
    names = names[-len(shape):] if len(shape) < len(names) else names
    names = (None,) * (len(shape) - len(names)) + tuple(names)
    used: set = set()
    parts = [ruleset._axis_for(n, d, used) for n, d in zip(names, shape)]
    if ruleset.fsdp and ruleset.mesh is not None and "data" not in used:
        data = dict(ruleset.mesh.shape).get("data", 1)
        if data > 1 and math.prod(shape or [1]) >= _FSDP_MIN_ELEMENTS:
            free = sorted((i for i, p in enumerate(parts) if p is None),
                          key=lambda i: -shape[i])
            for i in free:
                if shape[i] % data == 0:
                    parts[i] = "data"
                    break
    return tuple(parts)


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """Every mesh axis ``spec`` shards over, in dim order."""
    out = []
    for axes in spec:
        if axes is not None:
            out.extend((axes,) if isinstance(axes, str) else axes)
    return tuple(out)


def _block(axes, mesh) -> Tuple[Tuple[str, ...], int, int]:
    """(axes as a tuple, blocks over them, this rank's block): composed
    row-major, the outermost axis slowest."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    n, i = 1, 0
    for a in axes:
        n, i = n * mesh.shape[a], i * mesh.shape[a] + mesh.index(a)
    return axes, n, i


def local_shape(ruleset: Ruleset, names: Sequence[Optional[str]],
                shape: Sequence[int]) -> Tuple[Tuple[int, ...], Spec]:
    """(this rank's block's shape, the spec) of a tensor of global
    ``shape`` whose dims carry logical ``names`` (``Ruleset.spec``)."""
    spec = ruleset.spec(names, shape)
    return tuple(d // _block(a, ruleset.mesh)[1] if a is not None else d
                 for d, a in zip(shape, spec)), spec


def local_shard(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of the full tensor ``x`` under ``spec``: each
    sharded dim cut into equal blocks over its axes, block
    ``mesh.index(...)`` kept. A copy wherever a dim is cut (a block of
    the leading dim is contiguous already, and a view would keep the whole
    tensor alive), so the full tensor can be freed; ``x`` itself where it
    replicates."""
    cut = False
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        _, n, i = _block(axes, mesh)
        size = x.shape[dim] // n
        x = x.narrow(dim, i * size, size)
        cut = True
    return x.clone(memory_format=torch.contiguous_format) if cut \
        else x.contiguous()


def gather_leaf(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The full tensor whose block under ``spec`` this rank holds in
    ``x``, on every rank: each sharded dim's block placed in zeros and
    summed over its axes, exact (one rank contributes each element)."""
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        axes, n, i = _block(axes, mesh)
        shape = list(x.shape)
        size = shape[dim]
        shape[dim] = n * size
        out = x.new_zeros(shape)
        out.narrow(dim, i * size, size).copy_(x)
        for a in axes:
            dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group(a))
        x = out
    return x


def leaf_name(path: str) -> str:
    """The leaf name ``param_spec`` reads from a "/"-joined tree path: its
    last key that is not a list index."""
    keys = [k for k in path.split("/") if not k.isdigit()]
    return keys[-1] if keys else ""


def leaf_specs(like, ruleset: Ruleset) -> Dict[str, Spec]:
    """The spec of each leaf of ``like`` (a tree of tensors of the
    *global* shapes, meta tensors will do), keyed by its path (a tree of
    the same leaves may hold its keys in another order)."""
    return {path: param_spec((leaf_name(path),), tuple(leaf.shape), ruleset)
            for path, leaf in tree_items(like)}


def shard_tree(tree, mesh, ruleset: Ruleset):
    """This rank's shard of the full ``tree``: each leaf cut by the spec
    its name resolves to under ``ruleset`` (heads, mlp and vocab over the
    model axis, large leaves over "data" under FSDP; norms and dims that
    do not divide replicate). Optimizer mirrors ({"m": params, ...})
    resolve as the parameters do."""
    return tree_unflatten(tree, [
        local_shard(leaf, param_spec((leaf_name(path),), tuple(leaf.shape),
                                     ruleset), mesh)
        for path, leaf in tree_items(tree)])


def gather_tree(tree, specs: Dict[str, Spec], mesh):
    """The full tree from this rank's shard (``specs``: each leaf's by
    path, ``leaf_specs``), on every rank."""
    return tree_unflatten(tree, [gather_leaf(x, specs[path], mesh)
                                 for path, x in tree_items(tree)])


# ----------------------------------------------------------------------------
# The ambient ruleset (thread-local, re-entrant)
# ----------------------------------------------------------------------------

_ACTIVE = threading.local()


def current_ruleset() -> Optional[Ruleset]:
    return getattr(_ACTIVE, "ruleset", None)


@contextlib.contextmanager
def use_ruleset(ruleset: Optional[Ruleset]):
    """Install ``ruleset`` as the one the layers read; None (no mesh) is
    allowed and leaves every layer on its one-rank path."""
    prev = current_ruleset()
    _ACTIVE.ruleset = ruleset
    try:
        yield ruleset
    finally:
        _ACTIVE.ruleset = prev
