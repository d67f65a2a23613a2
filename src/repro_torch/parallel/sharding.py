"""Logical-axis sharding rules -> DTensor placements for the port's trees.

Port of ``repro.parallel.sharding``: one rule table serves all ten
architectures (DP / FSDP / TP / EP / SP), resolved per leaf path:

* batch            -> ("pod", "data")     pure DP across pods
* GEMM input dim   -> "data"              FSDP / ZeRO-3 parameter+optimizer
                                          sharding
* GEMM output dim  / heads / vocab -> "model"   tensor parallelism
* MoE expert dim   -> "model"             expert parallelism
* KV-cache batch   -> ("pod", "data"), heads -> "model"
* recurrent state width -> "model"        SP-style state sharding

Every assignment is guarded by divisibility: a mesh axis that does not
divide its dim is dropped and the dim replicated.

A mesh here is an ordered mapping of axis names to sizes (``{"data": 16,
"model": 16}``) or anything with ``mesh_dim_names`` and ``shape`` (a
``DeviceMesh``, ``launch.mesh.MeshShape``), so the rules resolve at
production size with no process.  Each resolver returns its tree's
structure with one :class:`Spec` per leaf: per dim ``None``, an axis name
or a tuple of names, as the reference's ``PartitionSpec`` holds them.
Leaves are matched by the same regexes over their path: the port's
per-layer tree (``layers/3/core/wq/w``) ends in the reference's leaf names,
and its stacked units' leading dim does not exist here (the reference gives
it ``None``).  :func:`placements` turns a spec into DTensor ``Shard`` /
``Replicate`` placements, one per mesh dim; a tuple of axes on one dim is
split row-major over the axes in the tuple's order, which is DTensor's
order when the tuple follows the mesh's axis order (any other order is
refused).  :func:`local_block` gives a rank's block of a full tensor and
:func:`distribute_tree` wraps each leaf's block as a DTensor with no
communication.

The activation constraints (``_ACT_RULES``, ``activation_mesh``,
``shard_act``) are not ported: the model axis shards storage only here.
"""
from __future__ import annotations

import math
import re
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import torch

# trailing-dims logical rules per leaf name (regex on the flattened path).
# Convention: ("in", "out") GEMMs are (FSDP, TP).
_PARAM_RULES: Tuple[Tuple[str, Tuple], ...] = (
    (r"embedding/table$", ("model", "data")),          # (V, D): vocab TP + FSDP
    (r"head/w$", ("data", "model")),                   # (D, V)
    (r"(wq|wk|wv)/w$", ("data", "model")),
    (r"(wq|wk|wv)/b$", ("model",)),
    (r"wo/w$", ("model", "data")),
    (r"(up|gate)/w$", ("data", "model")),
    (r"down/w$", ("model", "data")),
    (r"(up|gate|down|wo)/b$", (None,)),
    (r"router/w$", ("data", None)),
    (r"mlp/(w_up|w_gate)$", ("model", "data", None)),  # (E, D, F): EP + FSDP
    (r"mlp/w_down$", ("model", None, "data")),         # (E, F, D)
    (r"w_in/w$", ("data", "model")),
    (r"w_out/w$", ("model", "data")),
    (r"conv_w$", (None, "model")),
    (r"conv_b$", ("model",)),
    (r"lam$", ("model",)),
    (r"(w_a|w_x)/w$", (None, "model")),
    (r"(w_a|w_x)/b$", ("model",)),
    (r"(w_up|w_gates|w_q|w_k|w_v|w_if)/w$", ("data", "model")),
    (r"(w_up|w_gates|w_q|w_k|w_v|w_if)/b$", ("model",)),
    (r"w_down/w$", ("model", "data")),
    (r"r_gates$", (None, None, None, None)),
    (r"(scale|bias)$", (None,)),
)


def logical_rules() -> Tuple[Tuple[str, Tuple], ...]:
    return _PARAM_RULES


# Named strategies re-map the baseline (TP+FSDP) table: "tp_fsdp" as is;
# "fsdp" pure ZeRO-3 (sharded dims over ("data", "model"), experts keep
# EP); "ep_dp" experts on "model", everything else FSDP over "data"; "tp"
# inference (no optimizer state: FSDP dropped, TP kept).
STRATEGIES = ("tp_fsdp", "fsdp", "ep_dp", "tp")


class Spec:
    """One leaf's placement per dim, as ``PartitionSpec`` holds it (a
    one-axis tuple as the bare name); a leaf of the spec trees (not a
    tuple, so tree walks stop at it).  ``tuple(spec)`` gives the entries
    and it compares equal to them."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                             for e in entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other):
        if isinstance(other, Spec):
            return self.entries == other.entries
        return isinstance(other, tuple) and self.entries == other

    def __hash__(self):
        return hash(self.entries)

    def __repr__(self):
        return f"Spec{self.entries!r}"


# ------------------------------------------------------------------ trees
def _children(tree) -> Optional[List[Tuple[Any, Any]]]:
    if isinstance(tree, dict):
        return list(tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # NamedTuple states
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def _rebuild(tree, values):
    if isinstance(tree, dict):
        return dict(zip(tree.keys(), values))
    if hasattr(tree, "_fields"):
        return type(tree)(*values)
    return type(tree)(values)


def map_with_path(fn, tree, path: str = ""):
    """``tree``'s structure with ``fn(path, leaf)`` at each leaf; paths are
    ``/``-joined keys, NamedTuple fields by name (``layers/0/k``)."""
    kids = _children(tree)
    if kids is None:
        return fn(path, tree)
    return _rebuild(tree, [map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                           for k, v in kids])


def leaves_with_paths(tree, path: str = "") -> Iterator[Tuple[str, Any]]:
    kids = _children(tree)
    if kids is None:
        yield path, tree
        return
    for k, v in kids:
        yield from leaves_with_paths(v, f"{path}/{k}" if path else str(k))


def zip_map(fn, tree, specs):
    """``fn(leaf, spec)`` over ``tree`` and its spec tree, leaf by leaf."""
    it = iter([s for _, s in leaves_with_paths(specs)])
    out = map_with_path(lambda _, leaf: fn(leaf, next(it)), tree)
    if next(it, None) is not None:
        raise ValueError("zip_map: the spec tree has more leaves than the tree")
    return out


# ------------------------------------------------------------------ meshes
def axis_sizes(mesh) -> Dict[str, int]:
    """Ordered ``{axis: size}`` of a mapping, ``DeviceMesh`` or ``MeshShape``."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _axis_size(sizes: Mapping[str, int], entry) -> int:
    return math.prod(sizes[a] for a in _axes(entry))


# -------------------------------------------------------------- resolvers
def _remap_rule(rule: Tuple, strategy: str, is_expert: bool) -> Tuple:
    if strategy == "tp_fsdp":
        return rule
    if strategy == "fsdp" and is_expert:
        return rule  # experts keep their EP layout
    out = []
    for entry in rule:
        if strategy == "fsdp":
            if entry == "data":
                out.append(("data", "model"))
            elif entry == "model":
                out.append(None)
            else:
                out.append(entry)
        elif strategy == "ep_dp":
            if is_expert:
                out.append(entry)
            elif entry == "model":
                out.append(None)
            else:
                out.append(entry)
        elif strategy == "tp":
            out.append(None if entry == "data" else entry)
    # at most one dim may use the combined axes; keep the first
    if strategy == "fsdp":
        seen = False
        for i, e in enumerate(out):
            if e == ("data", "model"):
                if seen:
                    out[i] = None
                seen = True
    return tuple(out)


def _guard(sizes: Mapping[str, int], spec: Tuple, shape: Tuple[int, ...]) -> Spec:
    """Drop axes that don't divide the dim; pad missing leading dims."""
    spec = tuple(spec)
    if len(spec) < len(shape):
        spec = (None,) * (len(shape) - len(spec)) + spec
    spec = spec[-len(shape):] if len(spec) > len(shape) else spec
    out = []
    for dim, entry in zip(shape, spec):
        if entry is None:
            out.append(None)
        elif dim % _axis_size(sizes, entry) == 0:
            out.append(entry)
        else:
            out.append(None)
    return Spec(*out)


def param_specs(tree, mesh, strategy: str = "tp_fsdp"):
    """Param tree (tensors or anything with ``.shape``, on any device, the
    meta device too) -> a :class:`Spec` per leaf via the rule table."""
    assert strategy in STRATEGIES, strategy
    sizes = axis_sizes(mesh)

    def one(pstr, leaf):
        for pat, rule in _PARAM_RULES:
            if re.search(pat, pstr):
                is_expert = bool(re.search(r"mlp/(w_up|w_gate|w_down)$", pstr))
                rule = _remap_rule(rule, strategy, is_expert)
                return _guard(sizes, rule, tuple(leaf.shape))
        return Spec()  # replicate by default

    return map_with_path(one, tree)


def _dp_axes(mesh, batch: int, strategy: str = "tp_fsdp"):
    """Largest batch-dividing contiguous run of the DP axes."""
    sizes = axis_sizes(mesh)
    names = ("pod", "data", "model") if strategy == "fsdp" else ("pod", "data")
    cand = [a for a in names if a in sizes]
    options = [tuple(cand[i:]) for i in range(len(cand))]  # drop outermost axes first
    options += [tuple(cand[:-1])] if len(cand) > 1 else []
    for axes in options:
        if axes and batch % _axis_size(sizes, axes) == 0:
            return axes
    return None


def batch_specs(tree, mesh, strategy: str = "tp_fsdp"):
    """Input batch tree: dim 0 (the global batch) over the DP axes."""

    def one(_, leaf):
        if not hasattr(leaf, "shape") or len(leaf.shape) == 0:
            return Spec()
        dp = _dp_axes(mesh, leaf.shape[0], strategy)
        spec = [None] * len(leaf.shape)
        if dp:
            spec[0] = dp
        return Spec(*spec)

    return map_with_path(one, tree)


def _state_rule(pstr: str, base_rank: int, kv_layout: str = "heads") -> Tuple:
    if re.search(r"\.(k|v)$", pstr) or pstr.endswith("/k") or pstr.endswith("/v"):
        if kv_layout == "seq":  # flash-decoding: the cache's sequence axis on "model"
            return ("batch", None, "model", None)  # [B, kv, S, hd]
        return ("batch", "model", None, None)  # [B, kv, S, hd]
    if pstr.endswith("h") and base_rank == 2:
        return ("batch", "model")  # rglru h [B, R]
    if pstr.endswith("conv"):
        return ("batch", None, "model")
    if base_rank == 4:  # mlstm c [B, H, dk, dv]
        return ("batch", None, "model", None)
    if base_rank == 3:  # mlstm n / slstm fields [B, H, d]
        return ("batch", None, "model")
    if base_rank == 2:  # mlstm m [B, H]
        return ("batch", None)
    return ("batch",)


def state_specs(tree, mesh, batch: int, kv_layout: str = "heads"):
    """Decode-state tree (``{"layers": [KVCache | RGLRUState | ...]}``) ->
    a spec per leaf (KV caches, recurrent states)."""
    sizes = axis_sizes(mesh)
    dp = _dp_axes(sizes, batch)

    def one(pstr, leaf):
        rank = len(leaf.shape)
        base_rank = rank - 1 if "units" in pstr else rank
        rule = _state_rule(pstr, base_rank, kv_layout)
        rule = tuple(dp if r == "batch" else r for r in rule)
        return _guard(sizes, rule, tuple(leaf.shape))

    return map_with_path(one, tree)


def tree_shardings(tree, mesh, kind: str, batch: Optional[int] = None):
    if kind == "params":
        return param_specs(tree, mesh)
    if kind == "batch":
        return batch_specs(tree, mesh)
    if kind == "state":
        assert batch is not None
        return state_specs(tree, mesh, batch)
    raise ValueError(kind)


# ------------------------------------------------------------- placements
def placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: per mesh dim ``Shard(d)``
    when tensor dim ``d`` is split over it, else ``Replicate()``.  A mesh
    axis used twice, or a tuple of axes out of the mesh's order, is
    refused (DTensor would need a strided shard for the latter)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(axis_sizes(mesh))
    out: List[Any] = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        idx = [names.index(a) for a in _axes(entry)]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {entry} are out of the mesh's order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec}: mesh axis {names[i]!r} used twice")
            out[i] = Shard(dim)
    return tuple(out)


def mesh_coords(mesh) -> Dict[str, int]:
    """This rank's coordinate on each axis of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def local_block(x: torch.Tensor, spec, mesh, coords: Mapping[str, int]) -> torch.Tensor:
    """The block of the full tensor ``x`` that the rank at ``coords`` holds
    under ``spec``: per dim, chunk ``i`` of ``prod(sizes)``, with ``i``
    row-major over the entry's axes in the entry's order (a view)."""
    sizes = axis_sizes(mesh)
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        if not axes:
            continue
        i = 0
        for a in axes:
            i = i * sizes[a] + coords[a]
        step = x.shape[dim] // _axis_size(sizes, axes)
        x = x.narrow(dim, i * step, step)
    return x


def holds_first_copy(spec, mesh, coords: Mapping[str, int]) -> bool:
    """Whether this rank's block is the first copy of it: its coordinate
    is 0 on every mesh axis the spec does not split over."""
    used = {a for entry in spec for a in _axes(entry)}
    return all(coords[a] == 0 for a in axis_sizes(mesh) if a not in used)


def mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def distribute_tensor_block(x: torch.Tensor, spec, mesh):
    """``x`` (the full tensor, on any device, present on every rank) as a
    DTensor under ``spec``: this rank's block, copied to the mesh's device;
    no communication."""
    from torch.distributed.tensor import DTensor

    block = local_block(x, spec, mesh, mesh_coords(mesh))
    block = block.to(mesh_device(mesh), copy=True).contiguous()
    return DTensor.from_local(block, mesh, placements(spec, mesh), run_check=False,
                              shape=tuple(x.shape), stride=_contiguous_stride(x.shape))


def _contiguous_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for d in reversed(tuple(shape)):
        stride.append(acc)
        acc *= d
    return tuple(reversed(stride))


def distribute_tree(tree, specs, mesh):
    """Each leaf of ``tree`` (full tensors) as a DTensor under its spec."""
    return zip_map(lambda leaf, spec: distribute_tensor_block(leaf, spec, mesh), tree, specs)
