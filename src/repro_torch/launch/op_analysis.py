"""Op-by-op analysis of a program of the port: the counterpart of the
reference's `repro.launch.hlo_analysis`.

The reference parses XLA's compiled HLO and multiplies each `while` body by
its trip count. The port has no HLO: it runs the program itself, usually on
`meta` tensors (shapes and dtypes, nothing allocated or computed), under a
`TorchDispatchMode` that sees every aten operation the program issues, so
every layer, rematerialization and backward pass is counted by
construction. The kernel ops (`flash_attention`, `ssd_scan`) compute
nothing on `meta` and credit their work (`ops.work`) through
`backend.record_work`; on the card they launch and credit the same work,
and the aten operations inside a kernel call (`backend.kernel_region`) are
the kernel's, not counted again.

It counts, over the whole (global) program:

  flops     torch.utils.flop_counter's formula of every matrix product
            (`flop_registry`), plus the kernels' credited float ops;
  bytes     the reference's rule (hlo_analysis.py:198-216): the output
            bytes of every operation that writes a buffer, plus the operand
            bytes of every matrix product; views and bare allocations
            (`empty*`) move nothing; plus the kernels' credited bytes;
  peak live the largest sum of the storages made during the run and still
            alive, each added when made and taken off when it dies.

Collectives come from the layout, not from a partitioner. The arguments'
tensors carry `Layout`s: their kind (a parameter, optimizer state, a decode
cache, a batch input) and partition spec on a mesh, parameters also their
logical axes. The counter follows each such leaf through casts, copies,
views, transposes, reshapes and the per-layer `select` of stacked leaves
(keeping, per dimension, which of the leaf's dimensions it holds) and
records where the program uses it. The one trace serves every mesh: the op
stream does not depend on it, and `collectives(trace, mesh, layouts)`
resolves the records against a mesh:

  1. a forward or recompute use of a weight sharded over a batch axis (FSDP:
     "model_d" -> "data") all-gathers it over that axis, in the leaf's
     dtype (as the reference's partitioner gathers before the cast), once
     per piece of data the use reaches: a cast or a layer's slice of a
     weight is new data (the rematerialized forward casts, so gathers,
     again), its views and copies are not (the backward's products reuse
     the gathered cast). A use is a matrix product or an operation whose
     output is larger than the weight (a norm scale or bias against
     activations), so the optimizer's elementwise update is none;
  2. each weight gradient is reduce-scattered over the batch axes its leaf
     is sharded over and all-reduced over the other batch axes (train
     steps), in the gradient's dtype, on the per-device shard; the axes an
     expert dimension is sharded over need no reduction (expert parallel);
  3. a matrix product whose contracted dimension of a weight is sharded
     over a model axis all-reduces its per-device output over that axis,
     in float32 (`ACCUM_BYTES`, the partial sums before rounding):
     row-parallel outputs forward, column-parallel input gradients
     backward;
  4. an expert layer whose experts are sharded over a batch axis all-to-
     alls its dispatched tokens: at its first (`wi`) and last (`wo`) expert
     product, the [E, C, D] side of the product (the tokens in, the output
     out; the gradients likewise backward), so twice forward and twice
     backward (and twice again in a rematerialized forward);
  5. a decode cache sharded over a model axis on its sequence ("kv_seq")
     all-reduces the attention output that contracts it over that axis
     (rule 3 on cache leaves; reported under "all-reduce").

Per-device sizes: an activation (a product's output, the dispatched
tokens) is its global size over the batch shards (the product of the mesh
axes of the batch input's first dimension); a leaf's piece is its shard
(`shard_shape`). Wire bytes follow the reference's ring factors
(`wire_bytes`, hlo_analysis.py's `_wire_bytes`).
"""
from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch import backend

aten = torch.ops.aten

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
# The logical axes of a batch (the reference's rules table, "batch").
BATCH_AXES = ("pod", "data")
# Bytes of one partial sum a sharded contraction all-reduces: float32, the
# products' accumulation type (the reference's partitioner reduces before
# rounding to the output's dtype).
ACCUM_BYTES = 4

_ALLOCS = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
           aten.new_empty_strided}
_COPIES = {aten._to_copy, aten.clone, aten.lift_fresh_copy, aten.alias,
           aten.detach, aten.lift_fresh}
# Views the schema does not mark as views.
_ALIASES = {aten._unsafe_view}
# Operations that make new data of a leaf (a cast, a layer's slice): a use
# of what they make gathers again (rule 1).
_FRESH = {aten._to_copy, aten.select, aten.slice, aten.unbind, aten.split,
          aten.split_with_sizes}
# Matrix products: (position of the first operand among the arguments,
# the dimension each operand contracts).
_PRODUCTS = {aten.mm: (0, (1, 0)), aten.bmm: (0, (2, 1)),
             aten.addmm: (1, (1, 0)), aten.baddbmm: (1, (2, 1))}


def wire_bytes(op: str, nbytes: float, n: int) -> float:
    """Per-device wire bytes of one collective over a group of `n` on a
    buffer of `nbytes` (the reference's bidirectional-ring model):
    all-reduce 2 (n-1)/n, all-gather and all-to-all (n-1)/n of the result,
    reduce-scatter (n-1) x the result, collective-permute 1."""
    if op == "all-reduce":
        return 2.0 * (n - 1) / n * nbytes
    if op == "all-gather":
        return (n - 1) / n * nbytes
    if op == "reduce-scatter":
        return float(n - 1) * nbytes
    if op == "all-to-all":
        return (n - 1) / n * nbytes
    return float(nbytes)


# ---------------------------------------------------------------------------
# Layouts and shards
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Layout:
    """What the analysis knows of one argument tensor: `kind` ("param",
    "state", "cache" or "batch"), its partition spec on a mesh (one entry
    per dimension: None, a mesh axis or a tuple of them), a parameter's
    logical axes and its key path."""
    kind: str
    spec: tuple = ()
    logical: Optional[tuple] = None
    name: str = ""


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_shape(shape: Sequence[int], spec: tuple, mesh) -> tuple:
    """The per-device piece of a tensor of `shape` under `spec` on `mesh`:
    each dimension divided by its mesh axes' product, rounded up (an uneven
    dimension padded, as XLA pads it)."""
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    out = []
    for i, d in enumerate(shape):
        n = math.prod(sizes[a] for a in _axes(spec[i] if i < len(spec)
                                               else None))
        out.append(-(-int(d) // n))
    return tuple(out)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def shard_bytes(t: torch.Tensor, spec: tuple, mesh) -> int:
    return math.prod(shard_shape(t.shape, spec, mesh)) * t.element_size()


def argument_bytes(args: tuple, specs: Optional[tuple], mesh) -> list:
    """Each argument tensor's per-device shard bytes, in `tree_tensors`
    order (a tensor without a layout whole)."""
    flat = [t for i, a in enumerate(args)
            for _, t in tree_tensors(a, f"/{i}")]
    return [shard_bytes(t, lay.spec if lay is not None else (), mesh)
            for t, lay in zip(flat, layout_list(args, specs))]


# ---------------------------------------------------------------------------
# Trees of arguments
# ---------------------------------------------------------------------------

def tree_tensors(tree: Any, path: str = "") -> List[Tuple[str, Any]]:
    """[(key path, tensor)] of a tree of dicts (keys sorted), tuples,
    lists and dataclasses (fields in order), in one fixed order."""
    if isinstance(tree, torch.Tensor):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in tree_tensors(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in tree_tensors(v, f"{path}/{i}")]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [x for f in dataclasses.fields(tree)
                for x in tree_tensors(getattr(tree, f.name),
                                      f"{path}/{f.name}")]
    return []


def layouts(tree: Any, specs: Any, kind: str, logical: Any = None) -> Any:
    """A tree shaped like `tree` with a `Layout` at each tensor: `specs` is
    the matching tree of partition specs (a spec tuple where `tree` holds a
    tensor), `logical` (parameters) the matching tree of `ParamSpec`s."""
    if isinstance(tree, torch.Tensor):
        return Layout(kind, tuple(specs),
                      None if logical is None else tuple(logical.axes))
    if isinstance(tree, dict):
        return {k: layouts(v, specs[k], kind,
                           None if logical is None else logical[k])
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(layouts(v, specs[i], kind,
                                  None if logical is None else logical[i])
                          for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {f.name: layouts(getattr(tree, f.name),
                                getattr(specs, f.name), kind)
                for f in dataclasses.fields(tree)}
    return None


def layout_list(args: tuple, specs: Optional[tuple]) -> list:
    """One Layout (or None) per tensor of `args`, in `tree_tensors` order."""
    out = []
    for i, a in enumerate(args):
        s = None if specs is None else specs[i]
        for path, _ in tree_tensors(a, f"/{i}"):
            out.append(_lookup(s, path.split("/")[2:]))
    return out


def _lookup(tree: Any, keys: List[str]) -> Optional[Layout]:
    for k in keys:
        if tree is None:
            return None
        if isinstance(tree, Layout):
            return None
        if isinstance(tree, dict):
            tree = tree.get(k)
        elif isinstance(tree, (list, tuple)):
            tree = tree[int(k)]
        else:
            tree = getattr(tree, k, None)
    return tree if isinstance(tree, Layout) else None


# ---------------------------------------------------------------------------
# Following a leaf's dimensions through views
# ---------------------------------------------------------------------------

def _reshape_dims(dims: tuple, old: Sequence[int], new: Sequence[int]
                  ) -> Optional[tuple]:
    """The leaf dimensions each dimension of a reshape of `old` to `new`
    holds: merged dimensions hold all of theirs (major first), a split
    dimension's go to its first part of size > 1."""
    old_nz = [i for i, d in enumerate(old) if d != 1]
    new_nz = [i for i, d in enumerate(new) if d != 1]
    out: List[tuple] = [()] * len(new)
    i = j = 0
    while i < len(old_nz) and j < len(new_nz):
        gi, gj = [old_nz[i]], [new_nz[j]]
        po, pn = old[old_nz[i]], new[new_nz[j]]
        while po != pn:
            if po < pn:
                i += 1
                if i >= len(old_nz):
                    return None
                gi.append(old_nz[i])
                po *= old[old_nz[i]]
            else:
                j += 1
                if j >= len(new_nz):
                    return None
                gj.append(new_nz[j])
                pn *= new[new_nz[j]]
        out[gj[0]] = tuple(d for k in gi for d in dims[k])
        i += 1
        j += 1
    return tuple(out)


def _norm_dim(d: int, n: int) -> int:
    return d + n if d < 0 else d


def _view_dims(func, args, dims: tuple, out: torch.Tensor
               ) -> Optional[tuple]:
    """The leaf dimensions of a view's output, or None where the view is
    not one the analysis follows."""
    packet = func._overloadpacket
    src = args[0]
    n = src.dim()
    if packet in (aten.alias, aten.detach, aten.lift_fresh, aten.slice,
                  aten.lift_fresh_copy):
        return dims
    if packet == aten.select:
        d = _norm_dim(args[1], n)
        return dims[:d] + dims[d + 1:]
    if packet == aten.t:
        return tuple(reversed(dims)) if n == 2 else dims
    if packet == aten.transpose:
        a, b = _norm_dim(args[1], n), _norm_dim(args[2], n)
        lst = list(dims)
        lst[a], lst[b] = lst[b], lst[a]
        return tuple(lst)
    if packet == aten.permute:
        return tuple(dims[_norm_dim(p, n)] for p in args[1])
    if packet == aten.expand:
        return ((),) * (out.dim() - n) + dims
    if packet == aten.unsqueeze:
        d = _norm_dim(args[1], n + 1)
        return dims[:d] + ((),) + dims[d:]
    if packet == aten.squeeze:
        return _reshape_dims(dims, src.shape, out.shape)
    if packet in (aten.view, aten._unsafe_view, aten.reshape,
                  aten.view_copy, aten._reshape_alias):
        return _reshape_dims(dims, src.shape, out.shape)
    return None


# ---------------------------------------------------------------------------
# The trace
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Trace:
    """What one run of a program counted (global, mesh-free)."""
    entry: str
    flops: float = 0.0
    bytes: float = 0.0
    kernels: Dict[str, dict] = dataclasses.field(default_factory=dict)
    peak_live_bytes: int = 0
    leaves: List[Tuple[str, torch.Tensor, Optional[Layout]]] = \
        dataclasses.field(default_factory=list)
    outputs: List[torch.Tensor] = dataclasses.field(default_factory=list)
    # Rule records: gathers (leaf, leaf dims, bytes), contractions (leaf,
    # contracted leaf dims, output bytes), expert exchanges (leaf, bytes).
    gathers: List[tuple] = dataclasses.field(default_factory=list)
    contractions: List[tuple] = dataclasses.field(default_factory=list)
    exchanges: List[tuple] = dataclasses.field(default_factory=list)
    grads: bool = False
    args: tuple = ()


class _Live:
    """Bytes of the storages made during a run and still alive."""

    def __init__(self):
        self.now = 0
        self.peak = 0
        self.seen: Dict[int, int] = {}
        self.open = True

    def made(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.seen:
            return
        size = st.nbytes()
        self.seen[key] = size
        self.now += size
        self.peak = max(self.peak, self.now)
        weakref.finalize(st, self.died, key)

    def died(self, key: int) -> None:
        if self.open and key in self.seen:
            self.now -= self.seen.pop(key)


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


class _Counter(TorchDispatchMode):
    def __init__(self, trace: Trace):
        super().__init__()
        self.trace = trace
        # tensor -> (leaf, the leaf dimensions of each of its dimensions,
        # token of the data it holds: a cast or a slice makes a new one)
        self.tags = WeakIdKeyDictionary()
        self.gathered = set()                    # tokens gathered (rule 1)
        self.tokens = 0
        self.live = _Live()

    def _token(self) -> int:
        self.tokens += 1
        return self.tokens

    def credit(self, name: str, nbytes: float, flops: float) -> None:
        tr = self.trace
        k = tr.kernels.setdefault(name, {"calls": 0, "bytes": 0.0,
                                         "flops": 0.0})
        k["calls"] += 1
        k["bytes"] += nbytes
        k["flops"] += flops
        tr.bytes += nbytes
        tr.flops += flops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        returns = func._schema.returns
        alias = [r.alias_info for r in returns if r.alias_info is not None]
        packet = func._overloadpacket
        view = (bool(alias) and not any(a.is_write for a in alias)) \
            or packet in _ALIASES
        outs = _tensors(out)
        if not alias and not view:
            for t in outs:
                self.live.made(t)
        if backend.in_kernel_region():
            return out
        tr = self.trace
        if packet in flop_registry:
            tr.flops += flop_registry[packet](*args, **kwargs, out_val=out)
            tr.bytes += sum(_nbytes(t) for t in _tensors(list(args)))
        if not view and packet not in _ALLOCS:
            tr.bytes += sum(_nbytes(t) for t in outs)
        self._follow(func, packet, args, outs, view)
        return out

    # --- leaves ------------------------------------------------------------
    def _follow(self, func, packet, args, outs, view):
        tags = self.tags
        tagged = [(i, a) for i, a in enumerate(args)
                  if isinstance(a, torch.Tensor) and a in tags]
        if not tagged:
            return
        if view or packet in _COPIES:
            src = args[0]
            if not isinstance(src, torch.Tensor) or src not in tags:
                return
            leaf, dims, token = tags[src]
            if packet in _FRESH:
                token = self._token()
            for t in outs:
                if t is src or t in tags:
                    continue
                nd = dims if packet in _COPIES \
                    else _view_dims(func, args, dims, t)
                if nd is None and packet == aten.unbind:
                    d = _norm_dim(args[1] if len(args) > 1 else 0, src.dim())
                    nd = dims[:d] + dims[d + 1:]
                elif nd is None and packet in (aten.split,
                                               aten.split_with_sizes):
                    nd = dims
                if nd is None or len(nd) != t.dim():
                    raise NotImplementedError(
                        f"op analysis: cannot follow the leaf "
                        f"{self.trace.leaves[leaf][0]} through {func} (no "
                        f"rule maps its dimensions): its collectives would "
                        f"go uncounted")
                tags[t] = (leaf, nd, token)
            return
        product = _PRODUCTS.get(packet)
        out_numel = sum(t.numel() for t in outs)
        for i, a in tagged:
            leaf, dims, token = tags[a]
            lay = self.trace.leaves[leaf][2]
            side = i - product[0] if product is not None else -1
            if side in (0, 1):
                cdims = dims[product[1][side]]
                self.trace.contractions.append((leaf, cdims, out_numel))
                if lay.kind == "param" and "experts" in (lay.logical or ()):
                    self._exchange(leaf, lay, cdims, args, product, side,
                                   outs)
            elif out_numel <= a.numel():
                continue                         # elementwise on its shard
            if lay.kind == "param" and token not in self.gathered:
                self.gathered.add(token)
                self.trace.gathers.append((leaf, dims, a.numel()))

    def _exchange(self, leaf, lay, cdims, args, product, side, outs):
        """Rule 4 at the first (wi) and last (wo) expert products: the
        [E, C, D] side of the product."""
        if lay.name.rsplit("/", 1)[-1] not in ("wi", "wo"):
            return
        if any(lay.logical[d] == "model_d" for d in cdims):
            nbytes = _nbytes(args[product[0] + 1 - side])
        else:
            nbytes = sum(_nbytes(t) for t in outs)
        self.trace.exchanges.append((leaf, nbytes))


def trace(fn, *args, specs: Optional[tuple] = None, grads: bool = False,
          entry: Optional[str] = None) -> Trace:
    """Run `fn(*args)` once under the counter. `specs`, one tree per
    argument (or None), holds a `Layout` at each tensor the analysis knows
    (`layouts`): parameters and decode caches are followed, a batch input
    sets the batch shards. `grads` marks a train step (rule 2). The
    layouts' partition specs are not read here: `collectives` resolves the
    records on a mesh."""
    tr = Trace(entry=entry or getattr(fn, "__qualname__", repr(fn)),
               grads=grads, args=args)
    lays = layout_list(args, specs)
    flat = [x for i, a in enumerate(args) for x in tree_tensors(a, f"/{i}")]
    for (path, t), lay in zip(flat, lays):
        if lay is not None and not lay.name:
            lay = dataclasses.replace(lay, name=path)
        tr.leaves.append((path, t, lay))
    mode = _Counter(tr)
    for i, (_, t, lay) in enumerate(tr.leaves):
        if lay is not None and lay.kind in ("param", "cache"):
            mode.tags[t] = (i, tuple((d,) for d in range(t.dim())),
                            mode._token())
    try:
        with backend.work_sink(mode.credit), mode:
            out = fn(*args)
    finally:
        mode.live.open = False
    tr.peak_live_bytes = mode.live.peak
    tr.outputs = [t for _, t in tree_tensors(out)]
    return tr


# ---------------------------------------------------------------------------
# Accounting on a mesh
# ---------------------------------------------------------------------------

def batch_shards(lays: list, mesh) -> int:
    """The product of the mesh axes of the first batch input's first
    dimension (1 without one)."""
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    for lay in lays:
        if lay is not None and lay.kind == "batch" and lay.spec:
            return math.prod(sizes[a] for a in _axes(lay.spec[0]))
    return 1


def group_span(axes: Sequence[str], mesh) -> int:
    """Device indices a group over `axes` spans on the row-major mesh: 1 +
    the sum over its axes of (size - 1) x stride."""
    span = 1
    for a in axes:
        i = mesh.axis_names.index(a)
        span += (mesh.shape[i] - 1) * math.prod(mesh.shape[i + 1:])
    return span


def _on(spec: tuple, dims) -> list:
    return [a for d in dims for a in _axes(spec[d] if d < len(spec)
                                            else None)]


def collectives(tr: Trace, mesh, specs: Optional[tuple] = None) -> dict:
    """Per-device wire bytes by collective type on `mesh`, from the trace's
    records and `specs` (one tree of `Layout`s per argument as in `trace`,
    with this mesh's partition specs; default the trace's own). Adds
    `by_rule` (wire bytes of rules 1-5) and `group_span` (the most device
    indices one group spans)."""
    lays = layout_list(tr.args, specs) if specs is not None \
        else [lay for _, _, lay in tr.leaves]
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    batch_axes = tuple(a for a in BATCH_AXES if a in sizes)
    nb = batch_shards(lays, mesh)
    out = {c: 0.0 for c in COLLECTIVES}
    by_rule = {str(r): 0.0 for r in range(1, 6)}
    groups = set()

    def spec(leaf) -> tuple:
        return lays[leaf].spec if lays[leaf] is not None else ()

    def experts(leaf) -> list:
        lay = tr.leaves[leaf][2]
        return [d for d, n in enumerate(lay.logical or ()) if n == "experts"]

    def add(op, rule, nbytes, axes):
        n = math.prod(sizes[a] for a in axes)
        if n <= 1:
            return
        w = wire_bytes(op, nbytes, n)
        out[op] += w
        by_rule[rule] += w
        groups.add(tuple(axes))

    for leaf, dims, numel in tr.gathers:                       # rule 1
        nbytes = numel * tr.leaves[leaf][1].element_size()
        flat = [d for dd in dims for d in dd]
        skip = set(experts(leaf))
        gather = [a for a in _on(spec(leaf), [d for d in flat
                                              if d not in skip])
                  if a in batch_axes]
        if gather:
            other = [a for a in _on(spec(leaf), flat) if a not in gather]
            add("all-gather", "1",
                nbytes / math.prod(sizes[a] for a in other), gather)
    if tr.grads:                                               # rule 2
        for leaf, (_, t, lay) in enumerate(tr.leaves):
            if lay is None or lay.kind != "param":
                continue
            ex = set(_on(spec(leaf), experts(leaf)))
            used = [a for a in _on(spec(leaf), range(t.dim()))
                    if a in batch_axes and a not in ex]
            rest = [a for a in batch_axes if a not in used and a not in ex]
            piece = shard_bytes(t, spec(leaf), mesh)
            add("reduce-scatter", "2", piece, used)
            add("all-reduce", "2", piece, rest)
    for leaf, cdims, numel in tr.contractions:                 # rules 3, 5
        model = [a for a in _on(spec(leaf), cdims) if a not in batch_axes]
        rule = "5" if tr.leaves[leaf][2].kind == "cache" else "3"
        add("all-reduce", rule, numel * ACCUM_BYTES / nb, model)
    for leaf, nbytes in tr.exchanges:                          # rule 4
        add("all-to-all", "4", nbytes / nb, _on(spec(leaf), experts(leaf)))
    out["total_wire_bytes"] = sum(out[c] for c in COLLECTIVES)
    out["by_rule"] = by_rule
    out["group_span"] = max((group_span(g, mesh) for g in groups),
                            default=1)
    return out


def analyze(fn, *args, n_devices: Optional[int] = None, specs=None,
            mesh=None, grads: bool = False) -> dict:
    """The reference's `analyze_hlo` keys for one program on one mesh:
    `flops_per_device` and `bytes_per_device` (the global counts over
    `n_devices`, default the mesh's size), `collectives` (the five types
    and `total_wire_bytes`, plus `by_rule` and `group_span`; zeros without
    a mesh) and `entry`; and `kernels` (calls, bytes and flops credited per
    kernel) and `peak_live_bytes`."""
    tr = trace(fn, *args, specs=specs, grads=grads)
    n = n_devices or (mesh.size if mesh is not None else 1)
    if mesh is not None:
        coll = collectives(tr, mesh)
    else:
        coll = {**{c: 0.0 for c in COLLECTIVES}, "total_wire_bytes": 0.0}
    return {"flops_per_device": tr.flops / n,
            "bytes_per_device": tr.bytes / n,
            "collectives": coll, "entry": tr.entry,
            "kernels": {k: dict(v) for k, v in tr.kernels.items()},
            "peak_live_bytes": tr.peak_live_bytes}
