"""Parameter specification machinery (port of `repro.models.params`).

Model modules declare their weights as `ParamSpec` trees (shape + logical
sharding axes + init), nested dicts mirroring the reference's pytrees; from
one spec tree `init_params` draws the weights, a dict of tensors with the
same keys, `abstract_params` gives them as shapes and dtypes on the `meta`
device (no allocation), and `partition_specs` / `shardings` resolve each
leaf's logical axes against a mesh (`sharding.rules.Rules`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch import random
from repro_torch.sharding.rules import Sharding


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"              # normal | zeros | ones
    scale: Optional[float] = None     # stddev; None => 1/sqrt(fan_in)
    fan_in_dims: Tuple[int, ...] = (0,)

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def is_spec(x: Any) -> bool:
    return isinstance(x, ParamSpec)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """`fn` on every leaf of a tree of nested dicts (keys kept) and the
    matching leaves of the trees `rest` (whatever they hold there)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """Leaves in the reference's flatten order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like: Any, leaves: list) -> Any:
    """The tree of nested dicts shaped like `like` holding `leaves`, given
    in the reference's flatten order (keys sorted)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        return next(it)
    return build(like)


def stack_specs(tree: Any, n: int, axis_name: Optional[str] = "layers"
                ) -> Any:
    """Prepend a stacked-layer axis to every spec in the tree."""
    def f(s: ParamSpec) -> ParamSpec:
        return ParamSpec(shape=(n,) + s.shape, axes=(axis_name,) + s.axes,
                         init=s.init, scale=s.scale,
                         fan_in_dims=tuple(d + 1 for d in s.fan_in_dims))
    return tree_map(f, tree)


# Elements of one leaf drawn at a time from a twin key (bounds the draw's
# int64 temporaries to a few times this many elements).
TWIN_SLICE = 1 << 26


def _twin_normal(key: torch.Tensor, shape, std: float) -> torch.Tensor:
    """`jax.random.normal(key, shape) * std` in float32, bit for bit,
    drawn in slices of TWIN_SLICE elements of the counter."""
    n = math.prod(shape)
    out = torch.empty(n, dtype=torch.float32, device=key.device)
    for start in range(0, n, TWIN_SLICE):
        stop = min(n, start + TWIN_SLICE)
        out[start:stop] = random.normal_range(key, start, stop) * std
    return out.reshape(shape)


def init_params(tree: Any, source, device=None,
                dtype=torch.float32) -> Any:
    """Random weights for a spec tree: normal with std `scale` or
    1/sqrt(fan_in), zeros or ones, as the reference's `init_params`.

    `source` is either a key of the threefry twin (`random.prng_key`, an
    int64 [2] tensor): then the leaves are the reference's
    `init_params(tree, key)` bit for bit (`split(key, n_leaves)`, one key a
    leaf in the reference's flatten order, `normal(k, shape) * std`), on
    the key's device; or a `torch.Generator` living on `device`, drawn
    leaf by leaf in the same order (other bits than jax's: parity tests
    carry the reference's weights across with
    `interop.params_from_numpy`).
    """
    twin = isinstance(source, torch.Tensor)
    dev = source.device if twin else torch.device(device)
    keys = iter(random.split(source, len(tree_leaves(tree)))) if twin \
        else None

    def one(s: ParamSpec) -> torch.Tensor:
        key = next(keys) if twin else None          # one a leaf, as jax's
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=dtype, device=dev)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=dtype, device=dev)
        fan_in = math.prod(s.shape[d] for d in s.fan_in_dims) or 1
        std = s.scale if s.scale is not None else 1.0 / math.sqrt(fan_in)
        if twin:
            return _twin_normal(key, s.shape, std).to(dtype)
        out = torch.randn(s.shape, generator=source, dtype=torch.float32,
                          device=dev)
        return out.mul_(std).to(dtype)

    def walk(t):
        if not isinstance(t, dict):
            return one(t)
        out = {k: walk(t[k]) for k in sorted(t)}     # draw in sorted order
        return {k: out[k] for k in t}

    return walk(tree)


def abstract_params(tree: Any, dtype=torch.float32) -> Any:
    """The parameters' shapes and dtypes as `meta` tensors (nothing
    allocated), the counterpart of the reference's ShapeDtypeStructs."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=dtype,
                                          device="meta"), tree)


def partition_specs(tree: Any, rules) -> Any:
    """Each leaf's partition spec (a tuple, one entry per dimension) on
    `rules`' mesh: `rules.spec_for_shape(shape, *axes)`."""
    return tree_map(lambda s: rules.spec_for_shape(s.shape, *s.axes), tree)


def shardings(tree: Any, rules) -> Any:
    """Each leaf's `sharding.rules.Sharding` (mesh and spec)."""
    return tree_map(lambda s: Sharding(rules.mesh, rules.spec_for_shape(
        s.shape, *s.axes)), tree)


def count_params(tree: Any) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(tree))
