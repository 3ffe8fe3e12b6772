"""Parameter specification machinery (port of `repro.models.params`).

Model modules declare their weights as `ParamSpec` trees (shape + logical
sharding axes + init), nested dicts mirroring the reference's pytrees; from
one spec tree `init_params` draws the weights, a dict of tensors with the
same keys. The axes are kept so the spec trees equal the reference's; the
sharding helpers (`partition_specs`, `shardings`, `abstract_params`) have no
counterpart on one device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch


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


def tree_map(fn: Callable, tree: Any) -> Any:
    """`fn` on every leaf of a tree of nested dicts (keys kept)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree: Any) -> list:
    """Leaves in the reference's flatten order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def stack_specs(tree: Any, n: int, axis_name: Optional[str] = "layers"
                ) -> Any:
    """Prepend a stacked-layer axis to every spec in the tree."""
    def f(s: ParamSpec) -> ParamSpec:
        return ParamSpec(shape=(n,) + s.shape, axes=(axis_name,) + s.axes,
                         init=s.init, scale=s.scale,
                         fan_in_dims=tuple(d + 1 for d in s.fan_in_dims))
    return tree_map(f, tree)


def init_params(tree: Any, generator: torch.Generator, device,
                dtype=torch.float32) -> Any:
    """Random weights for a spec tree: normal with std `scale` or
    1/sqrt(fan_in), zeros or ones, as the reference's `init_params`.

    Draws leaf by leaf in the reference's flatten order from `generator`
    (which must live on `device`); the bits differ from jax's, so parity
    tests carry the reference's weights across (`interop.params_from_numpy`).
    """
    dev = torch.device(device)

    def one(s: ParamSpec) -> torch.Tensor:
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=dtype, device=dev)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=dtype, device=dev)
        fan_in = math.prod(s.shape[d] for d in s.fan_in_dims) or 1
        std = s.scale if s.scale is not None else 1.0 / math.sqrt(fan_in)
        out = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                          device=dev)
        return out.mul_(std).to(dtype)

    def walk(t):
        if not isinstance(t, dict):
            return one(t)
        out = {k: walk(t[k]) for k in sorted(t)}     # draw in sorted order
        return {k: out[k] for k in t}

    return walk(tree)


def count_params(tree: Any) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(tree))
