"""Pieces of the comparison that decides `correct`: which calls are
compared, the error measure, and each number beside its limit."""
from __future__ import annotations

import numpy as np
import torch


class Reservoir:
    """Keeps `size` of the offered calls, each offered call equally likely
    to be kept, the choices drawn from a seeded generator (reservoir
    sampling): the calls compared are a sample of the window's, drawn
    from the seed, whatever the window's length. `slot()` says where the
    next call goes (None: not kept), so a driver copies out only what it
    keeps."""

    def __init__(self, size: int, rng: np.random.Generator):
        self.size, self.rng = size, rng
        self.slots, self.seen = [None] * size, 0

    def slot(self):
        self.seen += 1
        if self.seen <= self.size:
            return self.seen - 1
        j = int(self.rng.integers(0, self.seen))
        return j if j < self.size else None

    def put(self, slot: int, key, value) -> None:
        self.slots[slot] = (key, value)

    def offer(self, key, value) -> None:
        slot = self.slot()
        if slot is not None:
            self.put(slot, key, value)

    def items(self) -> list:
        return [s for s in self.slots if s is not None]


def scaled_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want| (at least 1e-30): an error relative
    to the field's own scale, so values near zero weigh as little as they
    matter. A non-finite value reads as infinity."""
    got = got.to(device=want.device, dtype=torch.float64)
    want = want.to(torch.float64)
    if got.shape != want.shape:
        return float("inf")
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    if got.numel() == 0:
        return 0.0
    scale = max(float(want.abs().max()), 1e-30)
    return float((got - want).abs().max()) / scale


def row_scaled_error(got: torch.Tensor, want: torch.Tensor,
                     floor: float) -> float:
    """The largest over rows (runs) of max |got - want| over the row's max
    |want|, at least `floor`: each run judged against its own scale."""
    got = got.to(device=want.device, dtype=torch.float64)
    want = want.to(torch.float64)
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        return float("inf")
    if got.numel() == 0:
        return 0.0
    diff = (got - want).abs().reshape(want.shape[0], -1).amax(dim=1)
    scale = want.abs().reshape(want.shape[0], -1).amax(dim=1) \
        .clamp_min(floor)
    return float((diff / scale).max())


def limit_checks(readings: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} in the limits' order."""
    return {k: {"value": float(readings[k]), "limit": float(limits[k])}
            for k in limits}
