"""Level-2 ReSiPI: reconfigurable communication lanes for a trainer (port of
`repro.core.reconfig_runtime`).

The paper's mechanism (meter traffic per epoch, adjust the number of active
gateways with hysteresis, Eqs. 5-7, power-gate the idle ones and divide the
input power equally, Eq. 4) applied to a multi-GPU runtime:

  gateway            -> communication *lane*: one chunk stream of a
                        collective (a gradient all-reduce split into `lanes`
                        chunks issues `lanes` smaller collectives)
  #active gateways   -> lane width per epoch
  packets/interval   -> collective bytes per step, metered per epoch
  PCM reconfigure    -> switching to the lane width the controller picks
  laser power (Eq.4) -> an equal per-lane bandwidth share; the photonic
                        energy model reports lane energy

`laned_all_reduce` is the reference's `laned_psum` on `torch.distributed`:
one `all_reduce` per chunk, each issued asynchronously in order and waited
on before the chunks merge (`laned_psum` is kept as an alias).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import photonics
from repro_torch.core.constants import PHOTONIC_POWER
from repro_torch.core.gateway_controller import (ControllerConfig,
                                                 update_gateways)

LANE_WIDTHS = (1, 2, 4)        # lane widths provided, like Fig. 8 a-d tables

_F32 = torch.float32
_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class LaneConfig:
    """Controller configuration for communication lanes.

    l_m is the maximum allowable per-lane load in bytes per step per lane
    budget: the fraction of a lane's per-step byte budget that may be used
    before the controller widens (hysteresis as in Eqs. 6-7).
    """
    max_lanes: int = max(LANE_WIDTHS)
    min_lanes: int = 1
    l_m: float = 0.60                       # per-lane utilization knee
    lane_bytes_per_step: float = 50e9 * 1e-3  # link bytes in a ~1 ms step

    def controller(self) -> ControllerConfig:
        return ControllerConfig(l_m=self.l_m, max_gateways=self.max_lanes,
                                min_gateways=self.min_lanes)


@dataclasses.dataclass(frozen=True)
class LaneState:
    """Scalar tensors on the state's device."""
    lanes: torch.Tensor         # int32 — current lane width
    bytes_seen: torch.Tensor    # float32 — bytes accumulated this epoch
    steps_seen: torch.Tensor    # int32
    epoch: torch.Tensor         # int32

    @staticmethod
    def init(cfg: LaneConfig, device="cpu") -> "LaneState":
        def t(v, dtype):
            return torch.tensor(v, dtype=dtype, device=device)
        return LaneState(lanes=t(cfg.max_lanes, _I32),
                         bytes_seen=t(0.0, _F32), steps_seen=t(0, _I32),
                         epoch=t(0, _I32))


def meter_step(state: LaneState, bytes_this_step) -> LaneState:
    """Accumulate one step's collective traffic (Eq. 5 numerator)."""
    b = torch.as_tensor(bytes_this_step, dtype=_F32,
                        device=state.bytes_seen.device)
    return LaneState(lanes=state.lanes, bytes_seen=state.bytes_seen + b,
                     steps_seen=state.steps_seen + 1, epoch=state.epoch)


def epoch_update(state: LaneState, cfg: LaneConfig
                 ) -> Tuple[LaneState, Dict[str, torch.Tensor]]:
    """Epoch-boundary lane decision: Eqs. 5-7 with lanes as gateways."""
    steps = torch.clamp_min(state.steps_seen.to(_F32), 1.0)
    per_step = state.bytes_seen / steps
    load = per_step / (torch.tensor(cfg.lane_bytes_per_step, dtype=_F32,
                                    device=per_step.device)
                       * state.lanes.to(_F32))
    lanes_new = update_gateways(state.lanes[None], load[None],
                                cfg.controller())[0]
    rec = {"load": load, "lanes_before": state.lanes,
           "lanes_after": lanes_new,
           "reconfigured": lanes_new != state.lanes}
    dev = state.lanes.device
    return LaneState(lanes=lanes_new,
                     bytes_seen=torch.tensor(0.0, dtype=_F32, device=dev),
                     steps_seen=torch.tensor(0, dtype=_I32, device=dev),
                     epoch=state.epoch + 1), rec


def nearest_compiled_width(lanes: int,
                           widths: Sequence[int] = LANE_WIDTHS) -> int:
    """Snap a controller decision to the nearest provided lane width (ties
    to the narrower)."""
    return min(widths, key=lambda w: (abs(w - lanes), w))


# ---------------------------------------------------------------------------
# Lane materialization: chunked collectives
# ---------------------------------------------------------------------------

def _leaves(tree) -> list:
    """The tensor leaves of nested dicts, lists and tuples, in the
    reference's flattening order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _unflatten(like, leaves: list):
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            vals = {k: build(t[k]) for k in sorted(t)}
            return {k: vals[k] for k in t}   # the caller's key order
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    return build(like)


def chunk_pytree(tree: Any, lanes: int) -> list:
    """Split a tree of tensors into `lanes` chunks balanced by bytes.

    Greedy largest-first binning (the balanced gateway selection of §3.4
    applied to tensors). Returns `lanes` dicts, each mapping a leaf's flat
    index to the leaf.
    """
    if lanes < 1:
        raise ValueError(f"chunk_pytree needs lanes >= 1, got {lanes} — "
                         f"snap controller decisions through "
                         f"nearest_compiled_width first")
    leaves = _leaves(tree)
    sizes = [(leaf.numel() * leaf.element_size(), i)
             for i, leaf in enumerate(leaves)]
    sizes.sort(reverse=True)
    bins: list = [dict() for _ in range(lanes)]
    loads = [0] * lanes
    for sz, i in sizes:
        b = loads.index(min(loads))
        bins[b][i] = leaves[i]
        loads[b] += sz
    return bins


def merge_chunks(bins: list, like: Any) -> Any:
    """Inverse of chunk_pytree."""
    out = [None] * len(_leaves(like))
    for b in bins:
        for i, leaf in b.items():
            out[i] = leaf
    return _unflatten(like, out)


def _issue(leaves: list, group, async_op: bool) -> list:
    """All-reduce `leaves` flattened into one buffer per dtype: [(work,
    buffer, the leaves it holds)]."""
    out = []
    for dtype in dict.fromkeys(x.dtype for x in leaves):
        part = [x for x in leaves if x.dtype == dtype]
        flat = torch.cat([x.reshape(-1) for x in part])
        out.append((dist.all_reduce(flat, group=group, async_op=async_op),
                    flat, part))
    return out


def _unpack_flat(issued: list) -> dict:
    """{id(leaf): reduced leaf} from `_issue`'s buffers (waited on)."""
    out = {}
    for work, flat, part in issued:
        if work is not None:
            work.wait()
        at = 0
        for x in part:
            out[id(x)] = flat[at:at + x.numel()].view_as(x)
            at += x.numel()
    return out


def laned_all_reduce(tree: Any, group, lanes: int) -> Any:
    """Sum a tree of tensors over `group` as `lanes` chunk streams.

    `group=None` is the identity (the reference's `axis_name=None`
    outside `shard_map`); pass `torch.distributed.group.WORLD` for the
    default group. With `lanes <= 1` the tree is flattened and reduced by
    one `all_reduce` (design A of Fig. 3). Otherwise each chunk of
    `chunk_pytree` is flattened and issued as its own asynchronous
    `all_reduce`, in order, and every one is waited on before the chunks
    merge (design B: more lanes, each narrower). Each element's sum is the
    same whichever chunk carries it. A chunk holding several dtypes issues
    one `all_reduce` per dtype. The tree is not changed in place.
    """
    if group is None:
        return tree
    leaves = _leaves(tree)
    if lanes <= 1:
        done = _unpack_flat(_issue(leaves, group, False))
        return _unflatten(tree, [done[id(x)] for x in leaves])
    pending = [(b, _issue([b[i] for i in sorted(b)], group, True))
               for b in chunk_pytree(tree, lanes) if b]
    reduced = []
    for b, issued in pending:
        done = _unpack_flat(issued)
        reduced.append({i: done[id(x)] for i, x in b.items()})
    return merge_chunks(reduced, tree)


laned_psum = laned_all_reduce


def collective_bytes_of(tree: Any, axis_size: int) -> torch.Tensor:
    """Static per-step all-reduce traffic estimate: 2 (n - 1) / n bytes."""
    total = sum(leaf.numel() * leaf.element_size() for leaf in _leaves(tree))
    return torch.tensor(2.0 * (axis_size - 1) / axis_size * total,
                        dtype=_F32)


# ---------------------------------------------------------------------------
# Energy accounting: the photonic interposer model for lanes
# ---------------------------------------------------------------------------

def lane_energy_report(lanes_history, cfg: LaneConfig) -> dict:
    """Lane energy with the paper's power model, per epoch.

    Lanes map to gateways with 4 wavelengths each; idle lanes are
    PCM-gated and each reconfiguration pays the 2 nJ PCM cost. Units are
    model mW / nJ, for relative schedule comparisons, as in Fig. 11.
    Besides the aggregates, the report carries the cumulative audit trail:
    per-epoch running `cum_switches` / `cum_pcm_nj` ([T], epoch t includes
    the switch into epoch t) and the `switch_count` total.
    """
    hist = torch.as_tensor(lanes_history)
    max_l = cfg.max_lanes
    active = torch.arange(max_l, device=hist.device)[None, :] \
        < hist.reshape(-1, 1)
    powers = photonics.interposer_power_mw(
        active, torch.tensor(4.0, dtype=_F32, device=hist.device),
        n_gateways=max_l, mode="pcm")["total_mw"]
    changed = (torch.diff(hist) != 0).to(_F32)
    switches = torch.sum(changed)
    # Epoch 0 inherits its width (no switch); epoch t > 0 switched iff the
    # width differs from epoch t - 1's.
    cum_switches = torch.cat([torch.zeros((1,), dtype=_F32,
                                          device=hist.device),
                              torch.cumsum(changed, dim=0)])
    nj = PHOTONIC_POWER.pcmc_reconfig_nj
    return {"mean_power_mw": torch.mean(powers),
            "reconfig_nj": switches * nj,
            "mean_lanes": torch.mean(hist.to(_F32)),
            "switch_count": switches,
            "cum_switches": cum_switches,
            "cum_pcm_nj": cum_switches * nj}
