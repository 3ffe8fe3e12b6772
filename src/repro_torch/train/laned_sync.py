"""Laned gradient synchronization (port of `repro.train.laned_sync`): the
ReSiPI lane width as a difference in how the gradient all-reduce is issued.

`make_laned_train_step(model, group, lanes)` builds a data-parallel train
step over a `torch.distributed` group: each rank computes the gradients of
its shard of the global batch, and the sum over the group goes through
`core.reconfig_runtime.laned_all_reduce` as `lanes` chunk streams (lanes=1:
one all-reduce, the paper's design A, one deep gateway; lanes=4: four
narrower all-reduces, design B, more gateways), then is scaled by 1 / the
group's size; the loss is averaged over the group. Every width gives the
same sums. `compile_lane_variants` builds one step function per width in
LANE_WIDTHS, the counterpart of the reference's one executable per width:
the epoch controller indexes into that dict at run time.

Only the data-parallel axis runs here, as in the reference's shard_map
path; the step updates the state's tensors in place, as `make_train_step`'s
does. `group=None` is a group of one (no collective).
"""
from __future__ import annotations

from typing import Callable, Dict

import torch.distributed as dist

from repro_torch.core.reconfig_runtime import LANE_WIDTHS, laned_all_reduce
from repro_torch.models.params import tree_map
from repro_torch.train.train_step import (_zeros_for_missing,
                                          make_optimizer_for, value_and_grad)


def make_laned_train_step(model, group, lanes: int,
                          opt_overrides=None) -> Callable:
    """train_step(state, batch) with `lanes`-way chunked data-parallel
    gradient sync over `group`; `batch` is the global batch, of which rank
    r takes rows [r B / n, (r + 1) B / n)."""
    cfg = model.cfg
    _, opt_update, _ = make_optimizer_for(cfg, **(opt_overrides or {}))
    rank = 0 if group is None else dist.get_rank(group)
    size = 1 if group is None else dist.get_world_size(group)

    def commit(new, old):
        return old.copy_(new)

    def train_step(state, batch):
        rows = next(iter(batch.values())).shape[0] // size
        shard = {k: v[rank * rows:(rank + 1) * rows]
                 for k, v in batch.items()}
        loss, _, grads = value_and_grad(model, state["params"], shard)
        grads = _zeros_for_missing(grads, state["params"])
        # THE lane choice: k chunk streams of the gradient all-reduce.
        grads = laned_all_reduce(grads, group, lanes)
        inv = 1.0 / size
        grads = tree_map(lambda g: g * inv, grads)
        if group is not None:
            loss = loss.clone()
            dist.all_reduce(loss, group=group)
            loss = loss * inv
        new_params, new_opt, opt_stats = opt_update(
            grads, state["opt"], state["params"], commit=commit)
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        return new_state, {"loss": loss, **opt_stats}

    return train_step


def compile_lane_variants(model, group, state, batch,
                          opt_overrides=None) -> Dict[int, Callable]:
    """One step function per lane width (the design-time tables of §3.4);
    the epoch controller indexes into this dict at run time. Nothing is
    compiled ahead here (the kernels build at first use), so `state` and
    `batch` are not run: a step would update `state` in place."""
    del state, batch
    return {w: make_laned_train_step(model, group, w, opt_overrides)
            for w in LANE_WIDTHS}
