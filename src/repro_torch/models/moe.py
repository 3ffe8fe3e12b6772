"""Mixture-of-Experts layer of the port (from `repro.models.moe`): top-k
routing, capacity-bounded sort-based dispatch, the expert products.

Dispatch is index-based (a stable argsort and a gather), as the reference's:
the [E, C] gather indices are O(E C) where a one-hot [T, E, C] dispatch
tensor is not. The router also returns the per-expert load statistics (the
Eq. 5 "packets per gateway" analogue) that `core.reconfig_runtime` reads.

Two choices keep the port's answers the reference's on every device:
`route_topk` takes the top k from a stable descending sort, so equal router
logits (frequent in bfloat16) resolve to the lower expert index first, as
`jax.lax.top_k` does; and the gate-weighted combine is a gather in which
each token sums its kept slots in ascending slot order (ascending expert
order), in float32, with no atomics. The expert products stay einsums: the
reference computes them outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import cast
from repro_torch.models.params import ParamSpec


def moe_spec(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    assert cfg.moe is not None
    d, m = cfg.d_model, cfg.moe
    e, f = m.n_experts, m.expert_d_ff
    s = {
        "router": ParamSpec((d, e), ("model_d", None), scale=0.02),
        "wi": ParamSpec((e, d, f), ("experts", "model_d", "expert_ff"),
                        fan_in_dims=(1,)),
        "wo": ParamSpec((e, f, d), ("experts", "expert_ff", "model_d"),
                        fan_in_dims=(1,)),
    }
    if cfg.activation == "swiglu":
        s["wg"] = ParamSpec((e, d, f), ("experts", "model_d", "expert_ff"),
                            fan_in_dims=(1,))
    return s


def route_topk(logits: torch.Tensor, top_k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k gates per token. logits [T, E] -> (gates [T, k] float32,
    experts [T, k] int64); ties go to the lower expert index."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates = torch.softmax(vals[:, :top_k].float(), dim=-1)
    return gates, idx[:, :top_k]


def build_dispatch(experts: torch.Tensor, n_experts: int, capacity: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """Capacity-bounded dispatch and combine indices (int64).

    Args:
      experts: [T, k] int, the chosen expert per (token, choice).
    Returns:
      gather_idx: [E, C], the token feeding each expert slot (T = empty:
        a zero pad row).
      choice_idx: [E, C], which of the k choices that slot serves.
      combine_idx: [T, k], the flat slot (e C + rank) each choice landed
        in, or E C for a dropped choice.
      kept: [T, k] bool, the choices that fit under capacity.
    A choice's rank in its expert's queue is in token order (a stable sort),
    the paper's per-packet FIFO.
    """
    t, k = experts.shape
    dev = experts.device
    flat_expert = experts.reshape(-1).long()                   # [T k]
    order = torch.argsort(flat_expert, stable=True)
    sorted_experts = flat_expert[order]
    seg_start = torch.searchsorted(
        sorted_experts, torch.arange(n_experts, device=dev), side="left")
    n = torch.arange(t * k, device=dev)
    rank = torch.empty_like(flat_expert)
    rank[order] = n - seg_start[sorted_experts]
    kept = rank < capacity

    # Dropped choices go to an extra slot E C, cut off after the scatter.
    full = n_experts * capacity
    slot = flat_expert * capacity + torch.clamp(rank, max=capacity - 1)
    slot = torch.where(kept, slot, torch.full_like(slot, full))
    gather_idx = torch.full((full + 1,), t, dtype=torch.long, device=dev)
    choice_idx = torch.zeros((full + 1,), dtype=torch.long, device=dev)
    gather_idx[slot] = n // k
    choice_idx[slot] = n % k
    return (gather_idx[:full].reshape(n_experts, capacity),
            choice_idx[:full].reshape(n_experts, capacity),
            slot.reshape(t, k), kept.reshape(t, k))


def moe_block(p, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """MoE FFN. x: [B, S, D] -> ([B, S, D], load-stats dict)."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)

    logits = torch.einsum("td,de->te", xt, cast(p["router"]))
    gates, experts = route_topk(logits, m.top_k)               # [T, k]

    capacity = int(m.capacity_factor * m.top_k * t / m.n_experts)
    capacity = max(capacity, m.top_k)
    gather_idx, _, combine_idx, kept = build_dispatch(
        experts, m.n_experts, capacity)

    # Tokens into expert-major layout [E, C, D] (row T: zeros).
    xt_pad = torch.cat([xt, xt.new_zeros((1, d))], 0)
    xe = xt_pad[gather_idx]

    h = torch.einsum("ecd,edf->ecf", xe, cast(p["wi"]))
    if cfg.activation == "swiglu":
        g = torch.einsum("ecd,edf->ecf", xe, cast(p["wg"]))
        h = F.silu(g) * h
    else:
        h = F.gelu(h, approximate="tanh")
    ye = torch.einsum("ecf,efd->ecd", h, cast(p["wo"]))        # [E, C, D]

    # Combine: each token gathers its kept slots, gate-weighted in float32,
    # and sums them in ascending slot order (a dropped choice reads the
    # zero row E C with gate 0 and sorts last).
    ye_pad = torch.cat([ye.reshape(-1, d).float(),
                        ye.new_zeros((1, d), dtype=torch.float32)], 0)
    slots, pos = torch.sort(combine_idx, dim=1)
    gate = torch.where(kept, gates, torch.zeros_like(gates)).gather(1, pos)
    part = ye_pad[slots] * gate[..., None]                     # [T, k, D]
    yt = part[:, 0]
    for j in range(1, m.top_k):
        yt = yt + part[:, j]
    y = yt.reshape(b, s, d).to(x.dtype)

    # Load stats: tokens per expert (the Eq. 5 numerator) and the aux loss.
    tokens_per_expert = torch.sum(
        F.one_hot(experts, m.n_experts).float() * kept[..., None],
        dim=(0, 1))
    me = torch.mean(torch.softmax(logits.float(), -1), dim=0)
    ce = tokens_per_expert / torch.clamp(tokens_per_expert.sum(), min=1.0)
    aux_loss = m.n_experts * torch.sum(me * ce)
    dropped = 1.0 - torch.mean(kept.float())
    stats = {"tokens_per_expert": tokens_per_expert,
             "aux_loss": aux_loss, "drop_frac": dropped}
    return y, stats
