"""Bernoulli packet arrivals of flit-level runs.

Run b injects, at each cycle and mesh router independently, a packet of
`packet_flits` flits with probability load_b / routers_b (its chiplet's
inter-chiplet packet rate spread evenly over its routers), nothing in its
sink and padded lanes. Drawn with torch's own generator on the target
device in blocks of runs, from (seed, stream)."""
from __future__ import annotations

import torch

from perfbench.seeds import generator

BLOCK_RUNS = 128


def arrivals(loads, routers, cycles: int, pad_to: int, packet_flits: int,
             seed: int, stream: int, device) -> torch.Tensor:
    """[B, cycles, pad_to] float32 arrivals of B runs."""
    gen = generator(seed, stream, device)
    b = len(loads)
    out = torch.empty((b, cycles, pad_to), dtype=torch.float32,
                      device=device)
    prob = torch.tensor([l / r for l, r in zip(loads, routers)],
                        dtype=torch.float32, device=device)
    lane = torch.arange(pad_to, device=device)
    live = lane[None, :] < torch.as_tensor(list(routers),
                                           device=device)[:, None]
    for lo in range(0, b, BLOCK_RUNS):
        hi = min(b, lo + BLOCK_RUNS)
        u = torch.rand((hi - lo, cycles, pad_to), generator=gen,
                       device=device)
        hit = (u < prob[lo:hi, None, None]) & live[lo:hi, None, :]
        out[lo:hi] = hit.to(torch.float32) * float(packet_flits)
    return out
