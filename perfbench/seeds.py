"""Seeds: every draw of a run derives from `--seed` and a stream number,
so the same seed gives the same inputs and the same sample of answers."""
from __future__ import annotations

import numpy as np
import torch


def derive(seed: int, stream: int) -> int:
    """A 63-bit seed for (seed, stream), any whole `seed` accepted."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF,
             int(seed < 0), int(stream)]
    return int(np.random.SeedSequence(words).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A torch generator on `device` seeded from (seed, stream)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, stream))
    return gen


def rng(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator seeded from (seed, stream), for host-side
    choices (samples, per-call search seeds)."""
    return np.random.default_rng(derive(seed, stream))
