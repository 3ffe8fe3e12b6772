"""Synthetic token data pipeline of the port (from `repro.data.pipeline`):
host-sharded, deterministic, restartable.

LM batches from a compressible synthetic distribution (a Zipf-like unigram
mixture plus local repetition), so a small model shows a visibly falling
loss. Each host draws only its slice (`host_slice`), keyed by (seed, step,
host), so a restart resumes the exact stream position. The draws are the
reference's numpy draws, so the batches equal the reference's bit for bit;
they come out as numpy arrays, which the caller moves to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.distributed import process_count, process_index


@dataclasses.dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    seed: int = 0
    repeat_p: float = 0.3       # local bigram repetition (learnable signal)
    zipf_a: float = 1.2


class SyntheticLM:
    def __init__(self, cfg: ModelConfig, dcfg: DataConfig):
        self.cfg = cfg
        self.dcfg = dcfg
        v = cfg.real_vocab
        ranks = np.arange(1, v + 1, dtype=np.float64)
        probs = ranks ** (-dcfg.zipf_a)
        self.probs = (probs / probs.sum()).astype(np.float64)

    def host_slice(self, step: int, host: int = 0, host_count: int = 1
                   ) -> Dict[str, np.ndarray]:
        d = self.dcfg
        per_host = d.global_batch // host_count
        rng = np.random.default_rng(
            np.random.SeedSequence([d.seed, step, host]))
        v = self.cfg.real_vocab
        toks = rng.choice(v, size=(per_host, d.seq_len + 1), p=self.probs)
        # local repetition: with prob repeat_p, copy the previous token, a
        # first-order structure the model can learn (loss < unigram H).
        rep = rng.random((per_host, d.seq_len)) < d.repeat_p
        toks[:, 1:][rep] = toks[:, :-1][rep]
        batch = {"tokens": toks[:, :-1].astype(np.int32),
                 "labels": toks[:, 1:].astype(np.int32)}
        if self.cfg.family == "vlm":
            batch["image_embeds"] = rng.standard_normal(
                (per_host, self.cfg.frontend_embeds, self.cfg.d_model)
            ).astype(np.float32) * 0.02
        if self.cfg.family == "encdec":
            # frames correlated with labels so cross-attention is learnable
            emb = rng.standard_normal((v, self.cfg.d_model)) * 0.02
            batch["frames"] = emb[batch["labels"]].astype(np.float32)
        return batch

    def iter_batches(self, start_step: int = 0) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.host_slice(step, process_index(), process_count())
            step += 1
