"""Model registry of the port: ModelConfig -> Model instance (the
reference's serving API: `spec`, `prefill`, `decode_step`)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import HybridLM, SSMLM


def get_model(cfg: ModelConfig):
    if cfg.family == "ssm":
        return SSMLM(cfg)
    if cfg.family == "hybrid":
        return HybridLM(cfg)
    if cfg.family in ("dense", "moe", "vlm", "encdec"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md, queue 1, "
            f"the LLM stack: DecoderLM, MoE, encdec, vlm)")
    raise ValueError(f"unknown family: {cfg.family}")


__all__ = ["get_model", "SSMLM", "HybridLM"]
