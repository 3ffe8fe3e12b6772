"""Model registry of the port: ModelConfig -> Model instance (the
reference's model API: `spec`, `train_loss`, `prefill`, `decode_step`)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.transformer import DecoderLM, HybridLM, SSMLM


def get_model(cfg: ModelConfig):
    if cfg.family in ("dense", "moe", "vlm"):
        return DecoderLM(cfg)
    if cfg.family == "ssm":
        return SSMLM(cfg)
    if cfg.family == "hybrid":
        return HybridLM(cfg)
    if cfg.family == "encdec":
        return EncDecLM(cfg)
    raise ValueError(f"unknown family: {cfg.family}")


__all__ = ["get_model", "DecoderLM", "SSMLM", "HybridLM", "EncDecLM"]
