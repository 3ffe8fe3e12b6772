"""grok-1-314b [moe] — hf:xai-org/grok-1. 8 experts top-2.

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072, MoE 8e top-2.
Adafactor optimizer per DESIGN.md §7 (AdamW state would exceed 16 GB/chip).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32_768,
    vocab=131_072,
    moe=MoEConfig(n_experts=8, top_k=2, expert_d_ff=32_768),
    activation="gelu",
    optimizer="adafactor",
)


def smoke() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="grok1-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=512,
        moe=MoEConfig(n_experts=4, top_k=2, expert_d_ff=128))
