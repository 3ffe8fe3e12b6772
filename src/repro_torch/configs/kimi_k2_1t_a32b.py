"""kimi-k2-1t-a32b [moe] — trillion-param MoE (paper-table), arXiv:2501.kimi2.

61L d_model=7168 64H (GQA kv=8) d_ff=2048 (per-expert) vocab=163840,
MoE 384 experts top-8. Adafactor optimizer (DESIGN.md §7): ~1.03T params
cannot carry 14 B/param AdamW state on 512 x 16 GB chips.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab=163_840,
    moe=MoEConfig(n_experts=384, top_k=8, expert_d_ff=2048,
                  capacity_factor=1.25),
    activation="swiglu",
    optimizer="adafactor",
)


def smoke() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="kimi-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=64, vocab=512,
        moe=MoEConfig(n_experts=8, top_k=2, expert_d_ff=64))
