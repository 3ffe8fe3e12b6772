"""phi4-mini-3.8b [dense] — arXiv:2412.08905. RoPE SwiGLU GQA.

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab=200_064,
    activation="swiglu",
)


def smoke() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="phi4-smoke", n_layers=2, d_model=96, n_heads=6,
        n_kv_heads=2, d_ff=256, vocab=512)
