"""stablelm-3b [dense] — hf:stabilityai/stablelm (3B class).

32L d_model=2560 32H (MHA: kv=32) d_ff=6912 vocab=50304.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab=50_304,
    activation="swiglu",
)


def smoke() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="stablelm-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=160, vocab=512)
