"""command-r-plus-104b [dense] — hf:CohereForAI (104B class). GQA, no-bias.

64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12_288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=33_792,
    vocab=256_000,
    activation="swiglu",
    use_bias=False,
)


def smoke() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="commandr-smoke", n_layers=2, d_model=128, n_heads=8,
        n_kv_heads=2, d_ff=352, vocab=512)
