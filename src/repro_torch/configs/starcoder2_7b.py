"""starcoder2-7b [dense] — arXiv:2402.19173. GQA, RoPE.

32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18_432,
    vocab=49_152,
    activation="gelu",          # starcoder2 uses gelu MLP
    use_bias=True,
)


def smoke() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="starcoder2-smoke", n_layers=2, d_model=96, n_heads=6,
        n_kv_heads=2, d_ff=384, vocab=512)
