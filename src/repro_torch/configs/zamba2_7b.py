"""zamba2-7b [hybrid] — arXiv:2411.15242. Mamba2 + shared attention blocks.

81L d_model=3584 32H (MHA kv=32) d_ff=14336 vocab=32000, ssm_state=64.
Hybrid layout: Mamba2 backbone with a *shared* (weight-tied) attention+MLP
block inserted every `attn_every` layers, as in the Zamba family.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14_336,
    vocab=32_000,
    ssm=SSMConfig(d_state=64, expand=2, head_dim=64, n_groups=1,
                  chunk_len=128),
    attn_every=6,
    activation="swiglu",
    sub_quadratic=True,
)


def smoke() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="zamba2-smoke", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=512, attn_every=2,
        ssm=SSMConfig(d_state=16, expand=2, head_dim=16, n_groups=1,
                      chunk_len=32))
