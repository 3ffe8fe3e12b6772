"""mamba2-130m [ssm] — SSD (state-space duality), arXiv:2405.21060.

24L d_model=768, attention-free (d_ff=0), vocab=50280, ssm_state=128.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50_432,            # padded to /256 for TP (real: 50280)
    vocab_real=50_280,
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64, n_groups=1,
                  chunk_len=128),  # 256->128: halves the [Q,Q] SSD
                                   # intermediates (§Perf iteration 5)
    activation="swiglu",
    rope_theta=0.0,
    sub_quadratic=True,
)


def smoke() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="mamba2-smoke", n_layers=2, d_model=64, vocab=256,
        vocab_real=None,
        ssm=SSMConfig(d_state=16, expand=2, head_dim=16, n_groups=1,
                      chunk_len=32))
