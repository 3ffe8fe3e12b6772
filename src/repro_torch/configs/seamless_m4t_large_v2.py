"""seamless-m4t-large-v2 [audio] — enc-dec multimodal, arXiv:2308.11596.

24L total (12 enc + 12 dec assumed split — the assignment lists the combined
depth), d_model=1024, 16H (GQA kv=16 => MHA), d_ff=8192, vocab=256206.
Modality frontend is a STUB: input_specs provides precomputed speech-frame
embeddings (DESIGN.md §5).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,
    encoder_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=256_256,           # padded to /256 for TP (real: 256206)
    vocab_real=256_206,
    activation="gelu",
    use_bias=True,
    frontend_embeds=1,          # encoder consumes frame embeddings
)


def smoke() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="seamless-smoke", n_layers=4, encoder_layers=2,
        d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
        vocab_real=None)
