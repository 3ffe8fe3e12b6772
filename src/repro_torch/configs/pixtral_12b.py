"""pixtral-12b [vlm] — hf:mistralai/Pixtral-12B-2409.

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072. The pixtral-ViT
vision frontend is a STUB: input_specs provides precomputed patch embeddings
prepended to the token stream (DESIGN.md §5).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14_336,
    vocab=131_072,
    activation="swiglu",
    frontend_embeds=256,        # patch embeddings per image (stub frontend)
)


def smoke() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="pixtral-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=512, frontend_embeds=8)
