"""Architecture/config system (a copy of `repro.configs.base`).

One `ModelConfig` covers all ten architecture families of the reference;
each `repro_torch/configs/<arch>.py` instantiates the exact published
numbers and a `smoke()` reduction of the same family for CPU tests.
Input-shape cells (train_4k / prefill_32k / decode_32k / long_500k) are
defined here as `ShapeCell`s with per-family skip logic.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    expert_d_ff: int
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    conv_width: int = 4
    chunk_len: int = 256


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int                              # table size (may be padded)
    vocab_real: Optional[int] = None        # true vocab when `vocab` padded
    head_dim: Optional[int] = None          # default d_model // n_heads
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2-style): attention block shared + inserted every k layers
    attn_every: int = 0                     # 0 = per family default
    # encoder-decoder split (seamless): n_layers = enc + dec
    encoder_layers: int = 0
    activation: str = "swiglu"              # swiglu | gelu
    use_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # modality frontend stub: number of precomputed embedding positions the
    # input_specs provide ([audio]/[vlm] archs; DESIGN.md §5)
    frontend_embeds: int = 0
    optimizer: str = "adamw"                # adamw | adafactor (DESIGN.md §7)
    remat_policy: str = "nothing_saveable"
    # attention implementation threshold: sequences longer than this use the
    # blockwise (flash) attention path so prefill_32k lowers within memory
    flash_block_q: int = 1024
    flash_block_kv: int = 1024
    sub_quadratic: bool = False             # True for ssm/hybrid (long_500k)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def real_vocab(self) -> int:
        """True vocabulary size; `vocab` may be padded for TP divisibility
        (standard practice — MaxText/Megatron pad to the TP degree). Loss
        and sampling mask logits beyond this index."""
        return self.vocab_real or self.vocab

    @property
    def decoder_layers(self) -> int:
        return self.n_layers - self.encoder_layers

    def param_count(self) -> int:
        """Approximate parameter count (reported in dry-run tables)."""
        d, v = self.d_model, self.vocab
        if self.n_heads > 0:
            hd = self.resolved_head_dim
            attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
                + self.n_heads * hd * d
        else:                       # attention-free (pure SSM)
            attn = 0
        if self.moe:
            ff = self.moe.n_experts * 3 * d * self.moe.expert_d_ff \
                + d * self.moe.n_experts
        elif self.family in ("ssm",):
            ff = 0
        else:
            mult = 3 if self.activation == "swiglu" else 2
            ff = mult * d * self.d_ff
        if self.family == "ssm" or (self.family == "hybrid"):
            s = self.ssm
            d_in = s.expand * d
            ssm_block = d * (2 * d_in + 2 * s.n_groups * s.d_state
                             + d_in // s.head_dim) + d_in * d
            if self.family == "ssm":
                per_layer = ssm_block
            else:
                n_attn = self.n_layers // max(self.attn_every, 1)
                mult = 3 if self.activation == "swiglu" else 2
                per_layer = ssm_block + (attn + mult * d * self.d_ff) \
                    * n_attn / max(self.n_layers, 1)
        else:
            per_layer = attn + ff
        cross = attn if self.family == "encdec" else 0
        total = self.n_layers * (per_layer + cross * 0.5) + 2 * v * d
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k experts only)."""
        if not self.moe:
            return self.param_count()
        d = self.d_model
        dense_part = self.param_count() - self.n_layers * (
            self.moe.n_experts * 3 * d * self.moe.expert_d_ff)
        active_ff = self.n_layers * self.moe.top_k * 3 * d \
            * self.moe.expert_d_ff
        return int(dense_part + active_ff)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4_096, 256, "train"),
    ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    ShapeCell("decode_32k", 32_768, 128, "decode"),
    ShapeCell("long_500k", 524_288, 1, "decode"),
)


def shape_by_name(name: str) -> ShapeCell:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def cell_applicable(cfg: ModelConfig, cell: ShapeCell) -> Tuple[bool, str]:
    """Skip policy (DESIGN.md §6). Returns (runnable, reason)."""
    if cell.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention arch: 500k-token decode skipped "
                       "per assignment brief (sub-quadratic archs only)")
    return True, ""
