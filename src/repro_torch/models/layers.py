"""Core transformer layers (port of `repro.models.layers`): norms, RoPE, GQA
attention (dense / flash kernel / decode-with-cache), MLPs, embeddings.
Pure functions over parameter dicts mirroring the reference's trees.

Conventions: activations are bf16 (`COMPUTE_DTYPE`, read at call time),
accumulation f32, params f32 (cast at use). Tensor names: B batch, S/Q/K
sequence, D d_model, H q-heads, G kv heads, d head_dim, F d_ff, V vocab.
The reference's `shard(...)` annotations have no counterpart on one device.
Where the reference calls its blockwise `_flash_attend`, the port calls the
flash-attention kernel op (`kernels/flash_attention/ops.py`), as the TPU
path swaps in its Pallas kernel. Without causal masking (the encoder) the
reference's `_flash_attend` counts its zero padding of K and V (up to a
multiple of `flash_block_kv`) as real keys, each adding exp(0 - m) to the
softmax denominator; `_flash` pads the same way before the kernel, so the
port computes what the reference does (ROADMAP.md, queue 3, P15).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.params import ParamSpec

COMPUTE_DTYPE = torch.bfloat16
NEG_INF = -1e30


def cast(x: torch.Tensor) -> torch.Tensor:
    return x.to(COMPUTE_DTYPE)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_spec(d: int) -> Dict[str, ParamSpec]:
    return {"scale": ParamSpec((d,), ("model_d",), init="ones")}


def rmsnorm(p, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return cast(y * p["scale"].float())


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embedding, half-split. x: [..., S, n, d]; positions: [..., S]."""
    if theta <= 0:
        return x
    d = x.shape[-1]
    half = d // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions[..., None].float() * freqs            # [..., S, half]
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def attention_spec(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, h, g = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    s = {
        "wq": ParamSpec((d, h, hd), ("model_d", "heads", None)),
        "wk": ParamSpec((d, g, hd), ("model_d", "kv", None)),
        "wv": ParamSpec((d, g, hd), ("model_d", "kv", None)),
        "wo": ParamSpec((h, hd, d), ("heads", None, "model_d"),
                        fan_in_dims=(0, 1)),
    }
    if cfg.use_bias:
        s.update({
            "bq": ParamSpec((h, hd), ("heads", None), init="zeros"),
            "bk": ParamSpec((g, hd), ("kv", None), init="zeros"),
            "bv": ParamSpec((g, hd), ("kv", None), init="zeros"),
            "bo": ParamSpec((d,), ("model_d",), init="zeros"),
        })
    return s


def _project_qkv(p, x, cfg: ModelConfig, positions):
    q = torch.einsum("bsd,dhk->bshk", x, cast(p["wq"]))
    k = torch.einsum("bsd,dgk->bsgk", x, cast(p["wk"]))
    v = torch.einsum("bsd,dgk->bsgk", x, cast(p["wv"]))
    if cfg.use_bias:
        q = q + cast(p["bq"])
        k = k + cast(p["bk"])
        v = v + cast(p["bv"])
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B,S,G,d] -> [B,S,H,d] by repeating each kv head H/G times."""
    g = k.shape[2]
    if g == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // g, dim=2)


def _dense_attend(q, k, v, causal: bool, q_pos, k_pos) -> torch.Tensor:
    """Materialized-scores attention for short sequences. [B,S,H,d] io."""
    hd = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    scores = scores / math.sqrt(float(hd))
    if causal:
        mask = q_pos[:, :, None] >= k_pos[:, None, :]          # [B,Q,K]
        scores = torch.where(mask[:, None], scores,
                             torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def _check_index_positions(positions: torch.Tensor) -> None:
    """The flash kernel masks by index; the reference's blockwise path masks
    by position. They agree only for positions = arange(S) in every row."""
    s = positions.shape[-1]
    want = torch.arange(s, device=positions.device, dtype=positions.dtype)
    if not bool((positions == want).all()):
        raise ValueError("attention: the flash path masks by index, so it "
                         "needs positions = arange(S) in every row (a "
                         "prefill that starts at an empty cache)")


def _flash(q, k, v, causal: bool, cfg: ModelConfig) -> torch.Tensor:
    """The flash kernel op on [B,S,H,d] q and repeated k, v. Without causal
    masking K and V are zero-padded to a multiple of cfg.flash_block_kv
    first, as the reference's `_flash_attend` pads them (with causal
    masking its padded keys lie past every query and drop out)."""
    pad = (-k.shape[1]) % cfg.flash_block_kv
    if not causal and pad:
        k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (k, v))
    return flash_ops.flash_attention(q, k, v, causal=causal)


@dataclasses.dataclass
class KVCache:
    """Decode-time cache. k/v: [B, S_max, G, d]; length: filled positions
    (an int32 tensor). The port writes new entries into k and v in place."""
    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor


def attention(p, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor,
              causal: bool = True,
              cache: Optional[KVCache] = None,
              memory: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              memory_positions: Optional[torch.Tensor] = None,
              use_flash: Optional[bool] = None
              ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """GQA attention with four execution paths.

      * cache is None, memory is None: self-attention (train/prefill); the
        flash kernel when S > cfg.flash_block_q (or use_flash=True).
      * memory given: cross-attention over the projected encoder output
        (k, v) [B, S_enc, G, d]: RoPE on q alone, dense and non-causal, as
        the reference computes it outside its kernels.
      * cache given, S > 1: prefill into an empty cache through the flash
        kernel; K/V written into the cache in place.
      * cache given, S == 1: single-token decode, appended to the cache in
        place, attending over it.

    Returns (output [B,S,D], updated cache or None).
    """
    b, s, _ = x.shape
    h = cfg.n_heads

    if memory is not None:
        mem_k, mem_v = memory
        q = torch.einsum("bsd,dhk->bshk", x, cast(p["wq"]))
        if cfg.use_bias:
            q = q + cast(p["bq"])
        q = rope(q, positions, cfg.rope_theta)
        out = _dense_attend(q, _repeat_kv(mem_k, h), _repeat_kv(mem_v, h),
                            False, positions, memory_positions)
        new_cache = None
    elif cache is not None and s > 1:
        # Prefill-into-cache: the cache must be empty and positions arange,
        # since the kernel masks by index.
        if bool((cache.length != 0).any()):
            raise ValueError("attention: prefill into a cache that is not "
                             "empty; the flash path needs length 0")
        _check_index_positions(positions)
        q, k_new, v_new = _project_qkv(p, x, cfg, positions)
        kr = _repeat_kv(k_new, h)
        vr = _repeat_kv(v_new, h)
        out = _flash(q, kr, vr, causal, cfg)
        cache.k[:, :s] = k_new
        cache.v[:, :s] = v_new
        new_cache = KVCache(k=cache.k, v=cache.v, length=cache.length + s)
    elif cache is not None:
        # Single-token decode over the filled cache, grouped-query (kv heads
        # not repeated to q heads).
        q, k_new, v_new = _project_qkv(p, x, cfg, positions)
        idx = cache.length
        at = idx.reshape(1).long() + torch.arange(s, device=x.device)
        k_all = cache.k.index_copy_(1, at, k_new)
        v_all = cache.v.index_copy_(1, at, v_new)
        k_pos = torch.arange(k_all.shape[1], dtype=torch.int32,
                             device=x.device)
        valid_to = idx + s
        g = cfg.n_kv_heads
        rep = h // g
        hd = q.shape[-1]
        qg = q.reshape(b, s, g, rep, hd)
        scores = torch.einsum("bqgrd,bkgd->bgrqk", qg, k_all)
        scores = scores.float() / math.sqrt(float(hd))
        mask = k_pos[None, :] <= positions[:, :1]               # [B, S]
        mask = mask & (k_pos < valid_to)[None, :]
        scores = torch.where(mask[:, None, None, None, :], scores,
                             torch.full_like(scores, NEG_INF))
        w = torch.softmax(scores, dim=-1).to(q.dtype)
        out = torch.einsum("bgrqk,bkgd->bqgrd", w, v_all)
        out = out.reshape(b, s, h, hd)
        new_cache = KVCache(k=k_all, v=v_all, length=idx + s)
    else:
        q, k, v = _project_qkv(p, x, cfg, positions)
        kr = _repeat_kv(k, h)
        vr = _repeat_kv(v, h)
        flash = use_flash if use_flash is not None \
            else s > cfg.flash_block_q
        if flash:
            _check_index_positions(positions)
            out = _flash(q, kr, vr, causal, cfg)
        else:
            out = _dense_attend(q, kr, vr, causal, positions, positions)
        new_cache = None

    y = torch.einsum("bqhd,hdD->bqD", out, cast(p["wo"]))
    if cfg.use_bias:
        y = y + cast(p["bo"])
    return y, new_cache


def make_cache(cfg: ModelConfig, batch: int, max_len: int, device,
               n_layers: Optional[int] = None) -> KVCache:
    """Per-layer stacked KV cache [L, B, S_max, G, d] in the compute dtype
    (zeros, length 0)."""
    n = n_layers if n_layers is not None else cfg.decoder_layers
    shape = (n, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device),
        v=torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device),
        length=torch.zeros((), dtype=torch.int32, device=device))


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_spec(cfg: ModelConfig, d_ff: Optional[int] = None
             ) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    if cfg.activation == "swiglu":
        s = {
            "wi": ParamSpec((d, f), ("model_d", "ff")),
            "wg": ParamSpec((d, f), ("model_d", "ff")),
            "wo": ParamSpec((f, d), ("ff", "model_d")),
        }
    else:
        s = {
            "wi": ParamSpec((d, f), ("model_d", "ff")),
            "wo": ParamSpec((f, d), ("ff", "model_d")),
        }
    if cfg.use_bias:
        s["bi"] = ParamSpec((f,), ("ff",), init="zeros")
        s["bo"] = ParamSpec((d,), ("model_d",), init="zeros")
    return s


def mlp(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = torch.einsum("bsd,df->bsf", x, cast(p["wi"]))
    if cfg.use_bias:
        h = h + cast(p["bi"])
    if cfg.activation == "swiglu":
        g = torch.einsum("bsd,df->bsf", x, cast(p["wg"]))
        h = F.silu(g) * h
    else:
        h = F.gelu(h, approximate="tanh")
    y = torch.einsum("bsf,fd->bsd", h, cast(p["wo"]))
    if cfg.use_bias:
        y = y + cast(p["bo"])
    return y


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_spec(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    return {"embedding": ParamSpec((cfg.vocab, cfg.d_model),
                                   ("vocab", "model_d"), scale=0.02,
                                   fan_in_dims=(1,))}


def embed(p, tokens: torch.Tensor) -> torch.Tensor:
    # Gather, then cast: the same values as the reference's cast-then-gather
    # without a cast copy of the whole table.
    return cast(p["embedding"][tokens])


def unembed_spec(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    return {"w": ParamSpec((cfg.d_model, cfg.vocab), ("model_d", "vocab"))}


def unembed(p, x: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bsd,dv->bsv", x, cast(p["w"]))
