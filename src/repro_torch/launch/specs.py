"""Abstract input builders for every (architecture x shape) cell (port of
`repro.launch.specs`).

The builders return `meta` tensors (shapes and dtypes, nothing allocated)
for every model input, the counterparts of the reference's
ShapeDtypeStructs, plus matching partition-spec trees (tuples, one entry
per dimension; `()` replicated). Cache shapes and specs are built per model
family, so decode cells carry fully sharded KV / SSM state.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.models import get_model
from repro_torch.models import layers as L
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.transformer import HybridLM, SSMLM
from repro_torch.sharding.rules import Rules

_I32, _F32, _BF16 = torch.int32, torch.float32, torch.bfloat16


def sds(shape, dtype) -> torch.Tensor:
    """A `meta` tensor of `shape` and `dtype`."""
    return torch.empty(tuple(int(d) for d in shape), dtype=dtype,
                       device="meta")


# ---------------------------------------------------------------------------
# Batch inputs
# ---------------------------------------------------------------------------

def batch_specs(cfg: ModelConfig, cell: ShapeCell, rules: Rules
                ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(abstract batch, pspecs) for train/prefill inputs."""
    b, s = cell.global_batch, cell.seq_len
    train = cell.kind == "train"
    batch: Dict[str, Any] = {}
    specs: Dict[str, Any] = {}

    if cfg.family == "vlm":
        text = s - cfg.frontend_embeds
        batch["tokens"] = sds((b, text), _I32)
        batch["image_embeds"] = sds((b, cfg.frontend_embeds, cfg.d_model),
                                    _BF16)
        specs["tokens"] = rules.spec_for_shape((b, text), "batch", None)
        specs["image_embeds"] = rules.spec_for_shape(
            (b, cfg.frontend_embeds, cfg.d_model), "batch", None, None)
        if train:
            batch["labels"] = sds((b, text), _I32)
            specs["labels"] = rules.spec_for_shape((b, text), "batch", None)
    elif cfg.family == "encdec":
        batch["tokens"] = sds((b, s), _I32)
        batch["frames"] = sds((b, s, cfg.d_model), _BF16)
        specs["tokens"] = rules.spec_for_shape((b, s), "batch", None)
        specs["frames"] = rules.spec_for_shape((b, s, cfg.d_model),
                                               "batch", None, None)
        if train:
            batch["labels"] = sds((b, s), _I32)
            specs["labels"] = rules.spec_for_shape((b, s), "batch", None)
    else:
        batch["tokens"] = sds((b, s), _I32)
        specs["tokens"] = rules.spec_for_shape((b, s), "batch", None)
        if train:
            batch["labels"] = sds((b, s), _I32)
            specs["labels"] = rules.spec_for_shape((b, s), "batch", None)
    return batch, specs


# ---------------------------------------------------------------------------
# Decode caches (abstract + pspecs), per family
# ---------------------------------------------------------------------------

def _kv_cache_abstract(n_layers: int, b: int, max_len: int,
                       cfg: ModelConfig, lengths_shape=()):
    g, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    return L.KVCache(
        k=sds((n_layers, b, max_len, g, hd), L.COMPUTE_DTYPE),
        v=sds((n_layers, b, max_len, g, hd), L.COMPUTE_DTYPE),
        length=sds(lengths_shape, _I32))


def _kv_cache_pspec(rules: Rules, n_layers: int, b: int, max_len: int,
                    cfg: ModelConfig):
    shape = (n_layers, b, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    kv = rules.spec_for_shape(shape, None, "batch", "kv_seq", "kv", None)
    return L.KVCache(k=kv, v=kv, length=())


def _ssm_cache_abstract(cfg: ModelConfig, n_layers: int, b: int):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return (sds((n_layers, b, n_heads, s.head_dim, s.d_state), _F32),
            sds((n_layers, b, s.conv_width - 1, conv_dim), _F32))


def _ssm_cache_pspec(rules: Rules, cfg: ModelConfig, n_layers: int, b: int):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return (rules.spec_for_shape(
                (n_layers, b, n_heads, s.head_dim, s.d_state),
                None, "batch", "heads", None, None),
            rules.spec_for_shape((n_layers, b, s.conv_width - 1, conv_dim),
                                 None, "batch", None, "ff"))


def decode_cache_specs(cfg: ModelConfig, cell: ShapeCell, rules: Rules
                       ) -> Tuple[Any, Any]:
    """(abstract caches, cache pspecs) for decode cells: the KV/SSM state
    holds `seq_len` already-generated context, batch `global_batch`."""
    b, max_len = cell.global_batch, cell.seq_len
    model = get_model(cfg)

    if isinstance(model, SSMLM):
        return (_ssm_cache_abstract(cfg, cfg.n_layers, b),
                _ssm_cache_pspec(rules, cfg, cfg.n_layers, b))

    if isinstance(model, HybridLM):
        s = cfg.ssm
        d_inner = s.expand * cfg.d_model
        n_heads = d_inner // s.head_dim
        conv_dim = d_inner + 2 * s.n_groups * s.d_state
        ng, gl, tail = model.n_groups, model.group_len, model.tail
        ssm_g = (sds((ng, gl, b, n_heads, s.head_dim, s.d_state),
                     _F32),
                 sds((ng, gl, b, s.conv_width - 1, conv_dim), _F32))
        ssm_g_spec = (rules.spec_for_shape(
                          (ng, gl, b, n_heads, s.head_dim, s.d_state),
                          None, None, "batch", "heads", None, None),
                      rules.spec_for_shape(
                          (ng, gl, b, s.conv_width - 1, conv_dim),
                          None, None, "batch", None, "ff"))
        ssm_t = (_ssm_cache_abstract(cfg, tail, b) if tail else None)
        ssm_t_spec = (_ssm_cache_pspec(rules, cfg, tail, b)
                      if tail else None)
        kv = _kv_cache_abstract(ng, b, max_len, cfg, lengths_shape=(ng,))
        kv_spec = _kv_cache_pspec(rules, ng, b, max_len, cfg)
        return ((ssm_g, ssm_t), kv), ((ssm_g_spec, ssm_t_spec), kv_spec)

    if isinstance(model, EncDecLM):
        n_dec = cfg.decoder_layers
        kv = _kv_cache_abstract(n_dec, b, max_len, cfg,
                                lengths_shape=(n_dec,))
        kv_spec = _kv_cache_pspec(rules, n_dec, b, max_len, cfg)
        g, hd = cfg.n_kv_heads, cfg.resolved_head_dim
        mem_kv = (sds((n_dec, b, max_len, g, hd), L.COMPUTE_DTYPE),
                  sds((n_dec, b, max_len, g, hd), L.COMPUTE_DTYPE))
        mem_spec = (rules.spec_for_shape(
            (n_dec, b, max_len, g, hd),
            None, "batch", "kv_seq", "kv", None),) * 2
        return (kv, mem_kv), (kv_spec, mem_spec)

    # DecoderLM (dense / moe / vlm)
    kv = _kv_cache_abstract(cfg.n_layers, b, max_len, cfg)
    return kv, _kv_cache_pspec(rules, cfg.n_layers, b, max_len, cfg)


def decode_tokens_specs(cfg: ModelConfig, cell: ShapeCell, rules: Rules):
    return (sds((cell.global_batch, 1), _I32),
            rules.spec_for_shape((cell.global_batch, 1), "batch", None))
