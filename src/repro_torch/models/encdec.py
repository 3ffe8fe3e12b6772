"""Encoder-decoder model of the port (from `repro.models.encdec`,
seamless-m4t-large-v2).

The encoder consumes precomputed modality-frontend embeddings (speech
frames; the frontend itself is a stub, as in the reference) and attends
without causal masking; the decoder is a causal LM with cross-attention
over the encoder output. Prefill projects each decoder layer's cross K/V
from the encoder memory once, uses it for the prompt and keeps it, stacked
[L, B, S_enc, G, d], for decode. Caches: (KVCache with a [n_dec] length
vector, (mem_k, mem_v)), the reference's leaves in its order. Training
(`train_loss`) runs both stacks without caches, each layer rematerialized
as the reference's `jax.checkpoint` bodies are, and projects each decoder
layer's cross K/V inside that layer.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.params import ParamSpec, stack_specs
from repro_torch.models.transformer import (_layer, _mean_loss, _positions,
                                            block_apply, remat)


def enc_block_spec(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "ln1": L.rmsnorm_spec(cfg.d_model),
        "attn": L.attention_spec(cfg),
        "ln2": L.rmsnorm_spec(cfg.d_model),
        "mlp": L.mlp_spec(cfg),
    }


def dec_block_spec(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "ln1": L.rmsnorm_spec(cfg.d_model),
        "attn": L.attention_spec(cfg),
        "ln_x": L.rmsnorm_spec(cfg.d_model),
        "xattn": L.attention_spec(cfg),
        "ln2": L.rmsnorm_spec(cfg.d_model),
        "mlp": L.mlp_spec(cfg),
    }


class EncDecLM:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.n_enc = cfg.encoder_layers
        self.n_dec = cfg.decoder_layers

    def spec(self) -> Dict[str, Any]:
        cfg = self.cfg
        return {
            "frame_proj": {"w": ParamSpec((cfg.d_model, cfg.d_model),
                                          ("model_d", None))},
            "embed": L.embed_spec(cfg),
            "encoder": stack_specs(enc_block_spec(cfg), self.n_enc),
            "ln_enc": L.rmsnorm_spec(cfg.d_model),
            "decoder": stack_specs(dec_block_spec(cfg), self.n_dec),
            "ln_f": L.rmsnorm_spec(cfg.d_model),
            "unembed": L.unembed_spec(cfg),
        }

    # -- encoder --------------------------------------------------------------
    def encode(self, params, frames: torch.Tensor) -> torch.Tensor:
        """frames: [B, S_enc, D] precomputed frontend embeddings."""
        cfg = self.cfg
        x = torch.einsum("bsd,dk->bsk", L.cast(frames),
                         L.cast(params["frame_proj"]["w"]))
        b, s, _ = x.shape
        positions = _positions(b, s, x.device)

        def layer(p_layer, xc):
            return block_apply(p_layer, xc, cfg, positions=positions,
                               causal=False)[0]

        for i in range(self.n_enc):
            x = remat("nothing_saveable", layer, _layer(params["encoder"], i),
                      x)
        return L.rmsnorm(params["ln_enc"], x, cfg.norm_eps)

    # -- decoder --------------------------------------------------------------
    def _project_memory(self, p_xattn, memory):
        cfg = self.cfg
        k = torch.einsum("bsd,dgk->bsgk", memory, L.cast(p_xattn["wk"]))
        v = torch.einsum("bsd,dgk->bsgk", memory, L.cast(p_xattn["wv"]))
        if cfg.use_bias:
            k = k + L.cast(p_xattn["bk"])
            v = v + L.cast(p_xattn["bv"])
        return k, v

    def _run_decoder(self, params, x, positions,
                     mem_kv: Tuple[torch.Tensor, torch.Tensor],
                     caches: L.KVCache):
        """mem_kv: the projected cross K/V, stacked (k, v) [L, B, S_enc, G,
        d]; caches: KVCache with a leading [n_dec] axis, written in place.
        Returns (x, new caches)."""
        cfg = self.cfg
        b, s_enc = x.shape[0], mem_kv[0].shape[2]
        mem_pos = _positions(b, s_enc, x.device)
        lengths = []
        for i in range(self.n_dec):
            p = _layer(params["decoder"], i)
            cache = L.KVCache(k=caches.k[i], v=caches.v[i],
                              length=caches.length[i])
            h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
            attn, cache = L.attention(p["attn"], h, cfg, positions=positions,
                                      causal=True, cache=cache)
            x = x + attn
            h = L.rmsnorm(p["ln_x"], x, cfg.norm_eps)
            xattn, _ = L.attention(p["xattn"], h, cfg, positions=positions,
                                   memory=(mem_kv[0][i], mem_kv[1][i]),
                                   memory_positions=mem_pos)
            x = x + xattn
            h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
            x = x + L.mlp(p["mlp"], h, cfg)
            lengths.append(cache.length)
        return x, L.KVCache(k=caches.k, v=caches.v,
                            length=torch.stack(lengths))

    def _train_decoder(self, params, x, positions, memory):
        """The decoder without caches, cross K/V projected from `memory` in
        each (rematerialized) layer."""
        cfg = self.cfg
        b, s_enc = memory.shape[0], memory.shape[1]
        mem_pos = _positions(b, s_enc, x.device)

        def layer(p, xc):
            h = L.rmsnorm(p["ln1"], xc, cfg.norm_eps)
            attn, _ = L.attention(p["attn"], h, cfg, positions=positions,
                                  causal=True)
            xc = xc + attn
            h = L.rmsnorm(p["ln_x"], xc, cfg.norm_eps)
            xattn, _ = L.attention(
                p["xattn"], h, cfg, positions=positions,
                memory=self._project_memory(p["xattn"], memory),
                memory_positions=mem_pos)
            xc = xc + xattn
            h = L.rmsnorm(p["ln2"], xc, cfg.norm_eps)
            return xc + L.mlp(p["mlp"], h, cfg)

        for i in range(self.n_dec):
            x = remat("nothing_saveable", layer, _layer(params["decoder"], i),
                      x)
        return x

    # -- api ------------------------------------------------------------------
    def train_loss(self, params, batch) -> Tuple[torch.Tensor, dict]:
        cfg = self.cfg
        memory = self.encode(params, batch["frames"])
        x = L.embed(params["embed"], batch["tokens"])
        b, s, _ = x.shape
        x = self._train_decoder(params, x, _positions(b, s, x.device),
                                memory)
        x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
        loss = _mean_loss(params, x, batch, cfg)
        return loss, {"loss": loss}

    def prefill(self, params, batch, max_len: int):
        """Encode + decoder prefill. Returns ((kv_caches, mem_kv), logits)."""
        cfg = self.cfg
        memory = self.encode(params, batch["frames"])
        x = L.embed(params["embed"], batch["tokens"])
        b, s, _ = x.shape
        caches = L.make_cache(cfg, b, max_len, x.device, n_layers=self.n_dec)
        caches.length = torch.zeros((self.n_dec,), dtype=torch.int32,
                                    device=x.device)
        # Cross K/V projected once per layer, for the prompt and for decode.
        proj = [self._project_memory(_layer(params["decoder"]["xattn"], i),
                                     memory) for i in range(self.n_dec)]
        mem_kv = tuple(torch.stack(parts) for parts in zip(*proj))
        del proj
        x, new_caches = self._run_decoder(
            params, x, _positions(b, s, x.device), mem_kv, caches)
        x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
        logits = L.unembed(params["unembed"], x[:, -1:])[:, 0]
        return (new_caches, mem_kv), logits

    def decode_step(self, params, tokens, caches):
        """tokens [B, 1] -> (logits [B, V], new caches). The KV cache is
        written in place (the returned cache shares its k / v)."""
        cfg = self.cfg
        kv_caches, mem_kv = caches
        x = L.embed(params["embed"], tokens)
        b = x.shape[0]
        pos = kv_caches.length[0].reshape(1, 1).expand(b, 1).to(torch.int32)
        x, new_caches = self._run_decoder(params, x, pos, mem_kv, kv_caches)
        x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
        logits = L.unembed(params["unembed"], x)[:, 0]
        return logits, (new_caches, mem_kv)
