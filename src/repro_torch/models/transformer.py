"""Decoder model assemblies of the port (from `repro.models.transformer`):
dense / MoE / VLM (`DecoderLM`), the pure SSM stack (mamba2) and the hybrid
(zamba2), with the reference's model API:

    spec()                                ParamSpec tree
    train_loss(params, batch)             (loss, stats)
    prefill(params, batch, max_len)       (caches, last_logits)
    decode_step(params, tokens, caches)   (logits, caches)

Parameters are dicts of tensors with the reference's stacked leading axes;
the reference's scans over layers are Python loops over those axes, and the
per-layer caches come back stacked as the scans stack them.

Training passes no cache, so no in-place cache write sits on its path. Where
the reference wraps a scanned layer in `jax.checkpoint`, the port wraps the
layer in `torch.utils.checkpoint` (`remat`) while grad mode is on: only the
layer's input is kept, and its forward, kernel launches included, runs
again in the backward pass. `chunked_cross_entropy` recomputes each
chunk's logits the same way, so no [B, S, V] buffer is held for the
backward either.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.params import stack_specs


# ---------------------------------------------------------------------------
# Rematerialization and loss
# ---------------------------------------------------------------------------

# The reference's `jax.checkpoint_policies` by whether a policy saves
# nothing (True: recompute the layer in the backward pass) or everything
# (False: keep it all); any other name falls back to nothing_saveable, as
# the reference's `getattr(..., nothing_saveable)` does for names jax lacks.
REMAT_POLICIES = {"nothing_saveable": True, "everything_saveable": False}


def _requires_grad(tree) -> bool:
    if isinstance(tree, dict):
        return any(_requires_grad(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_requires_grad(v) for v in tree)
    return isinstance(tree, torch.Tensor) and tree.requires_grad


def remat(policy: str, fn: Callable, *args):
    """`fn(*args)`, rematerialized under `policy` when it is differentiated
    (grad mode on and an argument that requires grad); as it is
    otherwise."""
    if not (torch.is_grad_enabled() and _requires_grad(args)
            and REMAT_POLICIES.get(policy, True)):
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _chunk_nll(w, h_c, l_c, m_c, real_vocab: Optional[int]):
    logits = L.unembed({"w": w}, h_c).float()
    if real_vocab is not None and real_vocab < logits.shape[-1]:
        keep = torch.arange(logits.shape[-1], device=logits.device) \
            < real_vocab
        logits = torch.where(keep, logits, torch.full_like(logits, -1e30))
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, l_c[..., None].long())[..., 0]
    return torch.sum((lse - gold) * m_c), torch.sum(m_c)


def chunked_cross_entropy(unembed_p, hidden: torch.Tensor,
                          labels: torch.Tensor,
                          mask: Optional[torch.Tensor], chunk: int = 512,
                          real_vocab: Optional[int] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy over the vocab, a chunk of `chunk` positions at a
    time: each step makes only [B, chunk, V] logits (recomputed in the
    backward pass). Logits at indices >= real_vocab (TP padding) are set to
    -1e30 before the partition function. Returns (sum_loss, sum_weight),
    float32 scalars."""
    b, s, _ = hidden.shape
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=hidden.device)
    pad = (-s) % chunk
    hidden = F.pad(hidden, (0, 0, 0, pad))
    labels = F.pad(labels, (0, pad))
    mask = F.pad(mask.float(), (0, pad))
    sum_loss = torch.zeros((), dtype=torch.float32, device=hidden.device)
    sum_w = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(0, s + pad, chunk):
        nll, w = remat("nothing_saveable", _chunk_nll, unembed_p["w"],
                       hidden[:, c:c + chunk], labels[:, c:c + chunk],
                       mask[:, c:c + chunk], real_vocab)
        sum_loss = sum_loss + nll
        sum_w = sum_w + w
    return sum_loss, sum_w


def _mean_loss(params, x, batch, cfg: ModelConfig) -> torch.Tensor:
    sum_loss, sum_w = chunked_cross_entropy(
        params["unembed"], x, batch["labels"], batch.get("loss_mask"),
        real_vocab=cfg.real_vocab)
    return sum_loss / torch.clamp(sum_w, min=1.0)


# ---------------------------------------------------------------------------
# Transformer decoder block (dense / moe families, the hybrid's shared block)
# ---------------------------------------------------------------------------

def block_spec(cfg: ModelConfig) -> Dict[str, Any]:
    s = {
        "ln1": L.rmsnorm_spec(cfg.d_model),
        "attn": L.attention_spec(cfg),
        "ln2": L.rmsnorm_spec(cfg.d_model),
    }
    if cfg.moe is not None:
        s["moe"] = MOE.moe_spec(cfg)
    else:
        s["mlp"] = L.mlp_spec(cfg)
    return s


def block_apply(p, x: torch.Tensor, cfg: ModelConfig, *,
                positions: torch.Tensor,
                cache: Optional[L.KVCache] = None,
                causal: bool = True):
    """-> (x, new cache or None, MoE load stats or None)."""
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    attn_out, new_cache = L.attention(p["attn"], h, cfg,
                                      positions=positions, causal=causal,
                                      cache=cache)
    x = x + attn_out
    h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    stats = None
    if cfg.moe is not None:
        ffn, stats = MOE.moe_block(p["moe"], h, cfg)
    else:
        ffn = L.mlp(p["mlp"], h, cfg)
    return x + ffn, new_cache, stats


def _zero_stats(cfg: ModelConfig, device):
    if cfg.moe is None:
        return None
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return {"tokens_per_expert": torch.zeros((cfg.moe.n_experts,),
                                             dtype=torch.float32,
                                             device=device),
            "aux_loss": zero, "drop_frac": zero}


def _layer(tree: Dict[str, Any], *idx: int) -> Dict[str, Any]:
    """One layer's parameters out of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, *idx) for k, v in tree.items()}
    return tree[idx]


def _stack(per_layer: List[tuple]) -> tuple:
    """[(state, conv), ...] per layer -> (states [n, ...], convs [n, ...])."""
    return tuple(torch.stack(parts) for parts in zip(*per_layer))


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)


def _mamba_layer(p_layer, x, cfg: ModelConfig, cache, decode: bool):
    sstate = cstate = None
    if cache is not None:
        sstate, cstate = cache
    h = L.rmsnorm(p_layer["ln"], x, cfg.norm_eps)
    y, new_cache = SSM.mamba_block(p_layer["mamba"], h, cfg,
                                   ssm_state=sstate, conv_state=cstate,
                                   decode=decode)
    return x + y, new_cache


def _mamba_train_layer(p_layer, x, cfg: ModelConfig):
    return _mamba_layer(p_layer, x, cfg, None, False)[0]


def _mamba_layer_spec(cfg: ModelConfig) -> Dict[str, Any]:
    return {"ln": L.rmsnorm_spec(cfg.d_model), "mamba": SSM.mamba_spec(cfg)}


# ---------------------------------------------------------------------------
# Decoder-only transformer (dense / moe / vlm)
# ---------------------------------------------------------------------------

class DecoderLM:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    def spec(self) -> Dict[str, Any]:
        cfg = self.cfg
        return {
            "embed": L.embed_spec(cfg),
            "layers": stack_specs(block_spec(cfg), cfg.n_layers),
            "ln_f": L.rmsnorm_spec(cfg.d_model),
            "unembed": L.unembed_spec(cfg),
        }

    def _run_stack(self, params, x, positions, caches: L.KVCache):
        """caches: KVCache with a leading [n_layers] axis on k and v (written
        in place) and the scalar length every layer shares. Returns (x, MoE
        stats summed over the layers or None, new caches)."""
        cfg = self.cfg
        stats_acc = _zero_stats(cfg, x.device)
        for i in range(cfg.n_layers):
            cache = L.KVCache(k=caches.k[i], v=caches.v[i],
                              length=caches.length)
            x, cache, stats = block_apply(
                _layer(params["layers"], i), x, cfg, positions=positions,
                cache=cache)
            if stats is not None:
                stats_acc = {k: stats_acc[k] + stats[k] for k in stats_acc}
        new = L.KVCache(k=caches.k, v=caches.v, length=cache.length)
        return x, stats_acc, new

    def _train_stack(self, params, x, positions):
        """The layers without caches, each rematerialized: (x, MoE stats
        summed over the layers or None)."""
        cfg = self.cfg

        def layer(p_layer, xc):
            xc, _, stats = block_apply(p_layer, xc, cfg, positions=positions)
            return xc, stats

        stats_acc = _zero_stats(cfg, x.device)
        for i in range(cfg.n_layers):
            x, stats = remat(cfg.remat_policy, layer,
                             _layer(params["layers"], i), x)
            if stats is not None:
                stats_acc = {k: stats_acc[k] + stats[k] for k in stats_acc}
        return x, stats_acc

    def _embed_inputs(self, params, batch):
        """Token embeddings, after the image embeddings for a VLM batch that
        carries `image_embeds` [B, n_img, D]; positions run over both."""
        cfg = self.cfg
        x = L.embed(params["embed"], batch["tokens"])
        if cfg.family == "vlm" and "image_embeds" in batch:
            x = torch.cat([L.cast(batch["image_embeds"]), x], dim=1)
        b, s, _ = x.shape
        return x, _positions(b, s, x.device)

    def train_loss(self, params, batch) -> Tuple[torch.Tensor, dict]:
        """Mean next-token loss over the labels (a VLM's on its text tail
        only); MoE configs add 0.01 x the mean aux loss and report the load
        stats."""
        cfg = self.cfg
        x, positions = self._embed_inputs(params, batch)
        x, stats = self._train_stack(params, x, positions)
        x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
        labels = batch["labels"]
        if x.shape[1] != labels.shape[1]:       # vlm: loss on text tail only
            x = x[:, x.shape[1] - labels.shape[1]:]
        loss = _mean_loss(params, x, batch, cfg)
        out_stats = {"loss": loss}
        if stats is not None:
            aux = stats["aux_loss"] / cfg.n_layers
            out_stats.update(
                aux_loss=aux, drop_frac=stats["drop_frac"] / cfg.n_layers,
                tokens_per_expert=stats["tokens_per_expert"])
            loss = loss + 0.01 * aux
        return loss, out_stats

    def prefill(self, params, batch, max_len: int):
        cfg = self.cfg
        x, positions = self._embed_inputs(params, batch)
        caches = L.make_cache(cfg, x.shape[0], max_len, x.device,
                              n_layers=cfg.n_layers)
        x, _, new_caches = self._run_stack(params, x, positions, caches)
        x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
        logits = L.unembed(params["unembed"], x[:, -1:])[:, 0]
        return new_caches, logits

    def decode_step(self, params, tokens, caches: L.KVCache):
        """tokens [B, 1] -> (logits [B, V], new caches). The KV cache is
        written in place (the returned cache shares its k / v)."""
        cfg = self.cfg
        x = L.embed(params["embed"], tokens)
        b = x.shape[0]
        pos = caches.length.reshape(1, 1).expand(b, 1).to(torch.int32)
        x, _, new_caches = self._run_stack(params, x, pos, caches)
        x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
        logits = L.unembed(params["unembed"], x)[:, 0]
        return logits, new_caches


# ---------------------------------------------------------------------------
# Pure SSM stack (mamba2)
# ---------------------------------------------------------------------------

class SSMLM:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    def spec(self) -> Dict[str, Any]:
        cfg = self.cfg
        return {
            "embed": L.embed_spec(cfg),
            "layers": stack_specs(_mamba_layer_spec(cfg), cfg.n_layers),
            "ln_f": L.rmsnorm_spec(cfg.d_model),
            "unembed": L.unembed_spec(cfg),
        }

    def _run_stack(self, params, x, caches, decode=False):
        new = []
        for i in range(self.cfg.n_layers):
            x, c = _mamba_layer(_layer(params["layers"], i), x, self.cfg,
                                (caches[0][i], caches[1][i]), decode)
            new.append(c)
        return x, _stack(new)

    def train_loss(self, params, batch) -> Tuple[torch.Tensor, dict]:
        cfg = self.cfg
        x = L.embed(params["embed"], batch["tokens"])
        for i in range(cfg.n_layers):
            x = remat(cfg.remat_policy, _mamba_train_layer,
                      _layer(params["layers"], i), x, cfg)
        x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
        loss = _mean_loss(params, x, batch, cfg)
        return loss, {"loss": loss}

    def prefill(self, params, batch, max_len: int):
        cfg = self.cfg
        x = L.embed(params["embed"], batch["tokens"])
        caches = SSM.make_ssm_cache(cfg, x.shape[0], cfg.n_layers, x.device)
        x, new_caches = self._run_stack(params, x, caches)
        x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
        logits = L.unembed(params["unembed"], x[:, -1:])[:, 0]
        return new_caches, logits

    def decode_step(self, params, tokens, caches):
        """tokens [B, 1] -> (logits [B, V], new caches)."""
        cfg = self.cfg
        x = L.embed(params["embed"], tokens)
        x, new_caches = self._run_stack(params, x, caches, decode=True)
        x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
        logits = L.unembed(params["unembed"], x)[:, 0]
        return logits, new_caches


# ---------------------------------------------------------------------------
# Hybrid (zamba2): mamba backbone + weight-shared attention block
# ---------------------------------------------------------------------------

class HybridLM:
    """`attn_every` mamba layers per group; one *shared* attention+MLP block
    (single weight set, reused) applied after each group — the Zamba2
    architecture. Leftover layers run as a tail group without attention."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        k = cfg.attn_every or 6
        self.n_groups = cfg.n_layers // k
        self.group_len = k
        self.tail = cfg.n_layers - self.n_groups * k

    def spec(self) -> Dict[str, Any]:
        cfg = self.cfg
        layer = _mamba_layer_spec(cfg)
        s = {
            "embed": L.embed_spec(cfg),
            "groups": stack_specs(stack_specs(layer, self.group_len, None),
                                  self.n_groups),
            "shared": block_spec(cfg),       # ONE weight set, reused
            "ln_f": L.rmsnorm_spec(cfg.d_model),
            "unembed": L.unembed_spec(cfg),
        }
        if self.tail:
            s["tail"] = stack_specs(layer, self.tail)
        return s

    def _run(self, params, x, positions, ssm_caches, kv_caches,
             decode=False):
        """ssm_caches: ((states, convs) [G, gl, ...], tail or None);
        kv_caches: KVCache with a leading [n_groups] axis, written in
        place. Returns (x, new ssm caches, new kv cache)."""
        cfg = self.cfg
        (g_states, g_convs), tail_caches = ssm_caches
        new_groups, lengths = [], []
        for g in range(self.n_groups):
            new = []
            for i in range(self.group_len):
                x, c = _mamba_layer(_layer(params["groups"], g, i), x, cfg,
                                    (g_states[g, i], g_convs[g, i]), decode)
                new.append(c)
            new_groups.append(_stack(new))
            kv = L.KVCache(k=kv_caches.k[g], v=kv_caches.v[g],
                           length=kv_caches.length[g])
            x, kv, _ = block_apply(params["shared"], x, cfg,
                                   positions=positions, cache=kv,
                                   causal=True)
            lengths.append(kv.length)
        new_ssm = _stack(new_groups)
        new_tail = None
        if self.tail:
            new = []
            for i in range(self.tail):
                x, c = _mamba_layer(_layer(params["tail"], i), x, cfg,
                                    (tail_caches[0][i], tail_caches[1][i]),
                                    decode)
                new.append(c)
            new_tail = _stack(new)
        new_kv = L.KVCache(k=kv_caches.k, v=kv_caches.v,
                           length=torch.stack(lengths))
        return x, (new_ssm, new_tail), new_kv

    def train_loss(self, params, batch) -> Tuple[torch.Tensor, dict]:
        """As the reference: each mamba layer rematerialized (always
        nothing_saveable), the shared block after each group not."""
        cfg = self.cfg
        x = L.embed(params["embed"], batch["tokens"])
        b, s, _ = x.shape
        positions = _positions(b, s, x.device)
        for g in range(self.n_groups):
            for i in range(self.group_len):
                x = remat("nothing_saveable", _mamba_train_layer,
                          _layer(params["groups"], g, i), x, cfg)
            x, _, _ = block_apply(params["shared"], x, cfg,
                                  positions=positions)
        for i in range(self.tail):
            x = remat("nothing_saveable", _mamba_train_layer,
                      _layer(params["tail"], i), x, cfg)
        x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
        loss = _mean_loss(params, x, batch, cfg)
        return loss, {"loss": loss}

    def _init_caches(self, b: int, max_len: int, device):
        cfg = self.cfg
        ssm_g = SSM.make_ssm_cache(cfg, b, self.n_groups * self.group_len,
                                   device)
        ssm_g = tuple(a.reshape((self.n_groups, self.group_len)
                                + a.shape[1:]) for a in ssm_g)
        ssm_t = (SSM.make_ssm_cache(cfg, b, self.tail, device)
                 if self.tail else None)
        kv = L.make_cache(cfg, b, max_len, device, n_layers=self.n_groups)
        kv.length = torch.zeros((self.n_groups,), dtype=torch.int32,
                                device=device)
        return (ssm_g, ssm_t), kv

    def prefill(self, params, batch, max_len: int):
        cfg = self.cfg
        x = L.embed(params["embed"], batch["tokens"])
        b, s, _ = x.shape
        ssm_caches, kv = self._init_caches(b, max_len, x.device)
        x, new_ssm, new_kv = self._run(params, x, _positions(b, s, x.device),
                                       ssm_caches, kv)
        x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
        logits = L.unembed(params["unembed"], x[:, -1:])[:, 0]
        return (new_ssm, new_kv), logits

    def decode_step(self, params, tokens, caches):
        """tokens [B, 1] -> (logits [B, V], new caches). The KV cache is
        written in place (the returned cache shares its k / v)."""
        cfg = self.cfg
        ssm_caches, kv = caches
        x = L.embed(params["embed"], tokens)
        b = x.shape[0]
        pos = kv.length[0].reshape(1, 1).expand(b, 1).to(torch.int32)
        x, new_ssm, new_kv = self._run(params, x, pos, ssm_caches, kv,
                                       decode=True)
        x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
        logits = L.unembed(params["unembed"], x)[:, 0]
        return logits, (new_ssm, new_kv)
