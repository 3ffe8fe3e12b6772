"""Optimizers of the port (from `repro.train.optim`): AdamW and Adafactor,
the cosine LR schedule and global-norm clipping, on trees of nested dicts
of tensors, in float32.

Adafactor keeps factored second moments (row and column statistics for
every leaf with two trailing axes of at least 2), no first moment and no
master copy; AdamW keeps float32 m and v. `grad_norm` is the pre-clip
global norm for AdamW and `global_norm(grads)` for Adafactor, as in the
reference.

Each update works leaf by leaf and hands every new leaf to `commit(new,
old)` as soon as it is computed; what `commit` returns goes into the
returned trees. The default keeps the new tensor (a functional update, as
the reference's); the train step passes one that writes into the old
tensor in place, so no second copy of the whole state is ever held.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.models.params import tree_leaves, tree_map

_F32 = torch.float32


def _keep_new(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    return new


def _pick(tree: Any, i: int) -> Any:
    """Item `i` of every tuple leaf of a tree."""
    return tree_map(lambda t: t[i], tree)


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

def cosine_schedule(base_lr: float, warmup: int, total: int
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.to(_F32)
        warm = base_lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * 0.5 * (1.0 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, cos)
    return lr


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.to(_F32)))
                          for leaf in tree_leaves(tree)))


def clip_by_global_norm(tree: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g * scale, tree), norm


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup: int = 100
    total_steps: int = 10_000
    clip_norm: float = 1.0


def adamw_init(params: Any) -> dict:
    zeros = lambda p: torch.zeros_like(p, dtype=_F32)  # noqa: E731
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": step}


def adamw_update(grads: Any, state: dict, params: Any, cfg: AdamWConfig, *,
                 commit: Callable = _keep_new,
                 grad_norm: Optional[torch.Tensor] = None
                 ) -> Tuple[Any, dict, dict]:
    """One AdamW step from (already summed) gradients: -> (params, state,
    {"grad_norm", "lr"}). `grad_norm`, when given, is `global_norm(grads)`
    computed by the caller."""
    step = state["step"] + 1
    stepf = step.to(_F32)
    lr = cosine_schedule(cfg.lr, cfg.warmup, cfg.total_steps)(step)
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = _clip_scale(gnorm, cfg.clip_norm)
    bias1 = 1 - cfg.b1 ** stepf
    bias2 = 1 - cfg.b2 ** stepf

    def upd(p, g, m, v):
        g = (g * scale).to(_F32)
        m_new = cfg.b1 * m + (1 - cfg.b1) * g
        v_new = cfg.b2 * v + (1 - cfg.b2) * g * g
        m_hat = m_new / bias1
        v_hat = v_new / bias2
        delta = m_hat / (torch.sqrt(v_hat) + cfg.eps) + cfg.weight_decay * p
        p_new = p - lr * delta
        return commit(p_new, p), commit(m_new, m), commit(v_new, v)

    out = tree_map(upd, params, grads, state["m"], state["v"])
    new_state = {"m": _pick(out, 1), "v": _pick(out, 2),
                 "step": commit(step, state["step"])}
    return _pick(out, 0), new_state, {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# Adafactor
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdafactorConfig:
    lr: float = 1e-3
    decay: float = 0.8           # beta2 exponent: 1 - step^-decay
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0
    warmup: int = 100
    total_steps: int = 10_000
    min_dim_factored: int = 128


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] >= 2 and shape[-2] >= 2


def adafactor_init(params: Any) -> dict:
    def one(p):
        if _factored(p.shape):
            row = torch.zeros(p.shape[:-1], dtype=_F32, device=p.device)
            col = torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=_F32,
                              device=p.device)
            return {"row": row, "col": col}
        return {"v": torch.zeros_like(p, dtype=_F32)}
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    return {"stats": tree_map(one, params), "step": step}


def adafactor_update(grads: Any, state: dict, params: Any,
                     cfg: AdafactorConfig, *,
                     commit: Callable = _keep_new,
                     grad_norm: Optional[torch.Tensor] = None
                     ) -> Tuple[Any, dict, dict]:
    """One Adafactor step: -> (params, state, {"grad_norm", "lr"})."""
    step = state["step"] + 1
    stepf = step.to(_F32)
    lr = cosine_schedule(cfg.lr, cfg.warmup, cfg.total_steps)(step)
    beta2 = 1.0 - stepf ** (-cfg.decay)
    gnorm = global_norm(grads) if grad_norm is None else grad_norm

    def upd(p, g, stat):
        g = g.to(_F32)
        g2 = g * g + cfg.eps
        if "row" in stat:
            row = beta2 * stat["row"] + (1 - beta2) * torch.mean(g2, dim=-1)
            col = beta2 * stat["col"] + (1 - beta2) * torch.mean(g2, dim=-2)
            row_mean = torch.mean(row, dim=-1, keepdim=True)
            vhat = (row[..., None] / torch.clamp(row_mean[..., None],
                                                 min=1e-30)) \
                * col[..., None, :]
            new_stat = {"row": row, "col": col}
        else:
            vhat = beta2 * stat["v"] + (1 - beta2) * g2
            new_stat = {"v": vhat}
        update = g / torch.sqrt(torch.clamp(vhat, min=cfg.eps))
        # update clipping (RMS-based, as in the Adafactor paper)
        rms = torch.sqrt(torch.mean(torch.square(update)) + 1e-30)
        update = update / torch.clamp(rms / cfg.clip_threshold, min=1.0)
        if cfg.weight_decay:
            update = update + cfg.weight_decay * p
        p_new = p - lr * update
        return commit(p_new, p), {k: commit(v, stat[k])
                                  for k, v in new_stat.items()}

    # A parameter's {"row", "col"} / {"v"} stats reach `upd` whole:
    # `tree_map` walks the parameter tree.
    out = tree_map(upd, params, grads, state["stats"])
    new_state = {"stats": _pick(out, 1),
                 "step": commit(step, state["step"])}
    return _pick(out, 0), new_state, {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# Uniform facade
# ---------------------------------------------------------------------------

def make_optimizer(name: str, **overrides):
    """Returns (init_fn, update_fn, cfg); update_fn(grads, state, params,
    commit=..., grad_norm=...)."""
    if name == "adamw":
        cfg = AdamWConfig(**overrides)
        return adamw_init, \
            lambda g, s, p, **kw: adamw_update(g, s, p, cfg, **kw), cfg
    if name == "adafactor":
        cfg = AdafactorConfig(**overrides)
        return adafactor_init, \
            lambda g, s, p, **kw: adafactor_update(g, s, p, cfg, **kw), cfg
    raise ValueError(f"unknown optimizer: {name}")
