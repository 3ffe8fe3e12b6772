"""Plain PyTorch version of the flash-attention kernel (port of
`repro.kernels.flash_attention.ref`): the scores materialised in float32."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True) -> torch.Tensor:
    """Naive softmax attention. q,k,v: [B, H, S, d] -> [B, H, S, d] in q's
    dtype. Causal masking compares query and key indices (-1e30 below the
    diagonal's complement), as the reference's oracle does."""
    d = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        / math.sqrt(float(d))
    if causal:
        s_q, s_kv = s.shape[-2:]
        mask = (torch.arange(s_q, device=q.device)[:, None]
                >= torch.arange(s_kv, device=q.device)[None, :])
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, v.float()).to(q.dtype)
