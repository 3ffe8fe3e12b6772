"""Mamba2 blocks via the SSD (state-space duality) chunked algorithm
(arXiv:2405.21060), port of `repro.models.ssm`. Used by mamba2-130m and the
zamba2-7b hybrid.

The chunked form splits the sequence into chunks of Q tokens; within a chunk
the recurrence is computed 'attention-like' (quadratic in Q) by the
`ssd_scan` kernel op, and a single [H, P, N] state is passed between chunks
in plain PyTorch (`kernels/ssd_scan/ops.ssd_chunked`). Decode is a
constant-size state update.

Shapes: x [B, L, H, P] (H ssd-heads, P head_dim), dt [B, L, H], A [H] (<0),
B/C [B, L, G, N] (G groups shared by H / G heads each, N d_state).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models.layers import cast, rmsnorm, rmsnorm_spec
from repro_torch.models.params import ParamSpec


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b_in: torch.Tensor, c_in: torch.Tensor, chunk: int,
                initial_state: Optional[torch.Tensor] = None, *,
                intra_chunk: Optional[Callable] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan. Returns (y [B,L,H,P], final_state [B,H,P,N]).
    `intra_chunk` as in `kernels/ssd_scan/ops.ssd_chunked`."""
    l_in = x.shape[1]
    # Pad the sequence to a chunk multiple with dt=0 tokens: zero dt means
    # zero state contribution and unit decay, so padding is exact.
    pad = (-l_in) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_in = F.pad(b_in, (0, 0, 0, 0, 0, pad))
        c_in = F.pad(c_in, (0, 0, 0, 0, 0, pad))
    y, final_state = ssd_ops.ssd_chunked(x, dt, a, b_in, c_in, chunk,
                                         initial_state=initial_state,
                                         intra_chunk=intra_chunk)
    return y[:, :l_in], final_state


def ssd_decode_step(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    b_in: torch.Tensor, c_in: torch.Tensor,
                    state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token SSD update. x [B,1,H,P]; state [B,H,P,N]."""
    h = x.shape[2]
    rep = h // b_in.shape[2]
    br = torch.repeat_interleave(b_in[:, 0], rep, dim=1).float()  # [B,H,N]
    cr = torch.repeat_interleave(c_in[:, 0], rep, dim=1).float()
    dtf = dt[:, 0].float()                                       # [B,H]
    da = torch.exp(dtf * a.float())                              # [B,H]
    xf = x[:, 0].float()                                         # [B,H,P]
    new_state = (state * da[..., None, None]
                 + torch.einsum("bh,bhp,bhn->bhpn", dtf, xf, br))
    y = torch.einsum("bhn,bhpn->bhp", cr, new_state)
    return y[:, None].to(x.dtype), new_state


# ---------------------------------------------------------------------------
# Mamba2 block (in_proj -> conv -> SSD -> gated norm -> out_proj)
# ---------------------------------------------------------------------------

def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return s, d_inner, n_heads, conv_dim


def mamba_spec(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    s, d_inner, n_heads, conv_dim = _dims(cfg)
    d = cfg.d_model
    proj_out = 2 * d_inner + 2 * s.n_groups * s.d_state + n_heads
    return {
        "in_proj": ParamSpec((d, proj_out), ("model_d", "heads")),
        "conv_w": ParamSpec((s.conv_width, conv_dim), (None, "heads"),
                            scale=0.5, fan_in_dims=(0,)),
        "conv_b": ParamSpec((conv_dim,), ("heads",), init="zeros"),
        "a_log": ParamSpec((n_heads,), ("heads",), init="ones"),
        "dt_bias": ParamSpec((n_heads,), ("heads",), init="zeros"),
        "d_skip": ParamSpec((n_heads,), ("heads",), init="ones"),
        "norm": rmsnorm_spec(d_inner)["scale"],
        "out_proj": ParamSpec((d_inner, d), ("heads", "model_d")),
    }


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 conv_state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d. xbc [B,L,C]; w [W,C]; returns (y, new_state).

    new_state is the last W-1 inputs [B, W-1, C] (decode carry). The taps
    are summed in order 0..W-1, as the reference does.
    """
    width = w.shape[0]
    if conv_state is None:
        pad = torch.zeros((xbc.shape[0], width - 1, xbc.shape[2]),
                          dtype=xbc.dtype, device=xbc.device)
    else:
        pad = conv_state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)                     # [B, L+W-1, C]
    length = xbc.shape[1]
    y = xp[:, 0:length] * w[0][None, None]
    for i in range(1, width):
        y = y + xp[:, i:i + length] * w[i][None, None]
    y = F.silu(y + b[None, None])
    new_state = xp[:, -(width - 1):] if width > 1 else pad
    return y, new_state


def mamba_block(p, x: torch.Tensor, cfg: ModelConfig, *,
                ssm_state: Optional[torch.Tensor] = None,
                conv_state: Optional[torch.Tensor] = None,
                decode: bool = False):
    """Mamba2 block. x [B,L,D] -> (y [B,L,D], (ssm_state, conv_state))."""
    s, d_inner, n_heads, conv_dim = _dims(cfg)
    gn = s.n_groups * s.d_state

    proj = torch.einsum("bld,dk->blk", x, cast(p["in_proj"]))
    z, xbc, dt_raw = torch.split(proj, [d_inner, conv_dim, n_heads], dim=-1)
    xbc, new_conv = _causal_conv(xbc, cast(p["conv_w"]), cast(p["conv_b"]),
                                 conv_state)
    xs, b_in, c_in = torch.split(xbc, [d_inner, gn, gn], dim=-1)

    bsz, l = x.shape[0], x.shape[1]
    xh = xs.reshape(bsz, l, n_heads, s.head_dim)
    bh = b_in.reshape(bsz, l, s.n_groups, s.d_state)
    ch = c_in.reshape(bsz, l, s.n_groups, s.d_state)
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())

    if decode:
        y, new_state = ssd_decode_step(xh, dt, a, bh, ch, ssm_state)
    else:
        y, new_state = ssd_chunked(xh, dt, a, bh, ch, s.chunk_len,
                                   initial_state=ssm_state)
    y = y + xh * cast(p["d_skip"])[None, None, :, None]
    y = y.reshape(bsz, l, d_inner)

    y = rmsnorm({"scale": p["norm"]}, y * F.silu(z), cfg.norm_eps)
    out = torch.einsum("blk,kd->bld", y, cast(p["out_proj"]))
    return out, (new_state, new_conv)


def make_ssm_cache(cfg: ModelConfig, batch: int, n_layers: int, device):
    """Stacked per-layer (ssm_state, conv_state) decode caches, float32."""
    s, d_inner, n_heads, conv_dim = _dims(cfg)
    ssm_shape = (n_layers, batch, n_heads, s.head_dim, s.d_state)
    conv_shape = (n_layers, batch, s.conv_width - 1, conv_dim)
    return (torch.zeros(ssm_shape, dtype=torch.float32, device=device),
            torch.zeros(conv_shape, dtype=torch.float32, device=device))
