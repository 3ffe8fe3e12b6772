"""Plain PyTorch version of the `noc_step` kernel (the Fig. 13 flit model).

The counterpart of the reference's `repro.kernels.noc_step.ref`
(`lax.scan` over cycles): a Python loop over cycles with the same products
with the one-hot next-hop matrix, in the same order of operations. Every
array may carry a leading batch axis B (the written-out counterpart of
`jax.vmap` over the kernel); arrays without it are shared by all runs. The
CPU path of `ops.noc_run` and the parity tests run it; on the card it only
checks and times the kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

_F32 = torch.float32


def _vecmat(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """v @ m over a leading batch: [..., R] x [..., R, R] -> [..., R]."""
    return (v.unsqueeze(-2) @ m).squeeze(-2)


def _matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """m @ v over a leading batch: [..., R, R] x [..., R] -> [..., R]."""
    return (m @ v.unsqueeze(-1)).squeeze(-1)


def reference_noc_run(arrivals: torch.Tensor, next_mat: torch.Tensor,
                      drain_rate: torch.Tensor, buf_cap: torch.Tensor, *,
                      valid_mask: Optional[torch.Tensor] = None,
                      valid_mask_t: Optional[torch.Tensor] = None,
                      t_mask: Optional[torch.Tensor] = None,
                      link_rate: float = 1.0):
    """Run T cycles of the flit model for one run or a batch of runs.

    Args:
      arrivals: [B?, T, R] flits injected per cycle per node.
      next_mat: [B?, R, R] routing matrix (rows: source; sinks all-zero).
      drain_rate, buf_cap: [B?, R] sink drain rates and buffer capacities.
      valid_mask: [B?, R] static lane validity (None = all valid): invalid
        lanes are dead, whatever their arrival or buffer slots hold.
      valid_mask_t: [B?, T, R] time-varying lane validity, ANDed with
        `valid_mask`; a lane whose row drops to 0 drops its flits and is
        dead for exactly those cycles.
      t_mask: [B?, T] cycle validity: a masked cycle freezes the network.

    Returns (residency [B?, R], final_occupancy [B?, R], drained [B?, R]).
    """
    t, r = arrivals.shape[-2:]
    lead = arrivals.shape[:-2]
    dev = arrivals.device
    nmat = next_mat.to(_F32)
    is_router = torch.sign(torch.sum(nmat, dim=-1))
    drain = drain_rate.to(_F32)
    buf = buf_cap.to(_F32)
    mask = torch.ones(r, dtype=_F32, device=dev) if valid_mask is None \
        else valid_mask.to(_F32)
    maskt = None if valid_mask_t is None \
        else valid_mask_t.to(_F32) * mask.unsqueeze(-2)
    tmask = torch.ones(t, dtype=_F32, device=dev) if t_mask is None \
        else t_mask.to(_F32)

    zeros = torch.zeros((*lead, r), dtype=_F32, device=dev)
    occ0, resid, drained = zeros, zeros, zeros
    for i in range(t):
        m = mask if maskt is None else maskt[..., i, :]
        tm = tmask[..., i, None]
        occ = (occ0 + arrivals[..., i, :].to(_F32)) * m
        send = torch.clamp(occ, max=link_rate) * is_router
        inflow_want = _vecmat(send, nmat)
        space = torch.clamp(buf - occ, min=0.0)
        scale_dst = torch.where(
            inflow_want > 0.0,
            torch.clamp(space / torch.clamp(inflow_want, min=1e-9), max=1.0),
            0.0)
        scale_src = _matvec(nmat, scale_dst)
        moved = send * scale_src
        inflow = _vecmat(moved, nmat)
        # Flits routed into a dead lane vanish at the broken link; x 1.0
        # exactly on clean paths.
        occ = occ - moved + inflow * m
        sunk = torch.minimum(occ, drain)
        occ = occ - sunk
        occ0, resid, drained = (tm * occ + (1.0 - tm) * occ0,
                                resid + tm * occ, drained + tm * sunk)
    return resid, occ0, drained
