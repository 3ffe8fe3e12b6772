"""Plain PyTorch version of the SSD intra-chunk kernel (port of
`repro.kernels.ssd_scan.ref`, which mirrors the intra-chunk and
summary-state math of `repro.models.ssm.ssd_chunked`)."""
from __future__ import annotations

import torch


def reference_intra_chunk(x, dt, a, b_in, c_in):
    """x [B, NC, Q, H, P], dt [B, NC, Q, H], a [H], b_in / c_in
    [B, NC, Q, G, N] with G dividing H (G = H: head-broadcast, as the
    reference's contract; G < H: head h reads group h // (H / G)).

    Returns (y_intra [B, NC, Q, H, P], s_chunk [B, NC, H, P, N]), float32.
    """
    bsz, nc, q, h, p = x.shape
    g, n = b_in.shape[3], b_in.shape[4]
    rep = h // g
    dtf = dt.float()
    da = dtf * a.float()                                  # [B,NC,Q,H]
    cum = torch.cumsum(da, dim=2)
    seg = torch.clamp_max(cum[:, :, :, None, :] - cum[:, :, None, :, :], 0.0)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    decay = torch.where(tri[None, None, :, :, None], torch.exp(seg),
                        torch.zeros((), device=x.device))
    scores = torch.einsum("bcqgn,bckgn->bcqkg", c_in.float(), b_in.float())
    scores = scores.repeat_interleave(rep, dim=4)          # [B,NC,Q,Q,H]
    w = scores * decay * dtf[:, :, None, :, :]
    xf = x.float()
    y = torch.einsum("bcqkh,bckhp->bcqhp", w, xf)
    decay_end = torch.exp(cum[:, :, -1:, :] - cum) * dtf  # [B,NC,Q,H]
    xw = (decay_end[..., None] * xf).reshape(bsz, nc, q, g, rep, p)
    s = torch.einsum("bcqgrp,bcqgn->bcgrpn", xw, b_in.float())
    return y, s.reshape(bsz, nc, h, p, n)
