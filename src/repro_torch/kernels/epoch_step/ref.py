"""Plain PyTorch version of the `epoch_step` kernel.

The counterpart of the reference's `repro.kernels.epoch_step.ref`
(`lax.scan` over `make_step`): a Python loop over the port's batched
`make_step`, with the kernel wrapper's call contract. The CPU path of
`ops.epoch_run` and the parity tests run it; on the card it serves only to
check and time the kernel.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def epoch_run_reference(state, xs: tuple, sim, tables: dict, *,
                        dest: Optional[torch.Tensor] = None,
                        faulted: bool = False,
                        lane_trace: Optional[torch.Tensor] = None,
                        knobs: Optional[Dict[str, torch.Tensor]] = None,
                        topo: Optional[dict] = None,
                        dest_index: Optional[torch.Tensor] = None,
                        pair_trace: Optional[torch.Tensor] = None,
                        kernel: Optional[str] = None
                        ) -> Tuple[object, dict]:
    """The plain interval loop over B lanes (see `simulator._loop` for the
    argument layout; `topo`, `dest_index` and `pair_trace` are the padded
    path's per-lane topology and destination matrices); returns (final
    SimState, records [B, T, ...]). It takes `ops.epoch_run`'s arguments;
    `kernel`, the card design, names nothing here (one plain loop)."""
    del kernel
    from repro_torch.core.simulator import _loop

    return _loop(state, xs, sim, tables, dest=dest, faulted=faulted,
                 lane_trace=lane_trace, knobs=knobs, topo=topo,
                 dest_index=dest_index, pair_trace=pair_trace)
