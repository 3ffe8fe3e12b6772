"""Readers of the program's own span and counter totals over the measured
window (`simulator.engine_stats()`: "spans" from `backend.span`,
"host_reads" from `backend.count_host_read`, the build counters): the
difference of the snapshots taken before and after the window, per call.
Each returns None where the program keeps no such total."""
from __future__ import annotations

from typing import Callable, Optional

BUILD_KEYS = ("kernel_builds", "selection_table_builds",
              "codesign_topology_builds")


def per_call(ctx, keys, total: Callable[[dict], float]) -> Optional[float]:
    """(total(after) - total(before)) / calls, where `total` reads a
    snapshot of `engine_stats()` holding every key of `keys`."""
    if not ctx.calls or any(k not in ctx.counters_after for k in keys):
        return None
    return (total(ctx.counters_after) - total(ctx.counters_before)) \
        / len(ctx.calls)


def self_ms(ctx, keep: Callable[[str, dict], bool]) -> Optional[float]:
    """Self milliseconds a call of the spans `keep(name, record)` picks."""
    def total(stats):
        return sum(r["self_s"] for n, r in stats["spans"].items()
                   if keep(n, r))
    v = per_call(ctx, ("spans",), total)
    return None if v is None else 1e3 * v


def host_reads(ctx) -> Optional[float]:
    """Device-to-host reads a call, every site."""
    return per_call(ctx, ("host_reads",), lambda stats: sum(
        r["n"] for r in stats["host_reads"].values()))


def rebuilds(ctx) -> Optional[float]:
    """Kernel builds, selection-table and co-design topology cache misses
    a call."""
    return per_call(ctx, BUILD_KEYS, lambda stats: sum(
        stats["kernel_builds"].values()) + stats["selection_table_builds"]
        + stats["codesign_topology_builds"])
