"""Trace transforms on tensors: validation, slicing, concatenation, padding.

Port of `repro.core.traffic.transform`. A trace is a dict of per-interval
arrays (`ext_load` [T, C], `mem_load` [T], `int_load` [T, C], `ext_frac`
[]) plus optional `t_mask` [T], `dest` [C, C] and `app`. Values may be numpy
arrays or tensors; transforms return tensors. Every transform validates its
input first, so a malformed trace fails here with a clear message.

The ragged-T contract: a padded trace carries a `t_mask` validity vector and
the engine guarantees masked intervals contribute exactly zero to every
reduction and freeze the simulation carry.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import backend

# The array keys every trace must carry. "dest" is [C, C] and time-free: it
# is carried whole by every transform except `slice_trace` (chiplet axis) and
# `concat_traces` (load-weighted mix).
TRACE_KEYS = ("ext_load", "mem_load", "int_load", "ext_frac")
_META_KEYS = ("app", "t_mask", "dest")


def _t(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            backend.count_host_read("traffic._np", x.nbytes)
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _is_array(v) -> bool:
    return isinstance(v, (torch.Tensor, np.ndarray)) and v.ndim >= 1


def renormalize_rows(dest) -> torch.Tensor:
    """Re-normalize a destination matrix's rows after masking/slicing; rows
    whose mass was entirely masked away go to all-zero."""
    dest = _t(dest).to(torch.float32)
    row = torch.sum(dest, dim=-1, keepdim=True)
    return torch.where(row > 0.0, dest / torch.clamp_min(row, 1e-12),
                       torch.zeros_like(dest))


def validate_trace(trace, who: str = "trace") -> dict:
    """Check that `trace` is a well-formed trace dict; return it.

    Raises TypeError for non-dicts and ValueError for missing keys, NaN or
    negative loads, and malformed destination matrices.

    Keys, dtypes and shapes need no values. The values of a tensor on the
    card reduce there, and the reductions are read back together once
    (`_values_bad`); only a fault, or an array the reductions do not take,
    sends the trace to the host path, which raises the message.
    """
    if not _meta_ok(trace) or _values_bad(*_value_arrays([trace], trace)):
        _check_on_host([trace], [who])
    return trace


def _check_one_on_host(trace, who: str) -> None:
    if not isinstance(trace, dict):
        raise TypeError(
            f"{who} must be a trace dict with keys {TRACE_KEYS} "
            f"(see repro_torch.core.traffic.generate), got "
            f"{type(trace).__name__}: {trace!r:.80}")
    missing = [k for k in TRACE_KEYS if k not in trace]
    if missing:
        raise ValueError(
            f"{who} is missing {missing}; a trace dict needs {TRACE_KEYS} "
            f"(generate one with repro_torch.core.traffic.generate)")
    for k in TRACE_KEYS:
        arr = _np(trace[k])
        if not np.issubdtype(arr.dtype, np.number):
            raise ValueError(
                f"{who}[{k!r}] must be numeric, got dtype {arr.dtype}")
        if np.isnan(arr).any():
            raise ValueError(
                f"{who}[{k!r}] contains NaN — injected loads must be finite")
        if (arr < 0).any():
            raise ValueError(
                f"{who}[{k!r}] contains negative values (min "
                f"{float(arr.min()):g}) — loads are non-negative "
                f"flit rates")
    d = trace.get("dest")
    if d is not None:
        arr = _np(d)
        c = int(np.shape(trace["ext_load"])[-1])
        if arr.ndim not in (2, 3) or arr.shape[-2] != arr.shape[-1] \
                or arr.shape[-1] != c:
            raise ValueError(
                f"{who}['dest'] must be a square [C, C] destination matrix "
                f"(optionally with one leading batch axis) matching the "
                f"trace's chiplet axis (C={c}), got shape {arr.shape}")
        if not np.isfinite(arr).all() or (arr < 0).any():
            raise ValueError(
                f"{who}['dest'] must be finite and non-negative (a "
                f"row-stochastic destination distribution)")


def _check_on_host(traces, whos) -> None:
    """The host path of `validate_trace`: each trace's every array copied
    to the host and scanned, in order, raising the first fault's message
    (`whos[i]` names `traces[i]`). Counted as a fallback."""
    backend.count_trace_check(fallback=True)
    for trace, who in zip(traces, whos):
        _check_one_on_host(trace, who)


# The dtypes whose values `_values_bad` reduces as tensors; any other sends
# the trace to the host path, which decides as numpy does.
_REDUCIBLE = (torch.float32, torch.float64, torch.float16, torch.bfloat16,
              torch.uint8, torch.int8, torch.int16, torch.int32, torch.int64)


def _size(x) -> int:
    return x.numel() if isinstance(x, torch.Tensor) else int(np.size(x))


def _reducible(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.dtype in _REDUCIBLE
    return np.asarray(x).dtype.kind in "fiu"


def _meta_ok(trace) -> bool:
    """Whether `trace` passes every check of `validate_trace` that needs no
    values: a dict with every key, real numeric (not bool) arrays, a `dest`
    of the right shape."""
    if not isinstance(trace, dict) \
            or any(k not in trace for k in TRACE_KEYS) \
            or not all(_reducible(trace[k]) for k in TRACE_KEYS) \
            or np.ndim(trace["ext_load"]) == 0:
        return False
    d = trace.get("dest")
    if d is None:
        return True
    shape = tuple(np.shape(d))
    return _reducible(d) and len(shape) in (2, 3) and shape[-2] == shape[-1] \
        == np.shape(trace["ext_load"])[-1]


# The site of the one device-to-host read of a value check.
CHECK_READ = "traffic.values_bad"


def _read(values) -> list:
    """`values` as Python numbers; those on the card are stacked and read
    back once per device."""
    out = list(values)
    on_card = {}
    for i, v in enumerate(values):
        if isinstance(v, torch.Tensor) and v.is_cuda:
            on_card.setdefault(v.device, []).append(i)
        else:
            out[i] = v.item()
    for idx in on_card.values():
        vals = [values[i] for i in idx]
        if len({v.dtype for v in vals}) > 1:
            vals = [v.to(torch.float64) for v in vals]
        host = torch.stack(vals).cpu()
        backend.count_host_read(CHECK_READ, host.nbytes)
        for i, v in zip(idx, host.tolist()):
            out[i] = v
    return out


def _values_bad(loads, dests=()) -> bool:
    """Whether a load holds NaN or a negative value, or a destination
    matrix a value that is not finite or is negative: each array reduced
    to its minimum (NaN where any value is NaN) and, for a destination
    matrix, its maximum, where it lives. Counted as one check. The arrays
    are real numeric (`_meta_ok`)."""
    backend.count_trace_check()
    lows, highs = [], []
    for x in loads:
        if _size(x):
            lows.append(torch.amin(x) if isinstance(x, torch.Tensor)
                        else np.min(x))
    for x in dests:
        if _size(x):
            lo, hi = torch.aminmax(x) if isinstance(x, torch.Tensor) \
                else (np.min(x), np.max(x))
            lows.append(lo)
            highs.append(hi)
    vals = _read(lows + highs)
    return any(not (v >= 0) for v in vals[:len(lows)]) \
        or any(v == np.inf for v in vals[len(lows):])


def _value_arrays(traces, out: dict) -> tuple:
    """The arrays whose values decide the checks of `traces` (which passed
    `_meta_ok`), stacked into `out` (one trace is its own stack): each
    key's float32 stack where every trace's array is a tensor that the
    cast keeps the sign, NaN and finiteness of (any dtype `_meta_ok` takes
    but float64), else the traces' own arrays. (loads, destination
    matrices)."""
    def arrays(k):
        if all(isinstance(tr[k], torch.Tensor)
               and tr[k].dtype != torch.float64 for tr in traces):
            return [out[k]]
        return [tr[k] for tr in traces]

    loads = [x for k in TRACE_KEYS for x in arrays(k)]
    return loads, [] if out.get("dest") is None else arrays("dest")


def stack_checked(traces: list, stack) -> dict:
    """`stack(traces)`, a dict of each key's float32 stack, with every
    trace checked as `validate_trace` checks it: the keys, dtypes and
    shapes of each first; the values of all of them at once, on the
    stacked arrays (one check, one read from the card). A fault in either
    is raised as `validate_trace(traces[i])` raises it, for the first
    trace at fault, before any error that `stack` raises."""
    whos = [f"traces[{i}]" for i in range(len(traces))]
    if not all(map(_meta_ok, traces)):
        _check_on_host(traces, whos)
        return stack(traces)
    try:
        out = stack(traces)
    except Exception:
        _check_on_host(traces, whos)
        raise
    if _values_bad(*_value_arrays(traces, out)):
        _check_on_host(traces, whos)
    return out


def trace_length(trace: dict) -> int:
    """Valid interval count: sum of `t_mask` if present, else the T axis."""
    validate_trace(trace)
    if "t_mask" in trace:
        return int(np.sum(_np(trace["t_mask"]) > 0))
    return int(np.shape(trace["ext_load"])[0])


def slice_trace(trace: dict, n_chiplets: int) -> dict:
    """Restrict a trace to its first `n_chiplets` chiplet columns (`dest`
    is sliced on both axes and its rows re-normalized)."""
    validate_trace(trace)
    c = np.shape(trace["ext_load"])[-1]
    if n_chiplets > c:
        raise ValueError(f"trace has {c} chiplets, needs >= {n_chiplets}")
    out = dict(trace,
               ext_load=_t(trace["ext_load"])[..., :n_chiplets],
               int_load=_t(trace["int_load"])[..., :n_chiplets])
    if trace.get("dest") is not None:
        out["dest"] = renormalize_rows(
            _t(trace["dest"])[..., :n_chiplets, :n_chiplets])
    return out


def _pad_time(a, pad: int) -> torch.Tensor:
    a = _t(a)
    zeros = torch.zeros((pad,) + tuple(a.shape[1:]), dtype=a.dtype,
                        device=a.device)
    return torch.cat([a, zeros], dim=0)


def pad_trace(trace: dict, n_intervals: int) -> dict:
    """Zero-pad a trace's time axis to `n_intervals`, adding a `t_mask`.

    Padded tail intervals inject zero traffic and are masked out of every
    engine reduction; already-padded traces extend their existing mask, and
    any extra per-interval array (leading axis T) is padded along.
    """
    return pad_checked(validate_trace(trace), n_intervals)


def pad_checked(trace: dict, n_intervals: int) -> dict:
    """`pad_trace` of a trace whose keys, dtypes and shapes have passed
    `validate_trace`'s checks in this call."""
    t = int(np.shape(trace["ext_load"])[0])
    if n_intervals < t:
        raise ValueError(f"cannot pad a {t}-interval trace down to "
                         f"{n_intervals} (use slice on the time axis "
                         f"explicitly instead)")
    device = _t(trace["ext_load"]).device
    mask = trace.get("t_mask")
    mask = torch.ones((t,), dtype=torch.float32, device=device) \
        if mask is None else _t(mask).to(torch.float32)
    pad = n_intervals - t
    if pad == 0:
        return dict(trace, t_mask=mask)
    out = dict(trace)
    for k in ("ext_load", "mem_load", "int_load"):
        out[k] = _pad_time(trace[k], pad)
    out["t_mask"] = _pad_time(mask, pad)
    for k, v in trace.items():
        if k in TRACE_KEYS or k in _META_KEYS:
            continue
        if _is_array(v) and v.shape[0] == t:
            out[k] = _pad_time(v, pad)
    return out


def chunk_trace(trace: dict, size: int, *, pad: bool = False):
    """Yield consecutive `size`-interval chunks of a trace (the last may be
    shorter; `pad=True` zero-pads it to `size` under a `t_mask`). Every
    per-interval key is sliced; everything else is carried whole."""
    validate_trace(trace)
    if size < 1:
        raise ValueError(f"chunk size must be >= 1, got {size}")
    t = int(np.shape(trace["ext_load"])[0])
    per_t = [k for k, v in trace.items()
             if k in ("ext_load", "mem_load", "int_load", "t_mask")
             or (_is_array(v) and k not in ("app", "dest")
                 and v.shape[0] == t)]
    for s in range(0, t, size):
        chunk = {k: (_t(v)[s:s + size] if k in per_t else v)
                 for k, v in trace.items()}
        yield pad_trace(chunk, size) if pad else chunk


def concat_traces(traces: list) -> dict:
    """Stitch traces back-to-back (Fig. 12 application-switch runs).

    `ext_frac` (and `dest`) are load-weighted means of the segments' values;
    per-interval extra keys concatenate, segment-constant ones must agree,
    anything else raises instead of being dropped.
    """
    if not traces:
        raise ValueError("concat_traces() needs at least one trace")
    for i, tr in enumerate(traces):
        validate_trace(tr, who=f"traces[{i}]")
    lens = [int(np.shape(tr["ext_load"])[0]) for tr in traces]
    out = {k: torch.cat([_t(tr[k]) for tr in traces], dim=0)
           for k in ("ext_load", "mem_load", "int_load")}

    weights = torch.stack([torch.sum(_t(tr["ext_load"]).to(torch.float32))
                           for tr in traces])
    fracs = torch.stack([_t(tr["ext_frac"]).to(torch.float32)
                         .to(weights.device) for tr in traces])
    total = torch.sum(weights)
    out["ext_frac"] = torch.where(
        total > 0.0, torch.sum(fracs * weights) / torch.clamp_min(total, 1e-12),
        torch.mean(fracs))
    out["app"] = "+".join(str(tr.get("app", "?")) for tr in traces)

    if any("t_mask" in tr for tr in traces):
        out["t_mask"] = torch.cat([
            _t(tr["t_mask"]).to(torch.float32) if "t_mask" in tr
            else torch.ones((n,), dtype=torch.float32,
                            device=weights.device)
            for tr, n in zip(traces, lens)])

    if any(tr.get("dest") is not None for tr in traces):
        if not all(tr.get("dest") is not None for tr in traces):
            raise ValueError(
                "'dest' present in only some segments — concat_traces "
                "cannot stitch a partial destination matrix")
        dests = torch.stack([_t(tr["dest"]).to(torch.float32)
                             for tr in traces])
        w = torch.where(total > 0.0, weights / torch.clamp_min(total, 1e-12),
                        torch.full_like(weights, 1.0 / len(traces)))
        out["dest"] = renormalize_rows(
            torch.sum(dests * w[:, None, None], dim=0))

    known = set(TRACE_KEYS) | set(_META_KEYS)
    extras = sorted(set().union(*(set(tr) for tr in traces)) - known)
    for k in extras:
        holders = [k in tr for tr in traces]
        if not all(holders):
            raise ValueError(
                f"key {k!r} present in only {sum(holders)}/{len(traces)} "
                f"segments — concat_traces cannot stitch a partial key")
        vals = [tr[k] for tr in traces]
        if all(_is_array(v) and v.shape[0] == n for v, n in zip(vals, lens)):
            out[k] = torch.cat([_t(v) for v in vals], dim=0)
        elif all(_values_equal(v, vals[0]) for v in vals[1:]):
            out[k] = vals[0]
        else:
            raise ValueError(
                f"key {k!r} differs across segments and is not a "
                f"per-interval array — concat_traces cannot merge it")
    return out


def _values_equal(a, b) -> bool:
    if hasattr(a, "shape") or hasattr(b, "shape"):
        return np.array_equal(_np(a), _np(b))
    return a == b
