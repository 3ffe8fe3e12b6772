"""The traced window: the cell's calls under `torch.profiler`, reduced to
device busy time, device time per kernel name, the top device operations
and the idle gaps by what the host was doing.

The trace is exported as Chrome-trace JSON into a temporary directory,
read and deleted. Device activity is every event of category "kernel",
"gpu_memcpy" or "gpu_memset" inside the span of the `perfbench.window`
annotation; busy time is the union of their intervals.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Optional

WINDOW_TAG = "perfbench.window"
CALL_TAG = "perfbench.call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10
NAME_CHARS = 160
SECONDS = 2.0      # the traced window's length, after the measured one


def traced_window(drv, window_fn) -> tuple:
    """Run `window_fn(drv, SECONDS, CALL_TAG)` under the profiler after one
    untimed call (the profiler's own start-up stays outside the window).
    Returns (calls, read_trace(...) or None)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        drv.call(-1)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        with record_function(WINDOW_TAG):
            calls, _ = window_fn(drv, SECONDS, CALL_TAG)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
    return calls, read_trace(events)


def _merge(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read_trace(events: list) -> Optional[dict]:
    """{busy_s, window_s, kernel_s {name: s}, device_ops, idle_gaps} of a
    Chrome trace's events, or None without the window annotation or any
    device activity in it."""
    win = [e for e in events if e.get("ph") == "X"
           and e.get("name") == WINDOW_TAG]
    if not win:
        return None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        if b <= w0 or a >= w1:
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append((max(a, w0), min(b, w1),
                        e.get("name", "?")[:NAME_CHARS]))
        elif cat in HOST_CATS and e.get("name") != WINDOW_TAG:
            host.append((a, b, e.get("name", "?")))
    if not dev:
        return None
    kernel_s = {}
    for a, b, name in dev:
        kernel_s[name] = kernel_s.get(name, 0.0) + (b - a) * 1e-6
    busy = _merge([[a, b] for a, b, _ in dev])
    busy_us = sum(b - a for a, b in busy)
    gaps, prev = [], w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    by_label = {}
    for (a, b), label in zip(gaps, _gap_labels(gaps, host)):
        by_label[label] = by_label.get(label, 0.0) + (b - a) * 1e-6
    ops = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(by_label.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy_us * 1e-6, "window_s": (w1 - w0) * 1e-6,
            "kernel_s": kernel_s,
            "device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in idle]}


def _gap_labels(gaps: list, host: list) -> list:
    """For each gap, the innermost host event running at its midpoint:
    an operator, a runtime call, or "python" where the host ran Python
    code inside a call ("harness" outside one); a sweep over the events
    by start time."""
    host = sorted(host)
    mids = sorted(range(len(gaps)),
                  key=lambda i: 0.5 * (gaps[i][0] + gaps[i][1]))
    labels = ["harness"] * len(gaps)
    active, j = [], 0
    for i in mids:
        m = 0.5 * (gaps[i][0] + gaps[i][1])
        while j < len(host) and host[j][0] <= m:
            active.append(host[j])
            j += 1
        active = [h for h in active if h[1] >= m]
        if active:
            name = min(active, key=lambda h: h[1] - h[0])[2]
            labels[i] = "python" if name == CALL_TAG else name
    return labels


def kernel_time(trace: Optional[dict], pattern: str) -> float:
    """Device seconds of the kernels whose names match `pattern` (a
    regular expression) in the traced window."""
    import re

    if trace is None:
        return 0.0
    rx = re.compile(pattern)
    return sum(s for n, s in trace["kernel_s"].items() if rx.search(n))


def idle_share(trace: Optional[dict]) -> Optional[float]:
    """Share of the traced window in which no kernel, copy or fill ran on
    the card; None without a trace or device activity."""
    if trace is None or trace["busy_s"] <= 0.0:
        return None
    return 1.0 - trace["busy_s"] / trace["window_s"]
