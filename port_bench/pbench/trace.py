"""Reading a ``torch.profiler`` trace of the traced batches: device busy time
(the union of every kernel, copy and fill on the card), the same over the
kernels alone and over the device-to-host copies alone, the device
operations that took most time, and the idle gaps by what the host was doing.
"""

from __future__ import annotations

import heapq
from collections import defaultdict

TOP = 10
#: an idle gap in which no torch operation or CUDA call ran on the host
PYTHON = "host Python (no torch op or CUDA call)"


def _span_ns(e) -> tuple[int, int]:
    if hasattr(e, "start_ns"):
        return int(e.start_ns()), int(e.duration_ns())
    return int(e.start_us()) * 1000, int(e.duration_us()) * 1000


def kind_of(name: str) -> str:
    """``"d2h"`` for a device-to-host copy, ``"copy"`` for another copy,
    ``"fill"`` for a memset, ``"kernel"`` for everything else the card ran."""
    if name.startswith("Memcpy"):  # "Memcpy DtoH (Device -> Pageable)", ...
        return "d2h" if "DtoH" in name else "copy"
    return "fill" if name.startswith("Memset") else "kernel"


def _union(spans, lo: int, hi: int) -> list[list[int]]:
    merged: list[list[int]] = []
    for s, t in sorted(spans):
        s, t = max(s, lo), min(t, hi)
        if t <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return merged


def read_trace(prof, batch_span: str) -> dict:
    """``busy_s``: the union of device activity; ``kernel_s`` / ``d2h_s``: the
    union of the kernels' / of the device-to-host copies' activity;
    ``window_s``: the host spans named ``batch_span``, first start to last
    end; ``device_ops``: seconds by device operation name; ``idle_gaps``:
    idle device seconds inside the window by the innermost host operation
    running at each gap's middle (``PYTHON`` where none ran: the program's
    own Python)."""
    device, host, batches = [], [], []
    for e in prof.profiler.kineto_results.events():
        start, dur = _span_ns(e)
        if e.name() == batch_span:
            # a span is recorded on the host and mirrored on the device's
            # timeline as an annotation; the host's is the window
            if "CUDA" not in str(e.device_type()):
                batches.append((start, start + dur))
        elif getattr(e, "is_user_annotation", lambda: False)():
            continue
        elif "CUDA" in str(e.device_type()):
            device.append((start, start + dur, e.name()))
        else:
            host.append((start, start + dur, e.name()))
    if not batches:
        return {}
    lo, hi = min(b[0] for b in batches), max(b[1] for b in batches)
    ops: dict[str, float] = defaultdict(float)
    for s, t, name in device:
        ops[name] += (t - s) * 1e-9
    merged = _union(((s, t) for s, t, _ in device), lo, hi)
    busy = lambda kind: sum(  # noqa: E731
        t - s for s, t in _union(((s, t) for s, t, n in device if kind_of(n) == kind), lo, hi))
    edges = [lo] + [x for iv in merged for x in iv] + [hi]
    gaps: dict[str, float] = defaultdict(float)
    host.sort()
    active: list[tuple[int, int, str]] = []  # heap by end: the host spans open at `mid`
    k = 0
    for g0, g1 in zip(edges[::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = (g0 + g1) // 2
        while k < len(host) and host[k][0] <= mid:
            s, t, name = host[k]
            heapq.heappush(active, (t, t - s, name))
            k += 1
        while active and active[0][0] <= mid:
            heapq.heappop(active)
        gaps[min(active, key=lambda a: a[1])[2] if active else PYTHON] += (g1 - g0) * 1e-9
    top = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:TOP]  # noqa: E731
    return {"busy_s": sum(t - s for s, t in merged) * 1e-9, "kernel_s": busy("kernel") * 1e-9,
            "d2h_s": busy("d2h") * 1e-9, "window_s": (hi - lo) * 1e-9,
            "device_ops": top(ops), "idle_gaps": top(gaps)}
