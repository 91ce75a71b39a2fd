"""Reading a ``torch.profiler`` window: every device activity as an
interval, their union (busy time), time by kernel name, and the idle gaps
named by the host span that was open when they fell.

Host spans come on the host's clock (``time.perf_counter`` seconds): the
program's tracer spans and the harness's own. A ``gpubench.mark`` range
recorded at a known host time ties that clock to the profiler's.
"""
from __future__ import annotations

import time

import numpy as np
import torch

MARK = "gpubench.mark"
# Kernel names of the program's bcoo_spmm launches (csrc/bcoo_spmm.cu).
BCOO_SPMM = ("spmm", "reduce_chunks")


def mark() -> float:
    """Record the mark inside an open profiler; its host time."""
    with torch.profiler.record_function(MARK):
        return time.perf_counter()


def _is_device(evt) -> bool:
    return str(getattr(evt, "device_type", "")).endswith("CUDA")


def read(prof, t_mark: float) -> dict:
    """``{"kernels": [(name, t0, t1)], "offset": s}``: each device
    activity on the host clock (seconds), with ``offset`` the profiler
    clock's lead over it."""
    events = list(prof.events())
    marks = [e for e in events if e.name == MARK and not _is_device(e)]
    if not marks:
        raise RuntimeError("the profiler kept no gpubench.mark range")
    offset = marks[0].time_range.start / 1e6 - t_mark
    kernels = [(e.name, e.time_range.start / 1e6 - offset,
                e.time_range.end / 1e6 - offset)
               for e in events if _is_device(e) and e.name != MARK
               and e.time_range.end > e.time_range.start]
    kernels.sort(key=lambda k: k[1])
    return {"kernels": kernels, "offset": offset}


def union(kernels, t0: float, t1: float) -> list[tuple[float, float]]:
    """Disjoint busy intervals of ``kernels`` clipped to ``[t0, t1]``."""
    out: list[list[float]] = []
    for _, a, b in kernels:
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def by_name(kernels, t0: float, t1: float) -> dict[str, float]:
    """Device seconds by activity name inside ``[t0, t1]``."""
    out: dict[str, float] = {}
    for name, a, b in kernels:
        a, b = max(a, t0), min(b, t1)
        if b > a:
            out[name] = out.get(name, 0.0) + (b - a)
    return out


def idle_by_span(busy, spans, t0: float, t1: float) -> dict[str, float]:
    """Idle seconds inside ``[t0, t1]`` by the innermost host span (``(name,
    start, end)``) open at each gap's middle; ``host_other`` where none
    is."""
    gaps, cur = [], t0
    for a, b in busy:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if t1 > cur:
        gaps.append((cur, t1))
    names = [s[0] for s in spans]
    s0 = np.array([s[1] for s in spans], np.float64)
    s1 = np.array([s[2] for s in spans], np.float64)
    dur = np.where(s1 > s0, s1 - s0, np.inf)
    out: dict[str, float] = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        d = np.where((s0 <= mid) & (mid <= s1), dur, np.inf)
        i = int(np.argmin(d)) if d.size else -1
        key = names[i] if i >= 0 and np.isfinite(d[i]) else "host_other"
        out[key] = out.get(key, 0.0) + (b - a)
    return out


def kernel_s(by_name_s: dict, words) -> float:
    """Device seconds of the activities whose name holds one of ``words``."""
    return sum(s for n, s in by_name_s.items() if any(w in n for w in words))
