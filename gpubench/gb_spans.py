"""Readings of the program's spans that the per-layer metrics share.

``out["spans"]`` holds ``(name, start, end)`` of every span the program's
tracer recorded in the window, from every training, on the host clock
(seconds): the host spans of each thread and, where the program has them,
its device spans (``gpu.<name>``: CUDA events placed on the host clock,
absent from the profiled training and on the CPU). Each reading is None
where no span of its name is there.
"""
from __future__ import annotations

import bisect
import statistics


def median_ms(out: dict, name: str) -> float | None:
    """The median duration of the spans ``name``, in ms."""
    d = [(b - a) * 1e3 for n, a, b in out.get("spans", ()) if n == name]
    return statistics.median(d) if d else None


def inside(out: dict, outer: str, inner: str) -> list[tuple[float, float]]:
    """For each ``outer`` span that holds the midpoint of an ``inner``
    span: its duration and the summed duration of those ``inner`` spans,
    in ms. ``outer`` spans must not overlap one another (the engine's
    steps and device steps follow one another)."""
    spans = out.get("spans", ())
    outers = sorted((a, b) for n, a, b in spans if n == outer)
    starts = [a for a, _ in outers]
    sums: dict[int, float] = {}
    for n, a, b in spans:
        if n != inner:
            continue
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid) - 1
        if i >= 0 and mid <= outers[i][1]:
            sums[i] = sums.get(i, 0.0) + (b - a) * 1e3
    return [((outers[i][1] - outers[i][0]) * 1e3, s)
            for i, s in sorted(sums.items())]


def median_inside_ms(out: dict, outer: str, inner: str) -> float | None:
    """The median over ``outer`` spans of the ``inner`` time inside each."""
    s = [x for _, x in inside(out, outer, inner)]
    return statistics.median(s) if s else None


def share(out: dict, name: str) -> float | None:
    """The spans ``name`` as a share (%) of the trainings' time."""
    s = sum(b - a for n, a, b in out.get("spans", ()) if n == name)
    return 100.0 * s / out["trained_s"] if s > 0 else None
