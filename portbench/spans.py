"""Span arithmetic that the metric files of the program's inner spans
share: counts per call, summed time per call, and time exclusive of the
spans nested inside.

A program without these spans (an older one) records none of them, and
every reader here then returns None, so the metric is left out of the
result line.
"""

from __future__ import annotations


def _calls(ctx, direction: str) -> int:
    return sum(1 for c in ctx.calls if c.direction == direction)


def _spans(ctx, names) -> list[tuple[float, float]]:
    """The traced window's spans named in ``names``, as (start, end)."""
    names = set(names)
    return [(a, b) for name, a, b in ctx.trace.clipped(ctx.trace.host)
            if name in names]


def _union(intervals) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _overlap(xs, ys) -> float:
    """Length of the intersection of two sorted, disjoint interval lists."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def _ready(ctx, direction: str) -> int:
    """The traced calls of ``direction``, or 0 where there are none."""
    return _calls(ctx, direction) if ctx.trace is not None else 0


def count_per_call(ctx, direction: str, name: str) -> float | None:
    """Spans named ``name`` in the traced window, per call of
    ``direction``."""
    n = _ready(ctx, direction)
    found = _spans(ctx, (name,)) if n else []
    return len(found) / n if found else None


def ms_per_call(ctx, direction: str, names) -> float | None:
    """Summed time of the spans named in ``names`` per call of
    ``direction``, in ms; None unless every one of the names occurs."""
    n = _ready(ctx, direction)
    if not n:
        return None
    found = {name: _spans(ctx, (name,)) for name in names}
    if not all(found.values()):
        return None
    return sum(b - a for s in found.values() for a, b in s) / n / 1e3


def exclusive_ms_per_call(ctx, direction: str, outer,
                          inner) -> float | None:
    """Time inside the spans named in ``outer`` and outside those named in
    ``inner`` per call of ``direction``, in ms; None where no ``outer``
    span occurs."""
    n = _ready(ctx, direction)
    spans = _union(_spans(ctx, outer)) if n else []
    if not spans:
        return None
    held = sum(b - a for a, b in spans)
    return (held - _overlap(spans, _union(_spans(ctx, inner)))) / n / 1e3
