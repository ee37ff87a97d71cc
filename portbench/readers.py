"""Arithmetic that the metric files under ``metrics/`` share.

Each metric file has ``read(ctx) -> float | None``; ``ctx`` is the run's
``harness.Context``.  A reader that finds nothing to read returns None and
the metric is left out of the result line.
"""

from __future__ import annotations

import math

from . import roofline


def quantile(values, q: float) -> float:
    """The ``q`` quantile with linear interpolation between the order
    statistics (``statistics.quantiles(..., method="inclusive")``)."""
    s = sorted(values)
    if not s:
        raise ValueError("no values")
    pos = q * (len(s) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def gbps(ctx, direction: str) -> float | None:
    """Uncompressed bytes of every completed call of ``direction`` in the
    window over the window's wall time, in 10^9 bytes a second."""
    if ctx.trace is not None or ctx.direction != direction:
        return None
    done = sum(c.nbytes for c in ctx.calls if c.ok)
    return done / ctx.window_s / 1e9 if done else None


def _calls(ctx, direction: str) -> int:
    return sum(1 for c in ctx.calls if c.direction == direction)


def host_ms_per_call(ctx, direction: str, spans) -> float | None:
    """Summed host time of the ``spans`` over the traced calls of
    ``direction``, per call, in ms."""
    n = _calls(ctx, direction)
    if ctx.trace is None or not n:
        return None
    return ctx.trace.host_s(set(spans)) / n * 1e3


def launches_per_call(ctx, direction: str) -> float | None:
    """Kernel launches of ``direction``'s coders (every file under
    ``kernels/`` of that direction; a ``both`` kernel is no coder) in the
    traced window, per call; None where the program keeps no counter of
    one."""
    n = _calls(ctx, direction)
    if ctx.launches is None or not n:
        return None
    counts = [v for k, v in ctx.launches.items()
              if ctx.kernels[k]["direction"] == direction]
    if None in counts:
        return None
    return sum(counts) / n


def idle_share(ctx, direction: str) -> float | None:
    """Percent of the traced window in which no kernel, copy or fill ran
    on the device."""
    if ctx.trace is None or not ctx.on_card or not _calls(ctx, direction):
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)


def copy_ms_per_call(ctx, direction: str) -> float | None:
    """Device time of the host<->device and device copies, per call, ms."""
    n = _calls(ctx, direction)
    if ctx.trace is None or not ctx.on_card or not n:
        return None
    return ctx.trace.device_s(lambda name: name.startswith("Memcpy")) \
        / n * 1e3


def byte_rule(name: str, kernel: dict):
    """``nbytes(header)`` of the kernel ``name``: ``rooflines/<name>.py``
    where that file exists, else the coder rule of its direction
    (``rooflines/coder_encode.py``, ``coder_decode.py``)."""
    from .harness import HERE, load_module  # the harness imports this

    if not (HERE / "rooflines" / f"{name}.py").is_file():
        name = f"coder_{kernel['direction']}"
    return load_module("rooflines", name).nbytes


def roofline_share(ctx, kernel: str) -> float | None:
    """Percent of the kernel's device time that its algorithmic bytes
    (its rule's, summed over the traced calls' containers) would take at
    the card's published bandwidth."""
    k = ctx.kernels[kernel]
    peak = roofline.hbm_bytes_per_s(ctx.device_kind)
    if ctx.trace is None or peak is None:
        return None
    t = ctx.trace.device_s(lambda name: k["symbol"] in name)
    rule = byte_rule(kernel, k)
    nbytes = sum(rule(c.header) for c in ctx.calls
                 if c.ok and c.header is not None
                 and c.header.variant in k["variants"])
    if t <= 0 or nbytes == 0:
        return None
    return 100.0 * nbytes / peak / t
