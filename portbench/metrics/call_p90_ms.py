"""90th percentile of the latency of every call in the window, failed
calls included: host clock from the call to its usable result (bytes
returned, or a device tensor after a synchronise)."""

from portbench import readers


def read(ctx):
    if ctx.trace is not None or not ctx.calls:
        return None
    return readers.quantile([c.latency_s for c in ctx.calls], 0.9) * 1e3
