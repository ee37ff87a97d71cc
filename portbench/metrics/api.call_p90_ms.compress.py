"""90th percentile of the latency of every traced compress call, failed
calls included: host clock from the call to its usable result, as
``call_p90_ms`` reads it over the timed window, here over the traced
passes (under the profiler, with the program's spans on)."""

from portbench import readers


def read(ctx):
    calls = [c.latency_s for c in ctx.calls if c.direction == "encode"]
    if ctx.trace is None or not calls:
        return None
    return readers.quantile(calls, 0.9) * 1e3
