"""Decode kernel launches per decompress call, from the wrappers' own
counters in ``ops``."""

from portbench import readers


def read(ctx):
    return readers.launches_per_call(ctx, "decode")
