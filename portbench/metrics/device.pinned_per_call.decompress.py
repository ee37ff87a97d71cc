"""Fetches per decompress call that crossed to the host through the
program's pinned ring: its ``rans.pinned`` spans, one a staged tensor."""

from portbench import spans


def read(ctx):
    return spans.count_per_call(ctx, "decode", "rans.pinned")
