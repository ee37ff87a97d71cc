"""Percent of the traced compress passes in which no kernel, copy or fill
ran on the device."""

from portbench import readers


def read(ctx):
    return readers.idle_share(ctx, "encode")
