"""Uncompressed bytes of every completed compress call in the window over
the window's wall time, in 10^9 bytes a second."""

from portbench import readers


def read(ctx):
    return readers.gbps(ctx, "encode")
