"""Points per compress call at which the host drained the device's stream:
the program's ``rans.wait`` spans, one at each blocking copy batch and
at each operation that synchronises inside."""

from portbench import spans


def read(ctx):
    return spans.count_per_call(ctx, "encode", "rans.wait")
