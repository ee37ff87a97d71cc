"""Host time per compress call blocked until the device's stream drained: the
``rans.wait`` spans, ms."""

from portbench import spans


def read(ctx):
    return spans.ms_per_call(ctx, "encode", ("rans.wait",))
