"""Host time per compress call turning the caller's bytes into the
device's input: the ``rans.input`` span (the uint8 copy and its upload),
ms."""

from portbench import spans


def read(ctx):
    return spans.ms_per_call(ctx, "encode", ("rans.input",))
