"""Time per compress call in ``models``: the ``rans.model`` span (the
device histogram, its fetch and the host normalisation)."""

from portbench import readers


def read(ctx):
    return readers.host_ms_per_call(ctx, "encode", ("rans.model",))
