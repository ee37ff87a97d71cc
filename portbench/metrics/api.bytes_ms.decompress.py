"""Host time per decompress call turning the device's output into the
caller's bytes: the ``rans.fetch`` and ``rans.output`` spans (the copy to
the host and the final ``bytes``), ms."""

from portbench import spans


def read(ctx):
    return spans.ms_per_call(ctx, "decode", ("rans.fetch", "rans.output"))
