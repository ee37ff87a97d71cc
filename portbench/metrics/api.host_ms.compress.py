"""Host time per compress call in ``api`` and its container work: the
``rans.crc``, ``rans.pack`` and ``rans.raw`` spans."""

from portbench import readers


def read(ctx):
    return readers.host_ms_per_call(ctx, "encode",
                                    ("rans.crc", "rans.pack", "rans.raw"))
