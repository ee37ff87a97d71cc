"""Host time per decompress call in ``api`` and its container work: the
``rans.unpack`` and ``rans.crc`` spans."""

from portbench import readers


def read(ctx):
    return readers.host_ms_per_call(ctx, "decode",
                                    ("rans.unpack", "rans.crc"))
