"""Device time of the copies (host to device, device to host, device to
device) per decompress call, ms."""

from portbench import readers


def read(ctx):
    return readers.copy_ms_per_call(ctx, "decode")
