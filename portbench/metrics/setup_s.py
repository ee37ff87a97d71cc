"""Seconds from the start of the process to the end of the warm-up: the
interpreter's imports, CUDA's start, any kernel build, the inputs,
the containers to decode and the warm-up calls."""


def read(ctx):
    return ctx.setup_s
