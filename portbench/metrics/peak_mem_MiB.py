"""The most device memory one call took above what was in use when it
began: the peak of the bytes its tensors requested, after a reset of the
allocator's peaks at its start.  Read in a pass over every input after
the window, not in it.  What the codec displaces of a user's model or
data."""


def read(ctx):
    if ctx.trace is not None or not ctx.on_card or not ctx.peaks:
        return None
    return max(ctx.peaks) / 2**20
