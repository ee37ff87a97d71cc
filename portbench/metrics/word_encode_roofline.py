"""K2 (``csrc/word_encode.cu``): percent of its device time that its
algorithmic bytes (``rooflines/coder_encode.py``) take at the card's
published bandwidth."""

from portbench import readers


def read(ctx):
    return readers.roofline_share(ctx, "word_encode")
