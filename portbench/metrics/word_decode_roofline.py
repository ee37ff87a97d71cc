"""K1 (``csrc/word_decode.cu``): percent of its device time that its
algorithmic bytes (``rooflines/coder_decode.py``) take at the card's
published bandwidth."""

from portbench import readers


def read(ctx):
    return readers.roofline_share(ctx, "word_decode")
