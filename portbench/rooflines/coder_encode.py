"""An encoder's bytes: each input symbol read once (1 byte; the padded
symbols the format codes), the block's stream written once (its head of
flushed states and its body), and the tables read once a call.

A block stored raw holds no stream.  Its encoder ran all the same, and its
stream took at least the block's bytes (that is why it was stored raw), so
the encoder is given those bytes: a lower bound, never an overcount.
"""

from portbench.reference.config import WORD_BYTES
from portbench.roofline import TABLE_BYTES


def nbytes(h) -> int:
    total = TABLE_BYTES
    for size, count, raw in zip(h.block_sizes(), h.counts, h.raw):
        stream = int(count) if raw else int(count) * WORD_BYTES[h.variant]
        total += size + stream
    return total
