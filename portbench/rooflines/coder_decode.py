"""A decoder's bytes: the block's stream read once (its head of flushed
states and its body), each decoded symbol written once (1 byte; the padded
symbols the format codes), and the tables read once a call.  The decoders
do not run on a block stored raw, so it adds nothing.
"""

from portbench.reference.config import WORD_BYTES
from portbench.roofline import TABLE_BYTES


def nbytes(h) -> int:
    total = TABLE_BYTES
    for size, count, raw in zip(h.block_sizes(), h.counts, h.raw):
        if not raw:
            total += int(count) * WORD_BYTES[h.variant] + size
    return total
