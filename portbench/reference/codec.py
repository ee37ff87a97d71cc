"""``compress``: the container that the measured program's ``compress`` /
``compress_from_device`` must return for the same bytes.

Model the whole input, pad it to a multiple of 4 * n_lanes with the most
frequent symbol, code each block, store a block raw where its stream takes
at least its input bytes (rans_byte.h:28-35), CRC each block's input bytes
when the shape says so, and write the container.
"""

from __future__ import annotations

import importlib
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import container, model
from .config import WORD_BYTES, Shape, auto

#: Blocks coded together: bounds the per-step arrays (about 3 bytes a
#: symbol) and gives the threads their pieces.
BLOCKS_PER_PIECE = 2


def compress(data: np.ndarray, shape: Shape | None = None,
             checksum: bool = True, threads: int = 4) -> bytes:
    """uint8 ``data`` -> container bytes.  ``shape`` defaults to the
    size-adaptive rule (``config.auto``).  Blocks are coded on up to
    ``threads`` host threads (NumPy's loops release the interpreter lock)."""
    data = np.ascontiguousarray(data, np.uint8).reshape(-1)
    shape = shape or auto(data.size, checksum)
    if data.size == 0:
        raise ValueError("the benchmark codes no empty input")
    freqs, cum = model.normalize(model.counts(data), shape.prob_bits)
    sizes = shape.block_sizes(data.size)
    padded = np.full(sum(sizes), int(np.argmax(freqs)), np.uint8)
    padded[:data.size] = data
    coder = importlib.import_module(f"{__package__}.{shape.variant.lower()}")

    pieces, off = [], 0
    i = 0
    while i < len(sizes):
        n = 1
        while (n < BLOCKS_PER_PIECE and i + n < len(sizes)
               and sizes[i + n] == sizes[i]):
            n += 1
        pieces.append((off, n, sizes[i]))
        off += n * sizes[i]
        i += n

    def code(piece):
        o, n, size = piece
        return coder.encode_blocks(padded[o:o + n * size].reshape(n, size),
                                   freqs, cum, shape.n_lanes,
                                   shape.prob_bits)
    with ThreadPoolExecutor(max(1, min(threads, len(pieces)))) as pool:
        streams = [s for part in pool.map(code, pieces) for s in part]

    wsize = WORD_BYTES[shape.variant]
    payloads, raw, crcs, off = [], [], [], 0
    for stream, size in zip(streams, sizes):
        block = data[off:min(off + size, data.size)]
        off += size
        is_raw = stream.size * wsize >= block.size
        raw.append(is_raw)
        payloads.append(block.copy() if is_raw else stream)
        crcs.append(zlib.crc32(block.tobytes()))
    return container.write(shape.variant, shape.prob_bits, shape.n_lanes,
                           shape.block_symbols, data.size, freqs, payloads,
                           crcs if shape.checksum else None, raw)
