"""Bytes a kernel cannot do without, from a container's header, and the
device's peak bandwidth.

The count is of the algorithm's work, whatever implements it: each input
symbol read once (1 byte), the block's stream written or read once (its
head of flushed states and its body), each decoded symbol written once,
and the frequency and cumulative tables read once a call (256 entries of 4
bytes each).  Never counted: dense cells, masks, ring refills or any byte a
kernel reads again.  Symbols are the padded ones the format codes.

A block stored raw holds no stream.  Its encoder ran all the same, and its
stream took at least the block's bytes (that is why it was stored raw), so
the encoder is given those bytes: a lower bound, never an overcount.  The
decoders do not run on a raw block, so it adds nothing there.
"""

from __future__ import annotations

import json
from pathlib import Path

from .reference.config import WORD_BYTES
from .reference.container import Header

TABLE_BYTES = 2 * 256 * 4
PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def encode_bytes(h: Header) -> int:
    total = TABLE_BYTES
    for size, count, raw in zip(h.block_sizes(), h.counts, h.raw):
        stream = int(count) if raw else int(count) * WORD_BYTES[h.variant]
        total += size + stream
    return total


def decode_bytes(h: Header) -> int:
    total = TABLE_BYTES
    for size, count, raw in zip(h.block_sizes(), h.counts, h.raw):
        if not raw:
            total += int(count) * WORD_BYTES[h.variant] + size
    return total


BYTES = {"encode": encode_bytes, "decode": decode_bytes}


def hbm_bytes_per_s(device_kind: str) -> float | None:
    """The published memory bandwidth of the card named ``device_kind``
    (``torch.cuda.get_device_name``), or None for a card not in
    ``peaks.json``: its shares are then not read."""
    entry = PEAKS.get(device_kind)
    return None if entry is None else float(entry["hbm_bytes_per_s"])
