"""TRNS container, version 2 (docs/FORMAT.md): the writer, and a reader of
everything but the payload bytes.

    0   4  magic "TRNS"          16  8  orig_len u64
    4   1  version (2)           24  4  block_symbols u32
    5   1  variant               28  4  reserved
    6   1  prob_bits             32  freqs as 256 prob_bits-wide LSB-first
    7   1  log2(n_lanes)             bit fields + 1 trailer byte, then the
    8   1  log2(lanes_per_stream)    word counts as LEB128 varints, then
    9   1  flags (1 crc, 2 raw)      crc32 u32[n_blocks] (flag 1), the raw
    10  2  reserved                  bitmap LSB-first (flag 2), payloads
    12  4  n_blocks u32
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from .config import VARIANT_IDS, VARIANT_NAMES

HEADER = struct.Struct("<4sBBBBBBHIQII")
FLAG_CRC, FLAG_RAW = 1, 2


def _freq_fields(freqs: np.ndarray, prob_bits: int) -> bytes:
    M = 1 << prob_bits
    nbytes = (256 * prob_bits + 7) // 8
    f = [int(v) for v in freqs]
    if M in f:  # one-symbol model: M does not fit a field
        return bytes([f.index(M)]) + bytes(nbytes - 1) + b"\x01"
    acc = 0
    for i, v in enumerate(f):
        acc |= v << (i * prob_bits)
    return acc.to_bytes(nbytes, "little") + b"\x00"


def _varints(values) -> bytes:
    out = bytearray()
    for v in values:
        v = int(v)
        while True:
            out.append((v & 0x7F) | (0x80 if v >> 7 else 0))
            v >>= 7
            if not v:
                break
    return bytes(out)


def write(variant: str, prob_bits: int, n_lanes: int, block_symbols: int,
          orig_len: int, freqs: np.ndarray, payloads: list[np.ndarray],
          crcs: list[int] | None, raw: list[bool]) -> bytes:
    """One substream per block: ``payloads[b]`` is block b's word array, or
    its bytes where ``raw[b]``."""
    flags = (FLAG_CRC if crcs is not None else 0) | (FLAG_RAW if any(raw)
                                                     else 0)
    log_n = n_lanes.bit_length() - 1
    parts = [HEADER.pack(b"TRNS", 2, VARIANT_IDS[variant], prob_bits, log_n,
                         log_n, flags, 0, len(payloads), orig_len,
                         block_symbols, 0),
             _freq_fields(freqs, prob_bits),
             _varints(p.size for p in payloads)]
    if crcs is not None:
        parts.append(np.asarray(crcs, "<u4").tobytes())
    if flags & FLAG_RAW:
        parts.append(np.packbits(np.asarray(raw, bool),
                                 bitorder="little").tobytes())
    parts += [p.astype(p.dtype.newbyteorder("<")).tobytes() for p in payloads]
    return b"".join(parts)


@dataclasses.dataclass(frozen=True)
class Header:
    variant: str
    prob_bits: int
    n_lanes: int
    block_symbols: int
    orig_len: int
    counts: np.ndarray    # int64 [n_blocks]: words, or bytes of a raw block
    raw: np.ndarray       # bool [n_blocks]
    crc: bool             # the container holds each block's CRC-32

    def block_sizes(self) -> list[int]:
        """Padded symbols of each block."""
        step = 4 * self.n_lanes
        padded = -(-self.orig_len // step) * step
        n_full, tail = divmod(padded, self.block_symbols)
        return [self.block_symbols] * n_full + ([tail] if tail else [])


def read_header(blob) -> Header:
    """Parse a v2 container up to its payloads (one substream per block)."""
    mv = memoryview(blob)
    (magic, version, variant, prob_bits, log_n, log_s, flags, _, n_blocks,
     orig_len, block_symbols, _) = HEADER.unpack(mv[:HEADER.size])
    if magic != b"TRNS" or version != 2 or log_n != log_s:
        raise ValueError("not a one-substream TRNS v2 container")
    off = HEADER.size + (256 * prob_bits + 7) // 8 + 1
    counts = np.zeros(n_blocks, np.int64)
    for b in range(n_blocks):
        v = shift = 0
        while True:
            byte = mv[off]
            off += 1
            v |= (byte & 0x7F) << shift
            shift += 7
            if not byte & 0x80:
                break
        counts[b] = v
    if flags & FLAG_CRC:
        off += 4 * n_blocks
    raw = np.zeros(n_blocks, bool)
    if flags & FLAG_RAW:
        raw = np.unpackbits(np.frombuffer(mv[off:off + (n_blocks + 7) // 8],
                                          np.uint8),
                            bitorder="little")[:n_blocks].astype(bool)
    return Header(VARIANT_NAMES[variant], prob_bits, 1 << log_n,
                  block_symbols, orig_len, counts, raw,
                  bool(flags & FLAG_CRC))
