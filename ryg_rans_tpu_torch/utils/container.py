"""Self-describing TRNS container for compressed streams (docs/FORMAT.md).

    offset  size  field
    0       4     magic "TRNS"
    4       1     version (1 or 2)
    5       1     variant (config.Variant)
    6       1     prob_bits
    7       1     log2(n_lanes)
    8       1     log2(lanes_per_stream)
    9       1     flags (bit0: per-block crc32 of the original bytes;
                  bit1: raw-block bitmap present)
    10      2     reserved (0)
    12      4     n_blocks (u32)
    16      8     orig_len in bytes (u64)
    24      4     block_symbols (u32)
    28      4     reserved (0)
    32      ...   model + counts, version-dependent:
      v1:   freqs u32[256] (sum = 1<<prob_bits), then per-substream word
            counts u32[n_blocks][n_streams]
      v2:   freqs as 256 prob_bits-wide LSB-first bit fields
            (ceil(256*prob_bits/8) bytes) + 1 trailer byte (1 = degenerate
            one-symbol model whose freq == 1<<prob_bits, with the symbol
            index in field-area byte 0; else 0), then counts as LEB128
            varints, row-major
    ...     4*n_blocks             crc32 per block (if flag bit0)
    ...     ceil(n_blocks/8)       raw bitmap, LSB-first (if flag bit1)
    ...     payload: per block, per substream, word-aligned little-endian

Every block's symbol payload is the block's bytes padded to a multiple of
4*n_lanes with the most frequent symbol; decode strips the padding using
orig_len.  A raw block (flag bit1) is stored verbatim as unpadded uint8; its
counts row is [n_raw_bytes, 0, ...].  numpy and zlib only: no torch here.

The payload bytes are copied once on the way in and not at all on the way
out: ``pack`` joins the payload arrays themselves into the result, ``crc32``
reads its array in place, and the payloads ``unpack`` returns are views of
the blob it was given (read-only for a ``bytes`` blob; a ``bytearray``
blob changed later changes them, and cannot be resized while they live).
A consumer that needs its own or a writable array copies it: the device
decode uploads the blob's span where a launch group's blocks lie back to
back in it (``ops.codec.stack_blocks``) and joins them otherwise, and the
package's other callers join the payloads first.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib

import numpy as np

from ..config import NSYMS, RansConfig, Variant

MAGIC = b"TRNS"
#: Default written version; v1 containers stay readable.
VERSION = 2
V1 = 1
_HEADER = struct.Struct("<4sBBBBBBHIQII")
assert _HEADER.size == 32

FLAG_CRC = 1
FLAG_RAW = 2


# -- v2 compact field codecs -------------------------------------------------


def _pack_freqs_v2(freqs: np.ndarray, prob_bits: int) -> bytes:
    """256 frequencies as prob_bits-wide LSB-first bit fields + 1 trailer
    byte.  A frequency equals M = 1<<prob_bits only in the one-symbol
    model, and M needs prob_bits+1 bits: trailer byte 1 marks that case,
    with the symbol index in byte 0 of the field area."""
    f = [int(x) for x in np.asarray(freqs, np.uint64)]
    M = 1 << prob_bits
    nbytes = (256 * prob_bits + 7) // 8
    if M in f:
        return bytes([f.index(M)]) + bytes(nbytes - 1) + b"\x01"
    acc = 0
    for i, v in enumerate(f):
        acc |= v << (i * prob_bits)
    return acc.to_bytes(nbytes, "little") + b"\x00"


def freqs_v2_size(prob_bits: int) -> int:
    return (256 * prob_bits + 7) // 8 + 1


def _read_exact(f, n: int) -> bytes:
    """f.read(n) that raises the typed truncation error on short reads."""
    buf = f.read(n)
    if len(buf) < n:
        raise ValueError("container truncated")
    return buf


def _unpack_freqs_v2(buf: bytes, prob_bits: int) -> np.ndarray:
    if buf[-1]:  # degenerate single-symbol model
        out = np.zeros(256, np.uint32)
        out[buf[0]] = 1 << prob_bits
        return out
    acc = int.from_bytes(buf[:-1], "little")
    mask = (1 << prob_bits) - 1
    return np.fromiter(((acc >> (i * prob_bits)) & mask for i in range(256)),
                       np.uint32, 256)


def _pack_varints(values) -> bytes:
    """LEB128 for the per-substream word counts."""
    out = bytearray()
    for v in values:
        v = int(v)
        while True:
            b = v & 0x7F
            v >>= 7
            out.append(b | (0x80 if v else 0))
            if not v:
                break
    return bytes(out)


def _read_varints_mv(blob, off: int, n: int) -> tuple[np.ndarray, int]:
    out = np.empty(n, np.uint32)
    try:
        for i in range(n):
            v = shift = 0
            while True:
                b = blob[off]
                off += 1
                v |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
                if shift > 28:  # counts are u32; more bytes = corruption
                    raise ValueError("container corrupt in counts")
            if v > 0xFFFFFFFF:
                raise ValueError("container corrupt in counts")
            out[i] = v
    except IndexError:
        raise ValueError("container truncated in counts") from None
    return out, off


def _read_varints_file(f, n: int) -> np.ndarray:
    out = np.empty(n, np.uint32)
    for i in range(n):
        v = shift = 0
        while True:
            c = f.read(1)
            if not c:
                raise ValueError("container truncated in counts")
            b = c[0]
            v |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
            if shift > 28:  # counts are u32; more bytes = corruption
                raise ValueError("container corrupt in counts")
        if v > 0xFFFFFFFF:
            raise ValueError("container corrupt in counts")
        out[i] = v
    return out


@dataclasses.dataclass
class Container:
    cfg: RansConfig
    orig_len: int
    freqs: np.ndarray                  # u32[256]
    stream_words: np.ndarray           # u32 [n_blocks, n_streams]
    crcs: np.ndarray | None            # u32 [n_blocks] or None
    payloads: list[list[np.ndarray]]   # [block][substream] word arrays
    #: raw[b] -> block b stored as verbatim uint8 bytes (payloads[b] is a
    #: single unpadded uint8 array); None -> all blocks coded
    raw: np.ndarray | None = None

    @property
    def padded_len(self) -> int:
        if self.orig_len == 0:
            return 0  # empty container carries zero blocks
        step = 4 * self.cfg.n_lanes
        return -(-self.orig_len // step) * step

    def block_sizes(self) -> list[int]:
        """Padded symbol count per block ([] for an empty container)."""
        B = self.cfg.block_symbols
        total = self.padded_len
        n_full = total // B
        sizes = [B] * n_full
        if total - n_full * B:
            sizes.append(total - n_full * B)
        return sizes


def word_dtype(variant: Variant):
    return {Variant.BYTE: np.uint8, Variant.WORD: np.uint16,
            Variant.RANS64: np.uint32, Variant.ALIAS: np.uint8}[variant]


def pack_header(cfg: RansConfig, orig_len: int, freqs: np.ndarray,
                stream_words: np.ndarray,
                crcs: np.ndarray | None = None,
                raw: np.ndarray | None = None,
                version: int = VERSION) -> bytes:
    """Everything before the payload bytes: header, freqs, per-substream
    word counts, optional CRCs and optional raw bitmap, in the v1 (raw u32
    fields) or v2 (packed freqs + varint counts) encoding."""
    if version not in (V1, VERSION):
        raise ValueError(f"unsupported container version {version}")
    n_blocks = stream_words.shape[0] if stream_words.size else 0
    flags = (FLAG_CRC if crcs is not None else 0) \
        | (FLAG_RAW if raw is not None and np.any(raw) else 0)
    head = _HEADER.pack(
        MAGIC, version, int(cfg.variant), cfg.prob_bits,
        cfg.n_lanes.bit_length() - 1, cfg.lanes_per_stream.bit_length() - 1,
        flags, 0, n_blocks, orig_len, cfg.block_symbols, 0)
    if version == V1:
        parts = [head, np.asarray(freqs, np.uint32).tobytes(),
                 np.asarray(stream_words, np.uint32).tobytes()]
    else:
        parts = [head, _pack_freqs_v2(freqs, cfg.prob_bits),
                 _pack_varints(np.asarray(stream_words).reshape(-1))]
    if crcs is not None:
        parts.append(np.asarray(crcs, np.uint32).tobytes())
    if flags & FLAG_RAW:
        parts.append(np.packbits(
            np.asarray(raw, bool), bitorder="little").tobytes())
    return b"".join(parts)


def pack(cfg: RansConfig, orig_len: int, freqs: np.ndarray,
         payloads: list[list[np.ndarray]],
         crcs: np.ndarray | None = None,
         raw: np.ndarray | None = None,
         version: int = VERSION) -> bytes:
    counts = np.zeros((len(payloads), cfg.n_streams), np.uint32)
    for b, blk in enumerate(payloads):
        counts[b, :len(blk)] = [s.size for s in blk]
    parts = [pack_header(cfg, orig_len, freqs, counts, crcs, raw, version)]
    wdt = word_dtype(cfg.variant)
    for b, blk in enumerate(payloads):
        dt = np.uint8 if raw is not None and raw[b] else wdt
        for s in blk:
            # a view where s already is contiguous of dtype dt: the join
            # is the only copy
            parts.append(np.ascontiguousarray(s, dt))
    return b"".join(parts)


def _config(variant, prob_bits, log_lanes, log_lpg, flags,
            block_symbols) -> RansConfig:
    return RansConfig(
        variant=Variant(variant), prob_bits=prob_bits,
        n_lanes=1 << log_lanes, lanes_per_stream=1 << log_lpg,
        block_symbols=block_symbols, checksum=bool(flags & FLAG_CRC))


def read_header(f) -> tuple["Container", int]:
    """Parse header/freqs/counts/CRCs from a file object positioned at 0;
    returns (Container with empty payloads, payload byte offset)."""
    head = _read_exact(f, _HEADER.size)
    (magic, version, variant, prob_bits, log_lanes, log_lpg, flags, _rsv,
     n_blocks, orig_len, block_symbols, _rsv2) = _HEADER.unpack(head)
    if magic != MAGIC:
        raise ValueError("not a TRNS container")
    if version not in (V1, VERSION):
        raise ValueError(f"unsupported container version {version}")
    cfg = _config(variant, prob_bits, log_lanes, log_lpg, flags,
                  block_symbols)
    ns = cfg.n_streams
    off = _HEADER.size
    if version == V1:
        freqs = np.frombuffer(_read_exact(f, 4 * NSYMS), np.uint32).copy()
        counts = np.frombuffer(_read_exact(f, 4 * n_blocks * ns),
                               np.uint32).reshape(n_blocks, ns).copy()
        off += 4 * NSYMS + 4 * n_blocks * ns
    else:
        fb = freqs_v2_size(prob_bits)
        freqs = _unpack_freqs_v2(_read_exact(f, fb), prob_bits)
        pos0 = f.tell()
        counts = _read_varints_file(f, n_blocks * ns).reshape(n_blocks, ns)
        off += fb + (f.tell() - pos0)
    crcs = None
    if flags & FLAG_CRC:
        crcs = np.frombuffer(_read_exact(f, 4 * n_blocks),
                             np.uint32).copy()
        off += 4 * n_blocks
    raw = None
    if flags & FLAG_RAW:
        nb_bytes = (n_blocks + 7) // 8
        raw = np.unpackbits(
            np.frombuffer(_read_exact(f, nb_bytes), np.uint8),
            bitorder="little")[:n_blocks].astype(bool)
        off += nb_bytes
    return Container(cfg=cfg, orig_len=orig_len, freqs=freqs,
                     stream_words=counts, crcs=crcs, payloads=[],
                     raw=raw), off


def unpack(blob: bytes | memoryview) -> Container:
    """Parse a whole container.  Its payloads are views of ``blob``, not
    copies: read-only when ``blob`` is."""
    blob = memoryview(blob)
    if len(blob) < _HEADER.size:
        raise ValueError("container truncated")
    (magic, version, variant, prob_bits, log_lanes, log_lpg, flags, _rsv,
     n_blocks, orig_len, block_symbols, _rsv2) = _HEADER.unpack(
        blob[:_HEADER.size])
    if magic != MAGIC:
        raise ValueError("not a TRNS container")
    if version not in (V1, VERSION):
        raise ValueError(f"unsupported container version {version}")
    cfg = _config(variant, prob_bits, log_lanes, log_lpg, flags,
                  block_symbols)
    off = _HEADER.size
    ns = cfg.n_streams
    if version == V1:
        if len(blob) < off + 4 * NSYMS + 4 * n_blocks * ns:
            raise ValueError("container truncated")
        freqs = np.frombuffer(blob[off:off + 4 * NSYMS], np.uint32).copy()
        off += 4 * NSYMS
        counts = np.frombuffer(
            blob[off:off + 4 * n_blocks * ns],
            np.uint32).reshape(n_blocks, ns)
        off += 4 * n_blocks * ns
    else:
        fb = freqs_v2_size(prob_bits)
        if len(blob) < off + fb:
            raise ValueError("container truncated")
        freqs = _unpack_freqs_v2(bytes(blob[off:off + fb]), prob_bits)
        off += fb
        counts, off = _read_varints_mv(blob, off, n_blocks * ns)
        counts = counts.reshape(n_blocks, ns)
    crcs = None
    if flags & FLAG_CRC:
        crcs = np.frombuffer(blob[off:off + 4 * n_blocks], np.uint32).copy()
        off += 4 * n_blocks
    raw = None
    if flags & FLAG_RAW:
        nb_bytes = (n_blocks + 7) // 8
        raw = np.unpackbits(
            np.frombuffer(blob[off:off + nb_bytes], np.uint8),
            bitorder="little")[:n_blocks].astype(bool)
        off += nb_bytes
    if off > len(blob):
        raise ValueError("container truncated")
    wdt = word_dtype(cfg.variant)
    payloads: list[list[np.ndarray]] = []
    for b in range(n_blocks):
        dt = np.uint8 if raw is not None and raw[b] else wdt
        wsize = np.dtype(dt).itemsize
        blk = []
        for s in range(ns):
            n = int(counts[b, s])
            blk.append(np.frombuffer(blob[off:off + n * wsize], dt))
            off += n * wsize
        payloads.append(blk)
    if off != len(blob):
        raise ValueError(
            f"container size mismatch: parsed {off} of {len(blob)} bytes")
    return Container(cfg=cfg, orig_len=orig_len, freqs=freqs,
                     stream_words=counts, crcs=crcs, payloads=payloads,
                     raw=raw)


def crc32(data: np.ndarray) -> int:
    """CRC-32 of ``data``'s bytes, read in place when it is a contiguous
    uint8 array."""
    return zlib.crc32(np.ascontiguousarray(data, np.uint8))
