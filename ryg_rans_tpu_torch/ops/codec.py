"""The device codec of every variant: one record per variant of how it
drives its kernels, and one encode / decode loop around them.

A :class:`Codec` in ``CODECS`` holds what differs: the kernel wrappers'
module (``ops.word``: K1/K2, ``ops.byte``: K3/K4 for BYTE and ALIAS,
``ops.rans64``: K5/K6), the shape limit, the stream and cell layout, the
host table builders, the compaction and how the decode wrapper takes its
tables.  :func:`encode` and :func:`decode` run every variant in launch
groups of equal-size blocks:

* encode: the tables (``rans.tables``); per group the kernel
  (``rans.launch``), the compaction (``rans.compact``), and one fetch of
  the group's words, split per block (``rans.assemble``);
* decode: the tables (``rans.tables``); per group the words uploaded,
  as the blob's own span where the group's blocks lie back to back in it,
  else joined first (``rans.stage``), and the kernel (``rans.launch``).

The variant-neutral block glue is here too.  A block's stream is [head:
the lanes' final states] ++ [body: renorm words in stream order]
(docs/FORMAT.md).
"""

from __future__ import annotations

import dataclasses
import functools
from types import ModuleType
from typing import Callable

import numpy as np
import torch

from ..config import RansConfig, Variant
from ..utils import container
from ..utils.profiling import span, to_device, to_host
from . import byte, host_prep, rans64, word

#: Bytes of dense encode cells one launch group holds at most: this bounds
#: the device memory of a launch, and sets each variant's group cap.
GROUP_BYTES = 1 << 30
#: Blocks per launch at most (the encode grid's y extent).
MAX_GROUP_BLOCKS = 4096
#: The type a decode wrapper's stream buffer holds a word's bits in, by
#: the word's bytes.
_WIRE = {1: torch.uint8, 2: torch.int16, 4: torch.int32}
#: The signed type of a cell's low half, by the cell's type.
_LOW_HALF = {torch.int32: torch.int16, torch.int64: torch.int32}


def check_shape(cfg: RansConfig, max_prob_bits: int) -> None:
    """Raise NotImplementedError for a config outside the device path:
    every variant's kernels take one substream per block, 128-16384 lanes,
    block_symbols a multiple of 4*n_lanes and prob_bits from 9 up to the
    variant's ``max_prob_bits``.  The message names the host backends,
    which code any config."""
    N = cfg.n_lanes
    if not (9 <= cfg.prob_bits <= max_prob_bits and 128 <= N <= 16384
            and cfg.lanes_per_stream == N
            and cfg.block_symbols % (4 * N) == 0):
        raise NotImplementedError(
            f"{cfg.variant.name} config outside the device path (prob_bits "
            f"9-{max_prob_bits}, one substream per block, 128-16384 lanes, "
            f"block_symbols a multiple of 4*n_lanes): {cfg}; the host "
            "backends code it: compress / decompress / decompress_block "
            "with backend=\"native\" or backend=\"numpy\"")


def pad_block(data: torch.Tensor, n_lanes: int, freqs) -> torch.Tensor:
    """Pad flat uint8 ``data`` to a multiple of 4*n_lanes (at least one
    step) with the most frequent symbol, the first arg max of ``freqs``."""
    S = data.numel()
    step = 4 * n_lanes
    S_pad = -(-max(S, 1) // step) * step
    if S_pad == S:
        return data
    fill = torch.full((S_pad - S,), int(np.argmax(freqs)), dtype=torch.uint8,
                      device=data.device)
    return torch.cat([data, fill])


def block_sizes(block_symbols: int, padded_len: int) -> list[int]:
    """Padded symbols per block: [B, ..., B, tail]."""
    n_full, tail = divmod(padded_len, block_symbols)
    return [block_symbols] * n_full + ([tail] if tail else [])


def groups(sizes: list[int], group_symbols: int):
    """Yield (first block, n_blocks, block size) launch groups: runs of
    equal-size blocks of at most ``group_symbols`` symbols (one block at
    least) and MAX_GROUP_BLOCKS blocks."""
    b = 0
    while b < len(sizes):
        size = sizes[b]
        cap = min(MAX_GROUP_BLOCKS, max(1, group_symbols // size))
        n = 1
        while n < cap and b + n < len(sizes) and sizes[b + n] == size:
            n += 1
        yield b, n, size
        b += n


def _owner(a):
    """The object whose memory array ``a`` views: down its bases, and
    through a memoryview to the object it was taken from."""
    while True:
        if isinstance(a, np.ndarray) and a.base is not None:
            a = a.base
        elif isinstance(a, memoryview):
            a = a.obj
        else:
            return a


def run_of(arrays: list[np.ndarray]) -> np.ndarray | None:
    """The bytes of ``arrays`` as one read-only uint8 slice of the object
    that holds them, where each is a C-contiguous view of that one object
    and starts where the one before it ends, as ``container.unpack``'s
    payloads of consecutive coded blocks do; else None.  Memory that
    merely touches is not a run: the arrays must share their owner."""
    owner = _owner(arrays[0])
    try:
        whole = np.frombuffer(owner, np.uint8)
    except (TypeError, ValueError, BufferError):
        return None
    base = whole.ctypes.data
    start = end = arrays[0].ctypes.data - base
    for a in arrays:
        if (not a.flags.c_contiguous or _owner(a) is not owner
                or a.ctypes.data - base != end):
            return None
        end += a.nbytes
    if start < 0 or end > whole.size:
        return None
    run = whole[start:end]
    run.flags.writeable = False
    return run


def stack_blocks(blocks: list[np.ndarray], n_head: int, dtype, device):
    """Per-block word arrays [head of ``n_head`` words | body] -> (words
    [W], heads [nb, n_head], body_off int64 [nb], body_len int32 [nb]) on
    ``device``: one copy of the words to the device, where the heads are
    gathered.  The copy's source is the span of the object the blocks lie
    in back to back (:func:`run_of`; ``unpack``'s blob), else the blocks
    joined on the host.  ``dtype`` is the numpy word type.  The bytes land
    in a new buffer on ``device`` (the CPU's too: the span is read-only,
    which ``to_device`` copies), viewed there as the decode wrappers take
    them: bytes as uint8, wider words in the signed type of their width.
    A head's words are little-endian pieces of a lane state, so
    ``heads.view`` of the state's type gives the states."""
    blocks = [np.asarray(w, dtype) for w in blocks]
    lens = np.array([w.size for w in blocks], np.int64)
    if np.any(lens < n_head) or np.any(lens - n_head >= 1 << 31):
        raise ValueError("container corrupt: a block's word count does "
                         "not fit its lane states")
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    host = run_of(blocks)
    if host is None:
        host = np.concatenate(blocks).view(np.uint8)
    raw, offsets, body_len = to_device(
        host, offs, (lens - n_head).astype(np.int32), device=device)
    words = raw.view(_WIRE[np.dtype(dtype).itemsize])
    heads = words[offsets.view(-1, 1) + torch.arange(n_head, device=device)]
    return words, heads, offsets + n_head, body_len


def assemble_blocks(heads: np.ndarray, body: np.ndarray,
                    counts: np.ndarray) -> list[np.ndarray]:
    """Heads [nb, H], the group's body and each block's body length ->
    per-block arrays [head | body]."""
    ends = np.cumsum(counts)
    return [np.concatenate([heads[b], body[ends[b] - counts[b]:ends[b]]])
            for b in range(len(counts))]


def compact_words(cells: torch.Tensor, states: torch.Tensor):
    """Dense WORD or RANS64 cells -> (heads [nb, 2N], body [total], counts
    int64 [nb]), words of half a cell's width in its signed type: int16
    for WORD's int32 cells, int32 for RANS64's int64 cells.

    A cell is ``word | 1 << bits`` where a lane wrote a ``bits``-bit
    renorm word at that step, else 0.  The row-major [block, step, lane]
    order of the cells is stream order, so a boolean-mask select keeps
    exactly the emitted words, block after block; ``counts`` splits them.
    Heads are the final states lane-ascending as (lo, hi) words
    (RansWordEncFlush, rans_word_sse41.h:96-106; Rans64EncFlush,
    rans64.h:96-103): the states' little-endian halves.
    """
    nb, S = cells.shape
    half = _LOW_HALF[cells.dtype]
    emitted = cells >= 1 << (8 * half.itemsize)
    with span("rans.wait"):  # the select's size comes back to the host
        body = cells.view(half).view(nb, S, 2)[:, :, 0][emitted]
    heads = states.contiguous().view(half).view(nb, -1)
    return heads, body, emitted.sum(1)


def _tables_spread(tables: tuple, n_symbols: int, prob_bits: int) -> tuple:
    """K1 and K5 take each decode table as an argument."""
    return (*tables, n_symbols, prob_bits)


def _tables_as_one(tables: tuple, n_symbols: int, prob_bits: int,
                   alias: bool) -> tuple:
    """K3 takes its decode tables as one tuple, then the ALIAS flag."""
    return (tables, n_symbols, prob_bits, alias)


def _enc(kernel_table, freqs, cum_freqs, prob_bits: int) -> tuple:
    """WORD and RANS64 encode: freq and start, then the kernel's table."""
    return (*host_prep.enc_tables(freqs, cum_freqs),
            kernel_table(freqs, cum_freqs, prob_bits))


def _byte_enc(freqs, cum_freqs, prob_bits: int, alias: bool) -> tuple:
    """BYTE and ALIAS encode: freq, start, ALIAS's remap, K4's table."""
    remap = (host_prep.alias_remap(freqs, cum_freqs, prob_bits) if alias
             else None)
    return (*host_prep.enc_tables(freqs, cum_freqs), remap,
            host_prep.byte_enc_table(freqs, cum_freqs, prob_bits, alias))


@dataclasses.dataclass(frozen=True)
class Codec:
    """How one variant drives its kernels.

    ``host_enc_tables(freqs, cum_freqs, prob_bits)`` gives the host arrays
    that the encode wrapper takes after the symbols, the kernel's own
    table last; ``host_dec_tables`` those of the decode wrapper.
    ``compact(cells, states)`` turns the encoder's dense cells into
    (heads, body, counts) on the device, and ``decode_args(tables,
    n_symbols, prob_bits)`` the decode tables into the decode wrapper's
    arguments after the stream.
    """

    variant: Variant
    ops: ModuleType           # the kernel wrappers and their plain versions
    max_prob_bits: int
    head_words: int           # stream words a lane's final state takes
    state_dtype: torch.dtype  # a lane state at the wrappers' boundary
    cell_bytes: int           # one dense encode cell
    host_enc_tables: Callable
    host_dec_tables: Callable
    compact: Callable
    decode_args: Callable

    @property
    def word_dtype(self):
        """The numpy type of the variant's stream words."""
        return container.word_dtype(self.variant)

    @property
    def group_symbols(self) -> int:
        """Symbols coded per launch at most: GROUP_BYTES of dense cells
        (a decode group's output is a quarter or an eighth of that)."""
        return GROUP_BYTES // self.cell_bytes

    def enc_tables(self, freqs, cum_freqs, prob_bits: int, device) -> tuple:
        """The encode tables on ``device``, in one upload."""
        return to_device(*self.host_enc_tables(freqs, cum_freqs, prob_bits),
                         device=device)

    def dec_tables(self, freqs, cum_freqs, prob_bits: int, device) -> tuple:
        """The decode tables on ``device``, in one upload."""
        return to_device(*self.host_dec_tables(freqs, cum_freqs, prob_bits),
                         device=device)

    def encode_blocks(self, syms: torch.Tensor, tables: tuple,
                      cfg: RansConfig):
        """The encode wrapper on launch group ``syms`` (uint8 [nb, S]) ->
        (dense cells, final states); ``tables`` from :meth:`enc_tables`."""
        *model, table = tables
        return self.ops.encode_blocks(syms, *model, cfg.n_lanes,
                                      cfg.prob_bits, table=table)

    def decode_blocks(self, stream: tuple, tables: tuple, n_symbols: int,
                      cfg: RansConfig, plan=None) -> torch.Tensor:
        """The decode wrapper on ``stream`` (from :meth:`prep_decode`) ->
        uint8 [nb, n_symbols]; ``tables`` from :meth:`dec_tables`."""
        return self.ops.decode_blocks(
            *stream, *self.decode_args(tables, n_symbols, cfg.prob_bits),
            plan=plan)

    def prep_decode(self, blocks: list[np.ndarray], n_lanes: int, device):
        """Per-block word arrays [head | body] -> the decode wrapper's
        stream (x0 [nb, N] of ``state_dtype``, words [W], body_off int64
        [nb], body_len int32 [nb]) on ``device``."""
        words, heads, body_off, body_len = stack_blocks(
            blocks, self.head_words * n_lanes, self.word_dtype, device)
        return heads.view(self.state_dtype), words, body_off, body_len


#: Every variant's record.
CODECS = {
    Variant.WORD: Codec(
        Variant.WORD, word, max_prob_bits=15, head_words=2,
        state_dtype=torch.int32, cell_bytes=4,
        host_enc_tables=functools.partial(_enc, host_prep.word_enc_table),
        host_dec_tables=host_prep.dec_tables, compact=compact_words,
        decode_args=_tables_spread),
    Variant.BYTE: Codec(
        Variant.BYTE, byte, max_prob_bits=16, head_words=4,
        state_dtype=torch.int32, cell_bytes=4,
        host_enc_tables=functools.partial(_byte_enc, alias=False),
        host_dec_tables=host_prep.dec_tables, compact=byte.compact_emissions,
        decode_args=functools.partial(_tables_as_one, alias=False)),
    Variant.ALIAS: Codec(
        Variant.ALIAS, byte, max_prob_bits=16, head_words=4,
        state_dtype=torch.int32, cell_bytes=4,
        host_enc_tables=functools.partial(_byte_enc, alias=True),
        host_dec_tables=host_prep.alias_dec_tables,
        compact=byte.compact_emissions,
        decode_args=functools.partial(_tables_as_one, alias=True)),
    Variant.RANS64: Codec(
        Variant.RANS64, rans64, max_prob_bits=31, head_words=2,
        state_dtype=torch.int64, cell_bytes=8,
        host_enc_tables=functools.partial(_enc, host_prep.rans64_enc_table),
        host_dec_tables=host_prep.rans64_dec_tables, compact=compact_words,
        decode_args=_tables_spread),
}


def codec_of(cfg: RansConfig) -> Codec:
    """The record of ``cfg.variant``; raises NotImplementedError for a
    shape no kernel takes (:func:`check_shape`)."""
    rec = CODECS[cfg.variant]
    check_shape(cfg, rec.max_prob_bits)
    return rec


def encode(cfg: RansConfig, padded: torch.Tensor, freqs,
           cum_freqs) -> list[np.ndarray]:
    """Encode a flat uint8 tensor padded to a multiple of 4*n_lanes ->
    per-block word arrays [head | body] of the variant's word type, on the
    host."""
    rec = codec_of(cfg)
    if padded.numel() % (4 * cfg.n_lanes):
        raise ValueError("input must be padded to a multiple of 4*n_lanes")
    with span("rans.tables"):
        tables = rec.enc_tables(freqs, cum_freqs, cfg.prob_bits,
                                padded.device)
    out: list[np.ndarray] = []
    pos = 0
    for _, nb, size in groups(block_sizes(cfg.block_symbols,
                                          padded.numel()),
                              rec.group_symbols):
        syms = padded[pos:pos + nb * size].view(nb, size)
        pos += nb * size
        with span("rans.launch"):
            cells, states = rec.encode_blocks(syms, tables, cfg)
        with span("rans.compact"):
            heads, body, counts = rec.compact(cells, states)
            del cells
        with span("rans.assemble"):
            heads, body, counts = to_host(heads, body, counts)
            out += assemble_blocks(heads.view(rec.word_dtype),
                                   body.view(rec.word_dtype), counts)
    return out


def decode(cfg: RansConfig, blocks: list[np.ndarray], sizes: list[int],
           freqs, cum_freqs, device) -> torch.Tensor:
    """Decode per-block word arrays (padded symbol counts ``sizes``, all
    equal but the last) -> flat uint8 tensor on ``device``."""
    rec = codec_of(cfg)
    device = torch.device(device)
    with span("rans.tables"):
        tables = rec.dec_tables(freqs, cum_freqs, cfg.prob_bits, device)
    parts = []
    for b0, nb, size in groups(sizes, rec.group_symbols):
        with span("rans.stage"):
            stream = rec.prep_decode(blocks[b0:b0 + nb], cfg.n_lanes, device)
        with span("rans.launch"):
            parts.append(rec.decode_blocks(stream, tables, size,
                                           cfg).view(-1))
    if not parts:
        return torch.empty(0, dtype=torch.uint8, device=device)
    return parts[0] if len(parts) == 1 else torch.cat(parts)
