"""WORD codec on the card: the K1/K2 kernel wrappers, their plain PyTorch
versions, and the tensor glue around them.

Counterpart of the reference package's ``ops/word_tpu.py``.  Symbol ``i``
of a block is step ``i // N``, lane ``i % N`` (docs/FORMAT.md), so both
kernels read and write plain ``uint8`` in that order.  The stream of a
block is [2N u16 state words, lane-ascending lo/hi] ++ [renorm words, step
ascending, lane ascending].

Tensor conventions at the wrapper boundaries: u32 states travel as
``int32`` tensors holding the bit pattern and u16 stream words as
``int16`` tensors holding the bit pattern.  The plain versions widen to
``int64`` because PyTorch on the CPU has no unsigned 32-bit shift or
compare.  A wrapper takes its plain version only for tensors on the CPU;
on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _kernels
from ..config import RansConfig, Variant
from ..utils.profiling import span, to_device, to_host
from . import decode_plan, host_prep

#: Symbols coded per kernel launch at most.  Bounds device memory: a group
#: holds 4 B/symbol of dense encode cells, or 1 B/symbol of decode output.
GROUP_SYMBOLS = 1 << 28
#: Blocks per launch at most (the encode grid's y extent).
MAX_GROUP_BLOCKS = 4096


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


def check_config(cfg: RansConfig) -> None:
    """Raise for a config this module does not code: another variant
    (ValueError) or a WORD shape outside the device path
    (NotImplementedError)."""
    if cfg.variant != Variant.WORD:
        raise ValueError(f"ops.word codes WORD, not {cfg.variant.name}")
    check_shape(cfg, 15)


def u32_as_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor of the same bits."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def i32_as_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> int64 values in [0, 2^32)."""
    return x.to(torch.int64) & 0xFFFFFFFF


def check_tables(ref: torch.Tensor, *tables: torch.Tensor) -> None:
    for t in tables:
        if t.device != ref.device or not t.is_contiguous():
            raise ValueError("tables must be contiguous and on the data's "
                             "device")


def staged(syms: torch.Tensor, table: torch.Tensor, shape) -> torch.Tensor:
    """Check an encode kernel's ``table`` (int32 of ``shape`` on the data's
    device) and return ``syms``, copied first when it does not start on a
    16-byte boundary: the encoders stage symbols in 16-byte pieces
    (``csrc/enc_tiles.cuh``)."""
    if table.dtype != torch.int32 or tuple(table.shape) != shape:
        raise ValueError(f"table must be int32 {list(shape)}")
    check_tables(syms, table)
    return syms.clone() if syms.data_ptr() % 16 else syms


# ---------------------------------------------------------------------------
# K2: dense encode
# ---------------------------------------------------------------------------


def encode_blocks(syms: torch.Tensor, freq: torch.Tensor,
                  start: torch.Tensor, n_lanes: int, prob_bits: int,
                  table: torch.Tensor | None = None):
    """Dense encode of ``nb`` blocks (K2, ``csrc/word_encode.cu``).

    syms: uint8 [nb, S] with S a multiple of n_lanes; freq, start: int32
    [256].  Returns (cells int32 [nb, S], states int32 [nb, n_lanes]): cell
    ``(word | 1<<16)`` where a lane renormalised at that step, else 0, and
    the final states as u32 bits.  The kernel reads ``table``,
    ``host_prep.word_enc_table`` of the same model (int32 [256, 4] on the
    data's device), in place of freq and start; without it, the wrapper
    builds it from them (a copy to the host).
    """
    if (syms.dtype != torch.uint8 or syms.dim() != 2
            or syms.shape[1] % n_lanes or not syms.is_contiguous()):
        raise ValueError("syms must be contiguous uint8 [n_blocks, "
                         "steps * n_lanes]")
    if freq.dtype != torch.int32 or start.dtype != torch.int32 \
            or freq.numel() != 256 or start.numel() != 256:
        raise ValueError("freq and start must be int32 [256]")
    check_tables(syms, freq, start)
    if syms.device.type == "cpu":
        return encode_blocks_ref(syms, freq, start, n_lanes, prob_bits)
    if syms.device.type != "cuda":
        raise ValueError(f"no WORD encode kernel for {syms.device}")
    if table is None:
        table = to_device(host_prep.word_enc_table(
            *to_host(freq, start), prob_bits), device=syms.device)
    syms = staged(syms, table, (256, 4))
    nb, S = syms.shape
    cells = torch.empty((nb, S), dtype=torch.int32, device=syms.device)
    states = torch.empty((nb, n_lanes), dtype=torch.int32,
                         device=syms.device)
    if nb:
        _kernels.call("word_encode", syms.device, syms.data_ptr(),
                      table.data_ptr(), cells.data_ptr(), states.data_ptr(),
                      nb, n_lanes, S // n_lanes, prob_bits)
        encode_blocks.launches += 1
    return cells, states


encode_blocks.launches = 0


def encode_blocks_ref(syms: torch.Tensor, freq: torch.Tensor,
                      start: torch.Tensor, n_lanes: int, prob_bits: int):
    """Plain version of :func:`encode_blocks`: the same arithmetic,
    vectorised over lanes with a loop over steps, states in int64."""
    nb, S = syms.shape
    T = S // n_lanes
    grid = syms.view(nb, T, n_lanes)
    f64, st64 = freq.to(torch.int64), start.to(torch.int64)
    x = torch.full((nb, n_lanes), 1 << 16, dtype=torch.int64,
                   device=syms.device)
    cells = torch.empty((nb, T, n_lanes), dtype=torch.int32,
                        device=syms.device)
    shift = 32 - prob_bits
    for t in range(T - 1, -1, -1):
        s = grid[:, t].to(torch.int64)
        f, st = f64[s], st64[s]
        m = x >= (f << shift)  # 64-bit: freq may equal 2^prob_bits
        cells[:, t] = torch.where(m, (x & 0xFFFF) | 0x10000, 0)
        x = torch.where(m, x >> 16, x)
        x = ((x // f) << prob_bits) + x % f + st
    return cells.view(nb, S), u32_as_i32(x)


# ---------------------------------------------------------------------------
# K1: decode
# ---------------------------------------------------------------------------


def decode_blocks(x0: torch.Tensor, words: torch.Tensor,
                  body_off: torch.Tensor, body_len: torch.Tensor,
                  c2s: torch.Tensor, freq: torch.Tensor, cum: torch.Tensor,
                  n_symbols: int, prob_bits: int,
                  plan: decode_plan.DecodePlan | None = None) -> torch.Tensor:
    """Decode ``nb`` blocks of ``n_symbols`` each (K1,
    ``csrc/word_decode.cu``, one thread-block cluster per block).

    x0: int32 [nb, N] initial states (u32 bits); words: int16 [W] stream
    buffer (u16 bits), block b's body being ``words[body_off[b]:
    body_off[b] + body_len[b]]`` (int64 / int32 [nb]); c2s: uint8
    [2^prob_bits]; freq, cum: int32 [256].  Returns uint8 [nb, n_symbols].
    A word read past a block's body reads its last word (a corrupt
    container decodes to garbage, never out of bounds).  ``plan`` defaults
    to ``decode_plan.plan("WORD", N, prob_bits)``; another plan of the same
    shape is for measuring the kernel at other cluster sizes.
    """
    if x0.dtype != torch.int32 or x0.dim() != 2 or not x0.is_contiguous():
        raise ValueError("x0 must be contiguous int32 [n_blocks, n_lanes]")
    nb, N = x0.shape
    if n_symbols % N:
        raise ValueError("n_symbols must be a multiple of n_lanes")
    if (words.dtype != torch.int16 or body_off.dtype != torch.int64
            or body_len.dtype != torch.int32 or c2s.dtype != torch.uint8
            or freq.dtype != torch.int32 or cum.dtype != torch.int32):
        raise ValueError("decode_blocks: wrong argument dtypes")
    if (body_off.shape != (nb,) or body_len.shape != (nb,)
            or c2s.numel() != 1 << prob_bits or freq.numel() != 256
            or cum.numel() != 256):
        raise ValueError("decode_blocks: wrong argument shapes")
    check_tables(x0, words, body_off, body_len, c2s, freq, cum)
    if x0.device.type == "cpu":
        return decode_blocks_ref(x0, words, body_off, body_len, c2s, freq,
                                 cum, n_symbols, prob_bits)
    if x0.device.type != "cuda":
        raise ValueError(f"no WORD decode kernel for {x0.device}")
    plan = decode_plan.for_shape(plan, "WORD", N, prob_bits)
    out = torch.empty((nb, n_symbols), dtype=torch.uint8, device=x0.device)
    if nb:
        _kernels.call("word_decode", x0.device, x0.data_ptr(),
                      words.data_ptr(), body_off.data_ptr(),
                      body_len.data_ptr(), c2s.data_ptr(), freq.data_ptr(),
                      cum.data_ptr(), out.data_ptr(), nb, N, n_symbols // N,
                      prob_bits, *plan.c_args())
        decode_blocks.launches += 1
    return out


decode_blocks.launches = 0


def max_active_clusters(plan: decode_plan.DecodePlan, device) -> int:
    """``cudaOccupancyMaxActiveClusters`` of K1 under ``plan`` on
    ``device``."""
    return _kernels.query("word_decode_occupancy", device, plan.n_lanes,
                          plan.prob_bits, *plan.c_args())


def decode_blocks_ref(x0: torch.Tensor, words: torch.Tensor,
                      body_off: torch.Tensor, body_len: torch.Tensor,
                      c2s: torch.Tensor, freq: torch.Tensor,
                      cum: torch.Tensor, n_symbols: int,
                      prob_bits: int) -> torch.Tensor:
    """Plain version of :func:`decode_blocks`: lanes vectorised, a loop
    over steps, the per-step rank as a cumulative sum over lanes."""
    nb, N = x0.shape
    T = n_symbols // N
    dev = x0.device
    x = i32_as_u32(x0)
    W = words.numel()
    # one trailing zero word: what a lane reads from an empty body
    w = torch.cat([words.to(torch.int64) & 0xFFFF,
                   torch.zeros(1, dtype=torch.int64, device=dev)])
    c2s64 = c2s.to(torch.int64)
    f64, c64 = freq.to(torch.int64), cum.to(torch.int64)
    off = body_off.view(nb, 1)
    blen = body_len.to(torch.int64).view(nb, 1)
    cursor = torch.zeros((nb, 1), dtype=torch.int64, device=dev)
    out = torch.empty((nb, T, N), dtype=torch.uint8, device=dev)
    mask = (1 << prob_bits) - 1
    for t in range(T):
        slot = x & mask
        s = c2s64[slot]
        x = f64[s] * (x >> prob_bits) + slot - c64[s]
        out[:, t] = s.to(torch.uint8)
        m = x < (1 << 16)
        mi = m.to(torch.int64)
        pos = torch.minimum(cursor + torch.cumsum(mi, 1) - mi, blen - 1)
        idx = torch.where(blen > 0, off + pos, W)
        x = torch.where(m, (x << 16) | w[idx], x)
        cursor = cursor + mi.sum(1, keepdim=True)
    return out.view(nb, n_symbols)


# ---------------------------------------------------------------------------
# Glue: padding, compaction, head assembly, stream prep
# ---------------------------------------------------------------------------


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


def compact_emissions(cells: torch.Tensor, states: torch.Tensor):
    """Dense cells -> (heads int16 [nb, 2N], body int16 [total], counts
    int64 [nb]).

    The row-major [block, step, lane] order of the cells is stream order,
    so a boolean-mask select keeps exactly the emitted words, block after
    block; ``counts`` splits them.  Heads are the final states
    lane-ascending as lo/hi u16 (RansWordEncFlush, rans_word_sse41.h:96-106):
    the states' little-endian halves.
    """
    nb, S = cells.shape
    emitted = cells >= 0x10000
    with span("rans.wait"):  # the select's size comes back to the host
        body = cells.view(torch.int16).view(nb, S, 2)[:, :, 0][emitted]
    heads = states.contiguous().view(torch.int16).view(nb, -1)
    return heads, body, emitted.sum(1)


def stack_blocks(blocks: list[np.ndarray], n_head: int, dtype, device):
    """Per-block word arrays [head of ``n_head`` words | body] -> (words
    [W], heads [nb, n_head], body_off int64 [nb], body_len int32 [nb]) on
    ``device``: one copy of the words to the device, where the heads are
    gathered.  ``dtype`` is the numpy word type; the tensors hold its bits
    in the signed type of the same width.  A head's words are little-endian
    pieces of a lane state, so ``heads.view`` of the state's width gives
    the states."""
    blocks = [np.asarray(w, dtype) for w in blocks]
    lens = np.array([w.size for w in blocks], np.int64)
    if np.any(lens < n_head) or np.any(lens - n_head >= 1 << 31):
        raise ValueError("container corrupt: a block's word count does "
                         "not fit its lane states")
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    signed = np.dtype(f"<i{np.dtype(dtype).itemsize}")
    words, offsets, body_len = to_device(
        np.concatenate(blocks).view(signed), offs,
        (lens - n_head).astype(np.int32), device=device)
    heads = words[offsets.view(-1, 1) + torch.arange(n_head, device=device)]
    return words, heads, offsets + n_head, body_len


def assemble_blocks(heads: np.ndarray, body: np.ndarray,
                    counts: np.ndarray) -> list[np.ndarray]:
    """Heads [nb, H], the group's body and each block's body length ->
    per-block arrays [head | body]."""
    ends = np.cumsum(counts)
    return [np.concatenate([heads[b], body[ends[b] - counts[b]:ends[b]]])
            for b in range(len(counts))]


def prep_decode(word_blocks: list[np.ndarray], n_lanes: int, device):
    """Per-block u16 word arrays [head | body] -> the decode kernel's
    inputs (x0 int32 [nb, N], words int16 [W], body_off int64 [nb],
    body_len int32 [nb]) on ``device``."""
    words, heads, body_off, body_len = stack_blocks(
        word_blocks, 2 * n_lanes, np.uint16, device)
    return heads.view(torch.int32), words, body_off, body_len


def block_sizes(block_symbols: int, padded_len: int) -> list[int]:
    """Padded symbols per block: [B, ..., B, tail]."""
    n_full, tail = divmod(padded_len, block_symbols)
    return [block_symbols] * n_full + ([tail] if tail else [])


def groups(sizes: list[int], group_symbols: int | None = None):
    """Yield (first block, n_blocks, block size) launch groups: runs of
    equal-size blocks of at most ``group_symbols`` symbols (default
    GROUP_SYMBOLS; one block at least) and MAX_GROUP_BLOCKS blocks."""
    if group_symbols is None:
        group_symbols = GROUP_SYMBOLS
    b = 0
    while b < len(sizes):
        size = sizes[b]
        cap = min(MAX_GROUP_BLOCKS, max(1, group_symbols // size))
        n = 1
        while n < cap and b + n < len(sizes) and sizes[b + n] == size:
            n += 1
        yield b, n, size
        b += n


# ---------------------------------------------------------------------------
# Orchestration over full blocks plus a tail
# ---------------------------------------------------------------------------


def encode(cfg: RansConfig, padded: torch.Tensor, freqs,
           cum_freqs) -> list[np.ndarray]:
    """Encode a flat uint8 tensor padded to a multiple of 4*n_lanes ->
    per-block u16 word arrays [head | body] on the host."""
    check_config(cfg)
    N = cfg.n_lanes
    if padded.numel() % (4 * N):
        raise ValueError("input must be padded to a multiple of 4*n_lanes")
    with span("rans.tables"):
        freq, start, table = to_device(
            *host_prep.enc_tables(freqs, cum_freqs),
            host_prep.word_enc_table(freqs, cum_freqs, cfg.prob_bits),
            device=padded.device)
    out: list[np.ndarray] = []
    pos = 0
    for _, nb, size in groups(block_sizes(cfg.block_symbols,
                                          padded.numel())):
        syms = padded[pos:pos + nb * size].view(nb, size)
        pos += nb * size
        with span("rans.launch"):
            cells, states = encode_blocks(syms, freq, start, N,
                                          cfg.prob_bits, table)
        with span("rans.compact"):
            heads, body, counts = compact_emissions(cells, states)
            del cells
        with span("rans.assemble"):
            heads, body, counts = to_host(heads, body, counts)
            out += assemble_blocks(heads.view(np.uint16),
                                   body.view(np.uint16), counts)
    return out


def decode(cfg: RansConfig, word_blocks: list[np.ndarray], sizes: list[int],
           freqs, cum_freqs, device) -> torch.Tensor:
    """Decode per-block u16 word arrays (padded symbol counts ``sizes``,
    all equal but the last) -> flat uint8 tensor on ``device``."""
    check_config(cfg)
    N = cfg.n_lanes
    device = torch.device(device)
    with span("rans.tables"):
        c2s, freq, cum = to_device(
            *host_prep.dec_tables(freqs, cum_freqs, cfg.prob_bits),
            device=device)
    parts = []
    for b0, nb, size in groups(sizes):
        with span("rans.stage"):
            stream = prep_decode(word_blocks[b0:b0 + nb], N, device)
        with span("rans.launch"):
            parts.append(decode_blocks(*stream, c2s, freq, cum, size,
                                       cfg.prob_bits).view(-1))
    if not parts:
        return torch.empty(0, dtype=torch.uint8, device=device)
    return parts[0] if len(parts) == 1 else torch.cat(parts)
