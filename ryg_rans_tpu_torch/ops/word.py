"""WORD codec on the card: the K1/K2 kernel wrappers and their plain
PyTorch versions, with the wrapper-level checks and bit casts that the
BYTE and RANS64 wrappers share.  ``ops.codec`` drives them.

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

import torch

from .. import _kernels
from ..utils.profiling import to_device, to_host
from . import decode_plan, host_prep


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
