"""RANS64 codec on the card: the K5/K6 kernel wrappers and their plain
PyTorch versions.  ``ops.codec`` drives them.

Counterpart of the reference package's ``ops/rans64_tpu.py``: a 63-bit
state, L = 2^31 and 32-bit renormalisation of at most one word per symbol
(rans64.h), over prob_bits 9-31.  On the card the state is a native
``uint64_t``, and the encoder divides by the reference's reciprocal
(rans64.h:167-247, ``host_prep.rans64_enc_table``) with ``__umul64hi``;
the TPU's 16-bit limb arithmetic has no counterpart.  The plain versions
divide.

Symbol ``i`` of a block is step ``i // N``, lane ``i % N``.  The stream of a
block is [2N u32 head words: the final states lane-ascending as (lo, hi)
(Rans64EncFlush, rans64.h:96-103)] ++ [renorm words, step ascending, lane
ascending].  States cross the wrapper boundary as ``int64`` holding the
u64 bits, u32 words and tables as ``int32`` bit patterns.  The plain
versions hold states in ``int64``: a valid state stays below 2^63.  A
wrapper takes its plain version only for tensors on the CPU; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _kernels
from ..utils.profiling import to_device, to_host
from . import decode_plan, host_prep
from .word import check_tables, i32_as_u32, staged

L_BITS = 31  # rans64.h:59


# ---------------------------------------------------------------------------
# K6: dense encode
# ---------------------------------------------------------------------------


def encode_blocks(syms: torch.Tensor, freq: torch.Tensor,
                  start: torch.Tensor, n_lanes: int, prob_bits: int,
                  table: torch.Tensor | None = None):
    """Dense encode of ``nb`` blocks (K6, ``csrc/rans64_encode.cu``).

    syms: uint8 [nb, S] with S a multiple of n_lanes; freq, start: int32
    [256] (u32 bits).  Returns (cells int64 [nb, S], states int64 [nb,
    n_lanes]): cell ``1 << 32 | word`` where a lane wrote a renorm word at
    that step, else 0, and the final states.  The kernel reads ``table``,
    ``host_prep.rans64_enc_table`` of the same model (int32 [256, 8] on the
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
        raise ValueError(f"no RANS64 encode kernel for {syms.device}")
    if table is None:
        f, st = to_host(freq, start)
        table = to_device(host_prep.rans64_enc_table(
            f.view(np.uint32), st.view(np.uint32), prob_bits),
            device=syms.device)
    syms = staged(syms, table, (256, 8))
    nb, S = syms.shape
    cells = torch.empty((nb, S), dtype=torch.int64, device=syms.device)
    states = torch.empty((nb, n_lanes), dtype=torch.int64,
                         device=syms.device)
    if nb:
        _kernels.call("rans64_encode", syms.device, syms.data_ptr(),
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
    f64, st64 = i32_as_u32(freq), i32_as_u32(start)
    x = torch.full((nb, n_lanes), 1 << L_BITS, dtype=torch.int64,
                   device=syms.device)
    cells = torch.empty((nb, T, n_lanes), dtype=torch.int64,
                        device=syms.device)
    shift = 31 - prob_bits
    for t in range(T - 1, -1, -1):
        s = grid[:, t].to(torch.int64)
        f, st = f64[s], st64[s]
        # x >= freq << (63 - prob_bits), which reaches 2^63 at prob_bits
        # 31, compared on the high word (rans64.h:83)
        m = (x >> 32) >= (f << shift)
        cells[:, t] = torch.where(m, (x & 0xFFFFFFFF) | (1 << 32), 0)
        x = torch.where(m, x >> 32, x)
        x = ((x // f) << prob_bits) + x % f + st
    return cells.view(nb, S), x


# ---------------------------------------------------------------------------
# K5: decode
# ---------------------------------------------------------------------------


def decode_blocks(x0: torch.Tensor, words: torch.Tensor,
                  body_off: torch.Tensor, body_len: torch.Tensor,
                  c2s: torch.Tensor | None, freq: torch.Tensor,
                  cum: torch.Tensor, n_symbols: int, prob_bits: int,
                  plan: decode_plan.DecodePlan | None = None
                  ) -> torch.Tensor:
    """Decode ``nb`` blocks of ``n_symbols`` each (K5,
    ``csrc/rans64_decode.cu``, one thread-block cluster per block).

    x0: int64 [nb, N] initial states; words: int32 [W] stream buffer (u32
    bits), block b's body being ``words[body_off[b]: body_off[b] +
    body_len[b]]`` (int64 / int32 [nb]); c2s: uint8 [2^prob_bits] up to
    prob_bits 16, else None (the symbol is then found by a binary search
    on cum); freq: int32 [256]; cum: int32 [257] (u32 bits).  Returns
    uint8 [nb, n_symbols].  A word read past a block's body reads its last
    word (a corrupt container decodes to garbage, never out of bounds).
    ``plan`` defaults to ``decode_plan.plan("RANS64", N, prob_bits)``;
    another plan of the same shape is for measuring the kernel at other
    cluster sizes.
    """
    if x0.dtype != torch.int64 or x0.dim() != 2 or not x0.is_contiguous():
        raise ValueError("x0 must be contiguous int64 [n_blocks, n_lanes]")
    nb, N = x0.shape
    if n_symbols % N:
        raise ValueError("n_symbols must be a multiple of n_lanes")
    if (words.dtype != torch.int32 or body_off.dtype != torch.int64
            or body_len.dtype != torch.int32 or freq.dtype != torch.int32
            or cum.dtype != torch.int32):
        raise ValueError("decode_blocks: wrong argument dtypes")
    if (body_off.shape != (nb,) or body_len.shape != (nb,)
            or freq.numel() != 256 or cum.numel() != 257):
        raise ValueError("decode_blocks: wrong argument shapes")
    if (c2s is None) != (prob_bits > 16) or c2s is not None and (
            c2s.dtype != torch.uint8 or c2s.numel() != 1 << prob_bits):
        raise ValueError("c2s must be uint8 [2^prob_bits] up to prob_bits "
                         "16 and None above")
    check_tables(x0, words, body_off, body_len, freq, cum,
                  *([] if c2s is None else [c2s]))
    if x0.device.type == "cpu":
        return decode_blocks_ref(x0, words, body_off, body_len, c2s, freq,
                                 cum, n_symbols, prob_bits)
    if x0.device.type != "cuda":
        raise ValueError(f"no RANS64 decode kernel for {x0.device}")
    plan = decode_plan.for_shape(plan, "RANS64", N, prob_bits)
    out = torch.empty((nb, n_symbols), dtype=torch.uint8, device=x0.device)
    if nb:
        _kernels.call("rans64_decode", x0.device, x0.data_ptr(),
                      words.data_ptr(), body_off.data_ptr(),
                      body_len.data_ptr(),
                      None if c2s is None else c2s.data_ptr(),
                      freq.data_ptr(), cum.data_ptr(), out.data_ptr(), nb, N,
                      n_symbols // N, prob_bits, *plan.c_args())
        decode_blocks.launches += 1
    return out


decode_blocks.launches = 0


def max_active_clusters(plan: decode_plan.DecodePlan, device) -> int:
    """``cudaOccupancyMaxActiveClusters`` of K5 under ``plan`` on
    ``device``."""
    return _kernels.query("rans64_decode_occupancy", device, plan.n_lanes,
                          plan.prob_bits, *plan.c_args())


def decode_blocks_ref(x0: torch.Tensor, words: torch.Tensor,
                      body_off: torch.Tensor, body_len: torch.Tensor,
                      c2s: torch.Tensor | None, freq: torch.Tensor,
                      cum: torch.Tensor, n_symbols: int,
                      prob_bits: int) -> torch.Tensor:
    """Plain version of :func:`decode_blocks`: lanes vectorised, a loop
    over steps, the per-step rank as a cumulative sum over lanes."""
    nb, N = x0.shape
    T = n_symbols // N
    dev = x0.device
    x = x0.clone()
    W = words.numel()
    # one trailing zero word: what a lane reads from an empty body
    w = torch.cat([i32_as_u32(words),
                   torch.zeros(1, dtype=torch.int64, device=dev)])
    f64, c64 = i32_as_u32(freq), i32_as_u32(cum)
    c2s64 = None if c2s is None else c2s.to(torch.int64)
    off = body_off.view(nb, 1)
    blen = body_len.to(torch.int64).view(nb, 1)
    cursor = torch.zeros((nb, 1), dtype=torch.int64, device=dev)
    out = torch.empty((nb, T, N), dtype=torch.uint8, device=dev)
    mask = (1 << prob_bits) - 1
    for t in range(T):
        slot = x & mask
        # the symbol whose range [cum[s], cum[s+1]) holds the slot
        s = c2s64[slot] if c2s64 is not None else \
            torch.searchsorted(c64[1:], slot, right=True)
        x = f64[s] * (x >> prob_bits) + slot - c64[s]
        out[:, t] = s.to(torch.uint8)
        m = x < (1 << L_BITS)
        mi = m.to(torch.int64)
        pos = torch.minimum(cursor + torch.cumsum(mi, 1) - mi, blen - 1)
        idx = torch.where(blen > 0, off + pos, W)
        x = torch.where(m, (x << 32) | w[idx], x)
        cursor = cursor + mi.sum(1, keepdim=True)
    return out.view(nb, n_symbols)
