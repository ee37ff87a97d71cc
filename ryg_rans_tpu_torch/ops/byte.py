"""BYTE and ALIAS codecs on the card: the K3/K4 kernel wrappers, their plain
PyTorch versions, and the compaction of K4's cells.  ``ops.codec`` drives
them.

Counterpart of the reference package's ``ops/byte_tpu.py``.  Both variants
share the state machine of rans_byte.h: a u32 state, L = 2^23, and 8-bit
renormalisation of at most two bytes per symbol; they differ in the symbol
lookup.  BYTE maps a slot to its symbol through cum2sym; ALIAS through the
alias tables (main_alias.cpp:241-267), and its encoder writes
``remap[x % freq + start]`` where BYTE adds ``x % freq + start``.

Symbol ``i`` of a block is step ``i // N``, lane ``i % N``.  The stream of a
block is [4N head bytes: the final states lane-ascending, little-endian
(rans_byte.h:93-105)] ++ [renorm bytes, step ascending, lane ascending,
most significant byte first].  u32 states cross the wrapper boundary as
``int32`` bit patterns; the plain versions widen to ``int64``.  A wrapper
takes its plain version only for tensors on the CPU; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _kernels
from ..utils.profiling import span, to_device, to_host
from . import decode_plan, host_prep
from .word import check_tables, i32_as_u32, staged, u32_as_i32

L_BITS = 23  # rans_byte.h:50


# ---------------------------------------------------------------------------
# K4: dense encode
# ---------------------------------------------------------------------------


def encode_blocks(syms: torch.Tensor, freq: torch.Tensor,
                  start: torch.Tensor, remap: torch.Tensor | None,
                  n_lanes: int, prob_bits: int,
                  table: torch.Tensor | None = None):
    """Dense encode of ``nb`` blocks (K4, ``csrc/byte_encode.cu``).

    syms: uint8 [nb, S] with S a multiple of n_lanes; freq, start: int32
    [256]; remap: None for BYTE, or the ALIAS remap int16 [2^prob_bits]
    (u16 bits).  Returns (cells int32 [nb, S], states int32 [nb, n_lanes]):
    cell ``k << 16 | fwd0 << 8 | fwd1`` where a lane wrote k = 1 or 2 renorm
    bytes at that step (fwd0 first in stream order, fwd1 = 0 when k = 1),
    else 0, and the final states as u32 bits.  The kernel reads ``table``,
    ``host_prep.byte_enc_table`` of the same model and variant (int32
    [256, 4] on the data's device), in place of freq and start; without
    it, the wrapper builds it from them (a copy to the host).
    """
    if (syms.dtype != torch.uint8 or syms.dim() != 2
            or syms.shape[1] % n_lanes or not syms.is_contiguous()):
        raise ValueError("syms must be contiguous uint8 [n_blocks, "
                         "steps * n_lanes]")
    if freq.dtype != torch.int32 or start.dtype != torch.int32 \
            or freq.numel() != 256 or start.numel() != 256:
        raise ValueError("freq and start must be int32 [256]")
    if remap is not None and (remap.dtype != torch.int16
                              or remap.numel() != 1 << prob_bits):
        raise ValueError("remap must be int16 [2^prob_bits]")
    check_tables(syms, freq, start, *([] if remap is None else [remap]))
    if syms.device.type == "cpu":
        return encode_blocks_ref(syms, freq, start, remap, n_lanes, prob_bits)
    if syms.device.type != "cuda":
        raise ValueError(f"no BYTE/ALIAS encode kernel for {syms.device}")
    if table is None:
        f, st = to_host(freq, start)
        table = to_device(host_prep.byte_enc_table(
            f.view(np.uint32), st.view(np.uint32), prob_bits,
            remap is not None), device=syms.device)
    syms = staged(syms, table, (256, 4))
    nb, S = syms.shape
    cells = torch.empty((nb, S), dtype=torch.int32, device=syms.device)
    states = torch.empty((nb, n_lanes), dtype=torch.int32,
                         device=syms.device)
    if nb:
        _kernels.call("byte_encode", syms.device, syms.data_ptr(),
                      table.data_ptr(),
                      None if remap is None else remap.data_ptr(),
                      cells.data_ptr(), states.data_ptr(), nb, n_lanes,
                      S // n_lanes, prob_bits)
        encode_blocks.launches += 1
    return cells, states


encode_blocks.launches = 0


def encode_blocks_ref(syms: torch.Tensor, freq: torch.Tensor,
                      start: torch.Tensor, remap: torch.Tensor | None,
                      n_lanes: int, prob_bits: int):
    """Plain version of :func:`encode_blocks`: the same arithmetic,
    vectorised over lanes with a loop over steps, states in int64."""
    nb, S = syms.shape
    T = S // n_lanes
    grid = syms.view(nb, T, n_lanes)
    f64, st64 = freq.to(torch.int64), start.to(torch.int64)
    rm = None if remap is None else remap.to(torch.int64) & 0xFFFF
    x = torch.full((nb, n_lanes), 1 << L_BITS, dtype=torch.int64,
                   device=syms.device)
    cells = torch.empty((nb, T, n_lanes), dtype=torch.int32,
                        device=syms.device)
    shift = 31 - prob_bits  # x_max = freq << (L_BITS - prob_bits + 8)
    for t in range(T - 1, -1, -1):
        s = grid[:, t].to(torch.int64)
        f, st = f64[s], st64[s]
        thr = f << shift
        m1 = x >= thr
        ba = x & 0xFF
        x = torch.where(m1, x >> 8, x)
        m2 = x >= thr
        bb = x & 0xFF
        x = torch.where(m2, x >> 8, x)
        # forward (decoder) order is the reverse of emission order
        cell = torch.where(m2, (2 << 16) | (bb << 8) | ba,
                           (1 << 16) | (ba << 8))
        cells[:, t] = torch.where(m1, cell, 0)
        q, r = x // f, x % f
        x = (q << prob_bits) + r + st if rm is None \
            else (q << prob_bits) | rm[r + st]
    return cells.view(nb, S), u32_as_i32(x)


# ---------------------------------------------------------------------------
# K3: decode
# ---------------------------------------------------------------------------


def decode_blocks(x0: torch.Tensor, data: torch.Tensor,
                  body_off: torch.Tensor, body_len: torch.Tensor,
                  tables: tuple, n_symbols: int, prob_bits: int,
                  alias: bool, plan: decode_plan.DecodePlan | None = None
                  ) -> torch.Tensor:
    """Decode ``nb`` blocks of ``n_symbols`` each (K3,
    ``csrc/byte_decode.cu``, one thread-block cluster per block).

    x0: int32 [nb, N] initial states (u32 bits); data: uint8 [W] stream
    buffer, block b's body being ``data[body_off[b]: body_off[b] +
    body_len[b]]`` (int64 / int32 [nb]); tables: BYTE ``(cum2sym uint8
    [2^prob_bits], freq int32 [256], cum int32 [256])`` or ALIAS
    ``(divider int32 [256], sym, freq, adjust int32 [512])``
    (``host_prep``).  Returns uint8 [nb, n_symbols].  A byte read past a
    block's body reads its last byte (a corrupt container decodes to
    garbage, never out of bounds).  ``plan`` defaults to
    ``decode_plan.plan(variant, N, prob_bits)``; another plan of the same
    shape is for measuring the kernel at other cluster sizes.
    """
    if x0.dtype != torch.int32 or x0.dim() != 2 or not x0.is_contiguous():
        raise ValueError("x0 must be contiguous int32 [n_blocks, n_lanes]")
    nb, N = x0.shape
    if n_symbols % N:
        raise ValueError("n_symbols must be a multiple of n_lanes")
    if (data.dtype != torch.uint8 or body_off.dtype != torch.int64
            or body_len.dtype != torch.int32
            or body_off.shape != (nb,) or body_len.shape != (nb,)):
        raise ValueError("decode_blocks: wrong stream dtypes or shapes")
    if alias:
        shapes = [(torch.int32, 256)] + [(torch.int32, 512)] * 3
    else:
        shapes = [(torch.uint8, 1 << prob_bits), (torch.int32, 256),
                  (torch.int32, 256)]
    if len(tables) != len(shapes) or any(
            t.dtype != d or t.numel() != n for t, (d, n) in zip(tables,
                                                                shapes)):
        raise ValueError("decode_blocks: wrong table dtypes or shapes")
    check_tables(x0, data, body_off, body_len, *tables)
    if x0.device.type == "cpu":
        return decode_blocks_ref(x0, data, body_off, body_len, tables,
                                 n_symbols, prob_bits, alias)
    if x0.device.type != "cuda":
        raise ValueError(f"no BYTE/ALIAS decode kernel for {x0.device}")
    variant = "ALIAS" if alias else "BYTE"
    plan = decode_plan.for_shape(plan, variant, N, prob_bits)
    out = torch.empty((nb, n_symbols), dtype=torch.uint8, device=x0.device)
    if nb:
        ptrs = [t.data_ptr() for t in tables] + [None] * (4 - len(tables))
        _kernels.call("byte_decode", x0.device, x0.data_ptr(),
                      data.data_ptr(), body_off.data_ptr(),
                      body_len.data_ptr(), *ptrs, out.data_ptr(), nb, N,
                      n_symbols // N, prob_bits, int(alias), *plan.c_args())
        decode_blocks.launches += 1
    return out


decode_blocks.launches = 0


def max_active_clusters(plan: decode_plan.DecodePlan, device) -> int:
    """``cudaOccupancyMaxActiveClusters`` of K3 under ``plan`` on
    ``device``."""
    return _kernels.query("byte_decode_occupancy", device, plan.n_lanes,
                          plan.prob_bits, int(plan.variant == "ALIAS"),
                          *plan.c_args())


def decode_blocks_ref(x0: torch.Tensor, data: torch.Tensor,
                      body_off: torch.Tensor, body_len: torch.Tensor,
                      tables: tuple, n_symbols: int, prob_bits: int,
                      alias: bool) -> torch.Tensor:
    """Plain version of :func:`decode_blocks`: lanes vectorised, a loop
    over steps, the per-step byte ranks as a cumulative sum over lanes."""
    nb, N = x0.shape
    T = n_symbols // N
    dev = x0.device
    x = i32_as_u32(x0)
    W = data.numel()
    # one trailing zero byte: what a lane reads from an empty body
    d = torch.cat([data.to(torch.int64),
                   torch.zeros(1, dtype=torch.int64, device=dev)])
    t64 = [t.to(torch.int64) for t in tables]
    off = body_off.view(nb, 1)
    blen = body_len.to(torch.int64).view(nb, 1)
    cursor = torch.zeros((nb, 1), dtype=torch.int64, device=dev)
    out = torch.empty((nb, T, N), dtype=torch.uint8, device=dev)
    mask = (1 << prob_bits) - 1

    def read(pos):
        idx = torch.where(blen > 0, off + torch.minimum(pos, blen - 1), W)
        return d[idx]

    for t in range(T):
        slot = x & mask
        if alias:
            div, sym, freq, adj = t64
            bucket = slot >> (prob_bits - 8)
            b2 = 2 * bucket + (slot < div[bucket]).to(torch.int64)
            s = sym[b2]
            x = freq[b2] * (x >> prob_bits) + slot - adj[b2]
        else:
            c2s, freq, cum = t64
            s = c2s[slot]
            x = freq[s] * (x >> prob_bits) + slot - cum[s]
        out[:, t] = s.to(torch.uint8)
        # closed-form refill count k = (x < 2^23) + (x < 2^15)
        m1 = x < (1 << L_BITS)
        m2 = x < (1 << (L_BITS - 8))
        k = m1.to(torch.int64) + m2.to(torch.int64)
        pos = cursor + torch.cumsum(k, 1) - k
        b0, b1 = read(pos), read(pos + 1)
        x = torch.where(m2, (x << 16) | (b0 << 8) | b1,
                        torch.where(m1, (x << 8) | b0, x))
        cursor = cursor + k.sum(1, keepdim=True)
    return out.view(nb, n_symbols)


# ---------------------------------------------------------------------------
# Compaction
# ---------------------------------------------------------------------------


def compact_emissions(cells: torch.Tensor, states: torch.Tensor):
    """Dense cells -> (heads uint8 [nb, 4N], body uint8 [total], counts
    int64 [nb]).

    The row-major [block, step, lane] order of the cells, with each cell's
    (fwd0, fwd1) pair after it, is stream order, so one boolean select
    under the mask (k >= 1, k == 2) keeps exactly the written bytes, block
    after block.  Heads are the final states as 4 little-endian bytes per
    lane (RansEncFlush, rans_byte.h:93-105).
    """
    nb, S = cells.shape
    # a cell's little-endian bytes are (fwd1, fwd0, k, 0)
    cb = cells.view(torch.uint8).view(nb, S, 4)
    k = cb[:, :, 2]
    mask = torch.stack([k >= 1, k == 2], 2)
    with span("rans.wait"):  # the select's size comes back to the host
        body = cb[:, :, :2].flip(2)[mask]
    counts = k.sum(1, dtype=torch.int64)
    heads = states.contiguous().view(torch.uint8).view(nb, -1)
    return heads, body, counts
