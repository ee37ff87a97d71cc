"""Low-level lane-coder API: the reference's function-level surface as
plain PyTorch functions over lane tensors of any shape.

Counterpart of the reference package's ``ops/coder.py``; maps 1:1 onto the
header API (SURVEY.md §2.1/§2.2).  Every function is vectorized over a
tensor of independent coder states and runs where its inputs lie: on the
card or on the CPU.  ``enc_init``, ``enc_symbol_init`` and
``dec_symbol_init`` make tensors and take ``device="cuda"`` (raising
without a card).  The stream side is functional: encode steps *return*
emitted words plus per-lane counts, decode renorm *consumes* from a shared
word tensor at an explicit ordered cursor (the interleave contract,
rans_byte.h:30-35).

| here                     | rans_byte.h / rans64.h                        |
|--------------------------|-----------------------------------------------|
| enc_init                 | RansEncInit :56 / Rans64EncInit :65           |
| enc_renorm               | RansEncRenorm :62 / inline in Rans64EncPut :81|
| enc_put                  | RansEncPut :83 / Rans64EncPut :77 (slow path) |
| enc_flush                | RansEncFlush :93 / Rans64EncFlush :96         |
| dec_init                 | RansDecInit :109 / Rans64DecInit :107         |
| dec_get                  | RansDecGet :125 / Rans64DecGet :118           |
| dec_advance              | RansDecAdvance :133 / Rans64DecAdvance :126   |
| enc_symbol_init          | RansEncSymbolInit :174 / Rans64... :167       |
| dec_symbol_init          | RansDecSymbolInit :246 / Rans64... :250       |
| enc_put_symbol           | RansEncPutSymbol :258 / Rans64EncPutSymbol :262|
| dec_advance_symbol       | RansDecAdvanceSymbol :283                     |
| dec_advance_step         | RansDecAdvanceStep :291                       |
| dec_advance_symbol_step  | RansDecAdvanceSymbolStep :301                 |
| dec_renorm               | RansDecRenorm :307 / Rans64DecRenorm :305     |

States are ``int64`` tensors.  A 32-bit state (BYTE, WORD, ALIAS) holds
its value; the encode steps reduce their results to 32 bits as u32
arithmetic does (so the WORD renorm threshold wraps to 0 at freq
2^scale_bits, as in u32), and the decode steps of a valid stream stay
below 2^32 by the invariant L <= x < b*L.  A 64-bit state (RANS64) and
the 64-bit reciprocals (up to 2^64 - 1) hold their bit pattern: products
wrap modulo 2^64 as u64 products do, right shifts are logical (masked)
and compares are unsigned (both sides biased by 2^63).  Words of a stream
or a head may be given in any integer dtype, bit patterns included
(``int16`` for u16 words): they are masked to the variant's word width.

``enc_put_symbol`` is the division-free path: Alverson fixed-point
reciprocals (rans_byte.h:229-242), with the high half of the product built
from 32-bit halves at 64 bits.  Parameters come from
``models.tables.build_byte_enc_tables`` / ``build_rans64_enc_tables``,
including the freq<2 special case (rans_byte.h:199-228).

The kernels (``ops.word`` / ``ops.byte`` / ``ops.rans64``) are the fused
production path; this module is the composable one: build custom
interleavings, inspect states, or prototype new variants with the same
arithmetic.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..api import _device
from ..config import NSYMS, VariantSpec
from ..models import tables as tables_mod

_M32 = 0xFFFFFFFF
#: Added (xor) to both sides of a signed compare to make it unsigned.
_BIAS = torch.iinfo(torch.int64).min


def _wrap(x: torch.Tensor, spec: VariantSpec) -> torch.Tensor:
    """A 32-bit state keeps its low 32 bits (u32 arithmetic); a 64-bit
    state's int64 bits already wrap as u64 arithmetic does."""
    return x & _M32 if spec.state_bits == 32 else x


def _shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns by a constant ``k``."""
    return x if k == 0 else (x >> k) & ((1 << (64 - k)) - 1)


def _uge(a: torch.Tensor, b) -> torch.Tensor:
    """Unsigned ``a >= b`` on int64 bit patterns."""
    return (a ^ _BIAS) >= (b ^ _BIAS)


def _table(a, device) -> torch.Tensor:
    """A host array as an int64 tensor on ``device`` (u64 keeps its
    bits)."""
    a = np.asarray(a)
    a = a.view(np.int64) if a.dtype == np.uint64 else a.astype(np.int64)
    return torch.from_numpy(a).to(device)


def _on(v, x: torch.Tensor):
    """``v`` (a tensor, a host array or an integer) as int64 values, on
    ``x``'s device."""
    if isinstance(v, torch.Tensor):
        return v.to(device=x.device, dtype=torch.int64)
    if isinstance(v, (int, np.integer)):
        return int(v)
    return _table(v, x.device)


def _index(sym) -> torch.Tensor:
    return torch.as_tensor(sym).to(torch.int64)


# -- encoder ---------------------------------------------------------------


def enc_init(shape, spec: VariantSpec, device="cuda") -> torch.Tensor:
    """state <- L (RansEncInit, rans_byte.h:56-59)."""
    return torch.full(shape, spec.L, dtype=torch.int64,
                      device=_device(device))


def enc_renorm(x, freq, spec: VariantSpec, scale_bits: int):
    """Bounded masked renorm: emit while x >= x_max = freq << shift.

    Returns (x, words, k): ``words[r]`` is the r-th word in forward/decoder
    order (most-significant first), ``k`` the per-lane emission count
    (0..spec.max_renorm).  Mirrors RansEncRenorm (rans_byte.h:62-74) with
    the loop unrolled to its proven bound.
    """
    x_max = _wrap(_on(freq, x) * ((spec.L >> scale_bits) << spec.word_bits),
                  spec)
    return _renorm(x, x_max, spec)


def _renorm(x, x_max, spec: VariantSpec):
    k = torch.zeros(x.shape, dtype=torch.int64, device=x.device)
    emitted = []
    for _ in range(spec.max_renorm):
        m = _uge(x, x_max)
        emitted.append(torch.where(m, x & spec.word_mask, 0))
        x = torch.where(m, _shr(x, spec.word_bits), x)
        k = k + m
    return x, torch.stack(emitted[::-1]), k


def enc_put(x, sym, freqs, cum_freqs, spec: VariantSpec, scale_bits: int):
    """Slow-path encode step (RansEncPut, rans_byte.h:83-90): renorm then
    ``x <- (x // f) << sb + (x % f) + start``.  Returns (x, words, k)."""
    sym = _index(sym).to(x.device)
    f = _on(freqs, x)[sym]
    start = _on(cum_freqs[:NSYMS], x)[sym]
    return enc_put_raw(x, start, f, spec, scale_bits)


def enc_put_raw(x, start, freq, spec: VariantSpec, scale_bits: int):
    """enc_put with explicit per-lane (start, freq) -- the reference's
    actual RansEncPut signature (rans_byte.h:83), for callers driving a
    custom model rather than the 256-symbol tables."""
    f, s = _on(freq, x), _on(start, x)
    x, words, k = enc_renorm(x, f, spec, scale_bits)
    # after the renorm x < x_max <= 2^63: non-negative, so // and % hold
    x = _wrap(((x // f) << scale_bits) + x % f + s, spec)
    return x, words, k


def enc_flush(x, spec: VariantSpec) -> torch.Tensor:
    """Serialize final states as little-endian words, lane-major
    (RansEncFlush, rans_byte.h:93-105): out[lane, w] = (x >> w*wb) & mask."""
    return torch.stack([(x >> (spec.word_bits * w)) & spec.word_mask
                        for w in range(spec.state_words)], dim=-1)


# -- decoder ---------------------------------------------------------------


def dec_init(head_words, spec: VariantSpec) -> torch.Tensor:
    """head_words[lane, w] little-endian -> states (RansDecInit,
    rans_byte.h:109-122)."""
    h = torch.as_tensor(head_words).to(torch.int64) & spec.word_mask
    x = torch.zeros(h.shape[:-1], dtype=torch.int64, device=h.device)
    for w in range(spec.state_words):
        x = x | (h[..., w] << (spec.word_bits * w))
    return x


def dec_get(x, scale_bits: int) -> torch.Tensor:
    """Cumulative-frequency slot (RansDecGet, rans_byte.h:125-128)."""
    return x & ((1 << scale_bits) - 1)


def dec_advance_step(x, start, freq, scale_bits: int) -> torch.Tensor:
    """Advance WITHOUT renorm (RansDecAdvanceStep, rans_byte.h:291-298) --
    the pure lane-local half of the interleaving split."""
    mask = (1 << scale_bits) - 1
    return _on(freq, x) * _shr(x, scale_bits) + (x & mask) - _on(start, x)


def dec_renorm(x, stream, base, spec: VariantSpec):
    """Ordered shared-stream refill (RansDecRenorm, rans_byte.h:307-318).

    ``stream`` is a 1-D word tensor; lanes refill in flattened lane order
    starting at cursor ``base`` -- the interleave contract the encoder
    produced (SURVEY.md §3.3).  The per-lane word count is closed-form
    (word_bits <= l_bits, see reference_numpy.LaneCoder.dec_need), so
    consumption is a prefix sum, not a loop.  Returns (x, new_base).
    """
    stream = torch.as_tensor(stream)
    flat = x.reshape(-1)
    k = torch.zeros(flat.shape, dtype=torch.int64, device=x.device)
    t = flat
    for _ in range(spec.max_renorm):
        m = ~_uge(t, spec.L)
        k = k + m
        t = torch.where(m, t << spec.word_bits, t)
    off = base + torch.cumsum(k, 0) - k
    last = stream.numel() - 1
    for r in range(spec.max_renorm):
        m = k > r
        idx = torch.where(m, off + r, 0).clamp(max=last).to(stream.device)
        w = stream[idx].to(device=x.device, dtype=torch.int64) \
            & spec.word_mask
        flat = torch.where(m, (flat << spec.word_bits) | w, flat)
    return flat.reshape(x.shape), base + k.sum()


def dec_advance(x, stream, base, start, freq, spec: VariantSpec,
                scale_bits: int):
    """Step + renorm fused (RansDecAdvance, rans_byte.h:133-149)."""
    x = dec_advance_step(x, start, freq, scale_bits)
    return dec_renorm(x, stream, base, spec)


# -- precomputed symbols (division-free encode) ----------------------------


@dataclasses.dataclass(frozen=True)
class EncSymbols:
    """Device-side RansEncSymbol table (rans_byte.h:159-165), SoA: int64
    tensors over the 256 symbols (u64 values as their bits)."""

    x_max: torch.Tensor
    rcp_freq: torch.Tensor
    bias: torch.Tensor
    cmpl_freq: torch.Tensor
    rcp_shift: torch.Tensor
    state_bits: int


def enc_symbol_init(freqs, cum_freqs, scale_bits: int, spec: VariantSpec,
                    device="cuda") -> EncSymbols:
    """Alverson reciprocal parameters (RansEncSymbolInit,
    rans_byte.h:174-243 / rans64.h:167-247) incl. the freq<2 case, on
    ``device``."""
    dev = _device(device)
    if spec.state_bits == 32:
        t = tables_mod.build_byte_enc_tables(freqs, cum_freqs, scale_bits,
                                             l_bits=spec.l_bits)
        # x_max depends on the renorm word width (rans_word_sse41.h:85 uses
        # 16-bit words); the reciprocal parameters don't.  u32, as there.
        x_max = (np.asarray(freqs, np.uint64)
                 * ((spec.L >> scale_bits) << spec.word_bits)) & _M32
        return EncSymbols(_table(x_max, dev), _table(t.rcp_freq, dev),
                          _table(t.bias, dev), _table(t.cmpl_freq, dev),
                          _table(t.rcp_shift, dev), 32)
    t = tables_mod.build_rans64_enc_tables(freqs, cum_freqs, scale_bits)
    # x_max = freq << (63 - scale_bits), u64: 2^63 at freq 2^scale_bits
    x_max = np.asarray(t.freq, np.uint64) << np.uint64(63 - scale_bits)
    return EncSymbols(_table(x_max, dev), _table(t.rcp_freq, dev),
                      _table(t.bias, dev), _table(t.cmpl_freq, dev),
                      _table(t.rcp_shift, dev), 64)


def dec_symbol_init(freqs, cum_freqs, device="cuda"):
    """(start, freq) pair of int64 tensors (RansDecSymbolInit,
    rans_byte.h:246-252), on ``device``."""
    dev = _device(device)
    return (_table(np.asarray(cum_freqs)[:NSYMS], dev),
            _table(freqs, dev))


def _mulhi(a, b, bits: int) -> torch.Tensor:
    """High half of the unsigned product at the state width (Rans64MulHi,
    rans64.h:31-51; plain widening for 32-bit).  A partial product of two
    32-bit halves can reach 2^64 - 2^33 + 1: in int64 it wraps, and keeps
    the product's bits, which is all the sum below needs."""
    if bits == 32:
        # a, b < 2^32: the wrapped product holds all 64 bits of a * b
        return _shr(a * b, 32)
    al, ah = a & _M32, _shr(a, 32)
    bl, bh = b & _M32, _shr(b, 32)
    p_lh = al * bh
    p_hl = ah * bl
    # below 3 * 2^32: no wrap
    mid = _shr(al * bl, 32) + (p_lh & _M32) + (p_hl & _M32)
    # the high word is below 2^64, so its wrapped sum is its bits
    return ah * bh + _shr(p_lh, 32) + _shr(p_hl, 32) + _shr(mid, 32)


def enc_put_symbol(x, sym, esyms: EncSymbols, spec: VariantSpec,
                   scale_bits: int):
    """Division-free encode step (RansEncPutSymbol, rans_byte.h:258-280):
    renorm, then ``q = mulhi(x, rcp) >> shift; x += bias + q * cmpl_freq``.
    Returns (x, words, k)."""
    sym = _index(sym).to(x.device)
    x, words, k = _renorm(x, esyms.x_max[sym], spec)
    # x < x_max <= 2^63 after the renorm, so the high half is
    # non-negative and a plain shift is logical
    q = _mulhi(x, esyms.rcp_freq[sym], spec.state_bits) \
        >> esyms.rcp_shift[sym]
    x = _wrap(x + esyms.bias[sym] + q * esyms.cmpl_freq[sym], spec)
    return x, words, k


def dec_advance_symbol(x, stream, base, starts, freqs, sym,
                       spec: VariantSpec, scale_bits: int):
    """RansDecAdvanceSymbol (rans_byte.h:283-286)."""
    sym = _index(sym).to(x.device)
    return dec_advance(x, stream, base, starts[sym], freqs[sym], spec,
                       scale_bits)


def dec_advance_symbol_step(x, starts, freqs, sym, scale_bits: int):
    """RansDecAdvanceSymbolStep (rans_byte.h:301-304)."""
    sym = _index(sym).to(x.device)
    return dec_advance_step(x, starts[sym], freqs[sym], scale_bits)
