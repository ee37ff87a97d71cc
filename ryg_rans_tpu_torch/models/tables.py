"""Division-free encoder parameters per symbol, built once per model in
NumPy: the reference's RansEncSymbolInit for the 32-bit state with 8-bit
renormalisation (rans_byte.h:174-243, applied at rans_byte.h:258-280) and
for the 64-bit state (rans64.h:167-247), and the port's own for the WORD
coder's 32-bit state with 16-bit renormalisation
(:func:`build_word_enc_tables`).

For ``freq >= 2`` the reciprocal is ``rcp = ceil(2^(shift + 31) / freq)``
with ``shift = ceil(log2(freq))`` and ``rcp_shift = shift - 1``, so that
``q = mulhi32(x, rcp) >> rcp_shift`` equals ``x // freq`` for every state
``x < 2^31``; then ``x' = x + bias + q * cmpl_freq`` with ``bias = start``
and ``cmpl_freq = 2^scale_bits - freq``.  ``freq == 1`` has no reciprocal
below 1.0: it takes ``rcp = 2^32 - 1`` and ``rcp_shift = 0``, which gives
``q = x - 1``, and folds the difference into ``bias = start + M - 1``
(rans_byte.h:199-228).  A coder that needs the true quotient (ALIAS, whose
remainder indexes its remap) takes ``q = x`` where ``freq == 1``.

Each result is a struct of arrays over the 256 symbols.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import NSYMS

_U32 = 0xFFFFFFFF
_U64 = 0xFFFFFFFFFFFFFFFF


@dataclasses.dataclass
class ByteEncTables:
    """RansEncSymbol (rans_byte.h:159-165) over 256 symbols."""

    x_max: np.ndarray      # u32: renorm threshold, freq << (l_bits - scale + 8)
    rcp_freq: np.ndarray   # u32 fixed-point reciprocal
    bias: np.ndarray       # u32
    cmpl_freq: np.ndarray  # u32: (1 << scale_bits) - freq
    rcp_shift: np.ndarray  # u32


def _rcp_shift(freq: int) -> int:
    """ceil(log2(freq)) for freq >= 2."""
    shift = 0
    while freq > (1 << shift):
        shift += 1
    return shift


def build_byte_enc_tables(freqs: np.ndarray, cum_freqs: np.ndarray,
                          scale_bits: int, l_bits: int = 23
                          ) -> ByteEncTables:
    """Encode parameters of the 32-bit state with 8-bit renormalisation
    (BYTE, and ALIAS's quotient), scale_bits at most 16."""
    assert scale_bits <= 16
    n = NSYMS
    out = ByteEncTables(*(np.zeros(n, np.uint32) for _ in range(5)))
    M = 1 << scale_bits
    for s in range(n):
        freq = int(freqs[s])
        start = int(cum_freqs[s])
        out.x_max[s] = ((1 << l_bits) >> scale_bits << 8) * freq & _U32
        out.cmpl_freq[s] = (M - freq) & _U32
        if freq < 2:
            out.rcp_freq[s] = _U32
            out.rcp_shift[s] = 0
            out.bias[s] = (start + M - 1) & _U32
        else:
            shift = _rcp_shift(freq)
            out.rcp_freq[s] = ((1 << (shift + 31)) + freq - 1) // freq & _U32
            out.rcp_shift[s] = shift - 1
            out.bias[s] = start
    return out


@dataclasses.dataclass
class Rans64EncTables:
    """Rans64EncSymbol (rans64.h:152-158) over 256 symbols."""

    freq: np.ndarray       # u32
    rcp_freq: np.ndarray   # u64
    bias: np.ndarray       # u32
    cmpl_freq: np.ndarray  # u32
    rcp_shift: np.ndarray  # u32


def build_rans64_enc_tables(freqs: np.ndarray, cum_freqs: np.ndarray,
                            scale_bits: int) -> Rans64EncTables:
    """Encode parameters of the 64-bit state (rans64.h:167-247), scale_bits
    at most 31: the reciprocal is ceil(2^(shift + 63) / freq), exact in
    Python integers."""
    assert scale_bits <= 31
    n = NSYMS
    out = Rans64EncTables(np.zeros(n, np.uint32), np.zeros(n, np.uint64),
                          np.zeros(n, np.uint32), np.zeros(n, np.uint32),
                          np.zeros(n, np.uint32))
    M = 1 << scale_bits
    for s in range(n):
        freq = int(freqs[s])
        start = int(cum_freqs[s])
        out.freq[s] = freq
        out.cmpl_freq[s] = (M - freq) & _U32
        if freq < 2:
            out.rcp_freq[s] = _U64
            out.rcp_shift[s] = 0
            out.bias[s] = (start + M - 1) & _U32
        else:
            shift = _rcp_shift(freq)
            out.rcp_freq[s] = ((1 << (shift + 63)) + freq - 1) // freq & _U64
            out.rcp_shift[s] = shift - 1
            out.bias[s] = start
    return out


@dataclasses.dataclass
class WordEncTables:
    """Division-free WORD encode parameters over 256 symbols."""

    x_max_m1: np.ndarray   # u32: (freq << (32 - scale_bits)) - 1
    rcp_freq: np.ndarray   # u64: ceil(2^64 / freq)
    bias: np.ndarray       # u32
    cmpl_freq: np.ndarray  # u32: (1 << scale_bits) - freq


def build_word_enc_tables(freqs: np.ndarray, cum_freqs: np.ndarray,
                          scale_bits: int) -> WordEncTables:
    """Encode parameters of the WORD coder's 32-bit state (16-bit renorm,
    L = 2^16), scale_bits at most 15.

    After renormalisation the state lies below ``freq << (32 -
    scale_bits)``, which passes 2^31 when ``freq > 2^(scale_bits - 1)``,
    so the 31-bit reciprocal of :func:`build_byte_enc_tables` is not exact
    here.  The quotient is ``q = mulhi64(x, rcp_freq)`` with ``rcp_freq =
    ceil(2^64 / freq)``, exact for every 32-bit state: with ``e =
    rcp_freq * freq - 2^64 < freq``, the error ``x * e / (freq * 2^64)``
    stays below ``1 / freq`` while ``x * e < 2^64``.  ``freq == 1`` takes
    ``rcp_freq = 2^64 - 1``, which gives ``q = x - 1`` for ``x >= 1``, and
    folds the difference into ``bias = start + M - 1`` as the reference's
    BYTE coder does; elsewhere ``bias = start``.  The step is then ``x +=
    bias + q * cmpl_freq`` in 32-bit arithmetic.  The renorm threshold is
    kept as ``x_max - 1``: ``x_max`` reaches 2^32 in the one-symbol model.
    """
    assert scale_bits <= 15
    n = NSYMS
    out = WordEncTables(np.zeros(n, np.uint32), np.zeros(n, np.uint64),
                        np.zeros(n, np.uint32), np.zeros(n, np.uint32))
    M = 1 << scale_bits
    for s in range(n):
        freq = int(freqs[s])
        start = int(cum_freqs[s])
        out.x_max_m1[s] = ((freq << (32 - scale_bits)) - 1) & _U32
        out.cmpl_freq[s] = (M - freq) & _U32
        if freq < 2:
            out.rcp_freq[s] = _U64
            out.bias[s] = (start + M - 1) & _U32
        else:
            out.rcp_freq[s] = -(-(1 << 64) // freq)
            out.bias[s] = start
    return out
