"""Host-side model tables in the layout the port's kernels read.

Each kernel copies its tables into shared memory at start.  Values that
are unsigned 32-bit in the reference travel as ``int32`` arrays holding the
bit pattern.  The reference package's sym4 packing, mod-4 interleaved
segment tables and bisect keys served the TPU's gathers and its lack of
64-bit integers, and have no counterpart here.

* WORD and BYTE decode: ``uint8`` cum2sym of 2^prob_bits entries, then the
  symbol's ``freq`` and ``cum`` (separate arrays: at BYTE prob_bits 16 a
  one-symbol model has freq 2^16, which no 16-bit field holds).
* Encode (every variant): ``freq`` and ``start`` (= cum) per symbol; the
  plain versions read these.  The kernels read one row per symbol instead,
  with a reciprocal of ``models/tables.py`` in place of the divide:
  16 bytes for WORD (:func:`word_enc_table`) and BYTE/ALIAS
  (:func:`byte_enc_table`), 32 for RANS64 (:func:`rans64_enc_table`).
* ALIAS decode: the absolute bucket divider [256], then per half
  (bucket2 = 2*bucket + (slot < divider)) the symbol, its freq and the
  signed slot adjust [512].  ALIAS encode adds the flat remap [2^prob_bits].
* RANS64 decode: cum2sym up to prob_bits 16; above, the kernel searches
  ``cum`` [257] (cum[256] = 2^prob_bits reaches 2^31).
"""

from __future__ import annotations

import numpy as np

from ..models import alias as alias_mod
from ..models import stats, tables


def _i32(a) -> np.ndarray:
    """Values in [0, 2^32) -> int32 array of the same bits."""
    return np.asarray(a, np.int64).astype(np.uint32).view(np.int32)


def dec_tables(freqs, cum_freqs, prob_bits: int):
    """WORD / BYTE decode -> (cum2sym uint8[2^prob_bits], freq int32[256],
    cum int32[256])."""
    c2s = stats.cum2sym(np.asarray(cum_freqs, np.uint64), prob_bits)
    return (c2s, np.asarray(freqs, np.int64).astype(np.int32),
            np.asarray(cum_freqs[:256], np.int64).astype(np.int32))


def enc_tables(freqs, cum_freqs):
    """-> (freq int32[256], start int32[256]), u32 bits: RANS64 prob_bits 31
    reaches 2^31 in both."""
    return _i32(freqs), _i32(np.asarray(cum_freqs)[:256])


def byte_enc_table(freqs, cum_freqs, prob_bits: int,
                   alias: bool) -> np.ndarray:
    """BYTE / ALIAS encode kernel -> int32 [256, 4], u32 bits: per symbol
    (x_max, rcp_freq, BYTE bias | ALIAS freq, BYTE cmpl_freq | ALIAS start,
    with rcp_shift in the top 8 bits of the last word).  A step is then
    ``q = mulhi(x, rcp_freq) >> rcp_shift`` and BYTE ``x += bias + q *
    cmpl_freq``, ALIAS ``x = q << prob_bits | remap[x - q * freq + start]``,
    where ALIAS takes ``q = x`` at ``freq == 1`` (the table's ``q = x - 1``
    is folded into BYTE's bias)."""
    t = tables.build_byte_enc_tables(freqs, cum_freqs, prob_bits)
    low = (np.asarray(cum_freqs[:256], np.uint32) if alias
           else t.cmpl_freq)  # at most 2^16: fits below rcp_shift
    out = np.stack([t.x_max, t.rcp_freq,
                    np.asarray(freqs, np.uint32) if alias else t.bias,
                    low | (t.rcp_shift << 24)], 1)
    return out.astype(np.uint32).view(np.int32)


def word_enc_table(freqs, cum_freqs, prob_bits: int) -> np.ndarray:
    """WORD encode kernel -> int32 [256, 4], u32 bits: per symbol (x_max -
    1, rcp_freq lo, rcp_freq hi, bias | cmpl_freq << 16), from
    ``tables.build_word_enc_tables``.  A step is then ``q = mulhi64(x,
    rcp_freq); x += bias + q * cmpl_freq``."""
    t = tables.build_word_enc_tables(freqs, cum_freqs, prob_bits)
    out = np.stack([t.x_max_m1, t.rcp_freq & np.uint64(0xFFFFFFFF),
                    t.rcp_freq >> np.uint64(32),
                    t.bias | (t.cmpl_freq << 16)], 1)  # both below 2^16
    return out.astype(np.uint32).view(np.int32)


def rans64_enc_table(freqs, cum_freqs, prob_bits: int) -> np.ndarray:
    """RANS64 encode kernel -> int32 [256, 8], u32 bits: per symbol
    (rcp_freq lo, rcp_freq hi, bias, cmpl_freq, rcp_shift, thr, 0, 0), from
    ``tables.build_rans64_enc_tables``, with ``thr = freq << (31 -
    prob_bits)`` the renorm threshold of the state's high word.  The six
    fields are those of the reference package's recip tables
    (rans64_tpu.pack_enc_tables_recip).  A step is then ``q = mulhi64(x,
    rcp_freq) >> rcp_shift; x += bias + q * cmpl_freq``.  cmpl_freq reaches
    2^31 - 1 at prob_bits 31, so no field has room for the shift: the row
    is padded to 32 bytes instead."""
    t = tables.build_rans64_enc_tables(freqs, cum_freqs, prob_bits)
    thr = t.freq.astype(np.uint64) << np.uint64(31 - prob_bits)
    zero = np.zeros(256, np.uint64)
    out = np.stack([t.rcp_freq & np.uint64(0xFFFFFFFF),
                    t.rcp_freq >> np.uint64(32), t.bias, t.cmpl_freq,
                    t.rcp_shift, thr, zero, zero], 1)
    return out.astype(np.uint32).view(np.int32)


def alias_dec_tables(freqs, cum_freqs, prob_bits: int):
    """ALIAS decode -> (divider int32[256], sym int32[512], freq int32[512],
    adjust int32[512]).

    The adjust is the true signed value: it lies in (-2^16, 2^16], and
    ``slot - adjust`` is the symbol's slot offset, in [0, freq).  Kernels
    in u32 arithmetic read it as the wrapped u32 the reference stores."""
    tab = alias_mod.make_alias_tables(freqs, cum_freqs, prob_bits)
    adj = tab.slot_adjust.astype(np.int64)
    adj = np.where(adj >= 1 << 31, adj - (1 << 32), adj)
    return (tab.divider.astype(np.int32), tab.sym_id.astype(np.int32),
            tab.slot_freqs.astype(np.int32), adj.astype(np.int32))


def alias_remap(freqs, cum_freqs, prob_bits: int) -> np.ndarray:
    """ALIAS encode -> the flat remap as int16[2^prob_bits] (u16 bits):
    x = (x / freq) << prob_bits | remap[x % freq + start]."""
    tab = alias_mod.make_alias_tables(freqs, cum_freqs, prob_bits)
    return tab.alias_remap.astype(np.uint16).view(np.int16)


def rans64_dec_tables(freqs, cum_freqs, prob_bits: int):
    """RANS64 decode -> (cum2sym uint8[2^prob_bits] up to prob_bits 16, else
    None; freq int32[256]; cum int32[257]), u32 bits."""
    c2s = (stats.cum2sym(np.asarray(cum_freqs, np.uint64), prob_bits)
           if prob_bits <= 16 else None)
    return c2s, _i32(freqs), _i32(cum_freqs)
