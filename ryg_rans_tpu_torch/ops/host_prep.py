"""Host-side WORD tables in the layout the port's kernels read.

The decoder maps a slot to its symbol through a plain ``uint8`` cum2sym of
2^prob_bits entries, then reads the symbol's ``freq`` and ``cum``; the
encoder reads ``freq`` and ``start`` (= cum) per symbol.  Both kernels copy
these into shared memory at start.  The reference package's sym4 packing
and parity-interleaved bisect keys served the TPU's gathers and have no
counterpart here.
"""

from __future__ import annotations

import numpy as np

from ..models import stats


def dec_tables(freqs, cum_freqs, prob_bits: int):
    """-> (cum2sym uint8[2^prob_bits], freq int32[256], cum int32[256])."""
    c2s = stats.cum2sym(np.asarray(cum_freqs, np.uint64), prob_bits)
    return (c2s, np.asarray(freqs, np.int64).astype(np.int32),
            np.asarray(cum_freqs[:256], np.int64).astype(np.int32))


def enc_tables(freqs, cum_freqs):
    """-> (freq int32[256], start int32[256])."""
    return (np.asarray(freqs, np.int64).astype(np.int32),
            np.asarray(cum_freqs[:256], np.int64).astype(np.int32))
