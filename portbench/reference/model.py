"""Order-0 static model: histogram, then normalisation to a power-of-two
total with the reference's fix-up for symbols that round to zero
(main.cpp:49-129).  The truncation and the order of the fix-up decide the
container's bytes."""

from __future__ import annotations

import numpy as np


def counts(data: np.ndarray) -> np.ndarray:
    """256-bin histogram, in 16 MiB pieces to keep bincount's copy small."""
    out = np.zeros(256, np.int64)
    for off in range(0, data.size, 1 << 24):
        out += np.bincount(data[off:off + (1 << 24)], minlength=256)
    return out


def normalize(raw: np.ndarray, prob_bits: int) -> tuple[np.ndarray,
                                                       np.ndarray]:
    """-> (freqs int64[256] summing to 2^prob_bits, cum int64[257]).

    Each cumulative count maps to ``(total * cum) // cur_total``; a symbol
    that occurs but rounds to zero takes one slot from the first smallest
    symbol with a frequency above 1, shifting the cumulative counts between
    the two."""
    raw = np.asarray(raw, np.int64)
    target = 1 << prob_bits
    cum = np.zeros(257, np.int64)
    np.cumsum(raw, out=cum[1:])
    total = int(cum[256])
    if total == 0:
        raise ValueError("cannot model an empty input")
    # Python integers: target * cum can pass 2^63 for inputs over 2^32 bytes
    cum = np.array([target * int(c) // total for c in cum], np.int64)
    for i in range(256):
        if raw[i] and cum[i + 1] == cum[i]:
            f = cum[1:] - cum[:-1]
            cand = np.flatnonzero(f > 1)
            if cand.size == 0:
                raise ValueError("no symbol to take a slot from")
            best = int(cand[np.argmin(f[cand])])
            if best < i:
                cum[best + 1:i + 1] -= 1
            else:
                cum[i + 1:best + 1] += 1
    freqs = cum[1:] - cum[:-1]
    if cum[256] != target or np.any((freqs == 0) != (raw == 0)):
        raise AssertionError("normalised model is not a model of the input")
    return freqs, cum
