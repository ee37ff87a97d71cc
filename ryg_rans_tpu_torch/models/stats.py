"""Order-0 static probability model with exact reference integer semantics.

Reproduces ``SymbolStats`` of the reference demos (main.cpp:49-129):
histogram -> exclusive prefix sum -> integer renormalization to a
power-of-two total with a "steal one slot from the smallest freq>1 symbol"
fixup.  The truncation and the steal scan order decide the container bytes,
so the fixup stays the same sequential host sweep, in Python ints and numpy.
The histogram of data already on the card is ``torch.bincount`` (see
``api``); everything here runs on the host.
"""

from __future__ import annotations

import numpy as np

from ..config import NSYMS


def count_freqs(data: np.ndarray) -> np.ndarray:
    """256-bin byte histogram (main.cpp:59-66), in 16 MiB chunks so that
    ``np.bincount``'s intp copy of its input stays small."""
    data = np.asarray(data).ravel()
    if data.dtype != np.uint8:
        data = data.astype(np.uint8)
    out = np.zeros(NSYMS, np.int64)
    step = 1 << 24
    for off in range(0, data.size, step):
        out += np.bincount(data[off:off + step], minlength=NSYMS)
    return out.astype(np.uint32)


def calc_cum_freqs(freqs: np.ndarray) -> np.ndarray:
    """Exclusive prefix sum -> cum_freqs[257] (main.cpp:68-73)."""
    cum = np.zeros(NSYMS + 1, dtype=np.uint64)
    np.cumsum(freqs.astype(np.uint64), out=cum[1:])
    return cum


def normalize_freqs(
    freqs: np.ndarray, target_total: int
) -> tuple[np.ndarray, np.ndarray]:
    """Rescale ``freqs`` so they sum to ``target_total`` (a power of two).

    * each cumulative count maps through ``(target_total * cum) //
      cur_total`` in 64-bit integer math (main.cpp:83-84);
    * any symbol with a nonzero raw count whose scaled frequency rounded to
      zero steals one slot from the currently-smallest symbol with freq > 1,
      scanning j = 0..255 and keeping the first minimum (main.cpp:90-116);
    * frequencies are re-derived from the adjusted cumulative array
      (main.cpp:127).

    Returns ``(freqs[256], cum_freqs[257])`` as uint32/uint64 arrays.
    """
    freqs = np.asarray(freqs, dtype=np.uint64)
    if target_total < NSYMS:
        raise ValueError("target_total must be >= 256")
    cum = calc_cum_freqs(freqs)
    cur_total = int(cum[NSYMS])
    if cur_total == 0:
        raise ValueError("cannot model an empty input")

    cum = (int(target_total) * cum) // cur_total  # exact 64-bit truncation

    for i in range(NSYMS):
        if freqs[i] and cum[i + 1] == cum[i]:
            # symbol i rounded to zero: steal one slot from the first
            # smallest freq>1 symbol, shifting the cum range between them
            step_freqs = cum[1:] - cum[:-1]
            candidates = np.where(step_freqs > 1)[0]
            if candidates.size == 0:
                raise ValueError("no symbol to steal frequency from")
            # np.argmin keeps the first minimum, as the reference's strict
            # `freq < best_freq` scan does (main.cpp:97-103)
            best_steal = int(candidates[np.argmin(step_freqs[candidates])])
            if best_steal < i:
                cum[best_steal + 1:i + 1] -= 1
            else:
                cum[i + 1:best_steal + 1] += 1

    if cum[0] != 0 or cum[NSYMS] != target_total:
        raise AssertionError("normalized model does not sum to its total")
    new_freqs = (cum[1:] - cum[:-1]).astype(np.uint32)
    zero_raw = freqs == 0
    if np.any(new_freqs[zero_raw]) or not np.all(new_freqs[~zero_raw]):
        raise AssertionError("normalized model lost or invented a symbol")
    return new_freqs, cum


def build_model(data: np.ndarray,
                prob_bits: int) -> tuple[np.ndarray, np.ndarray]:
    """count + normalize in one call -> (freqs, cum_freqs)."""
    return normalize_freqs(count_freqs(data), 1 << prob_bits)


def build_model_from_counts(counts: np.ndarray,
                            prob_bits: int) -> tuple[np.ndarray, np.ndarray]:
    """Normalize a precomputed 256-bin histogram -> (freqs, cum_freqs)."""
    return normalize_freqs(np.asarray(counts, np.uint64), 1 << prob_bits)


def cum2sym(cum_freqs: np.ndarray, prob_bits: int) -> np.ndarray:
    """Linear slot->symbol table (main.cpp:145-148): ``cum2sym[slot] = s``
    for ``cum_freqs[s] <= slot < cum_freqs[s+1]``."""
    M = 1 << prob_bits
    slots = np.arange(M, dtype=np.uint64)
    # side='right' maps slot == cum[s] to symbol s
    table = np.searchsorted(cum_freqs[1:], slots, side="right")
    return table.astype(np.uint8)
