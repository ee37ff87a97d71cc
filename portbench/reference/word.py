"""WORD encoder: 32-bit states, 16-bit renormalisation
(rans_word_sse41.h), one substream per block.

Symbol ``i`` of a block is step ``i // N``, lane ``i % N``.  Steps are coded
last to first, every lane of every block at once.  A block's stream is its
final states, lane-ascending as little-endian u16 pairs, then the emitted
words in the order a decoder reads them: step ascending, lane ascending
(docs/FORMAT.md).  Plain integer division, no reciprocals.
"""

from __future__ import annotations

import numpy as np

L_BITS = 16


def encode_blocks(syms: np.ndarray, freqs: np.ndarray, cum: np.ndarray,
                  n_lanes: int, prob_bits: int) -> list[np.ndarray]:
    """uint8 [nb, S] (S a multiple of n_lanes) -> per-block uint16 streams.

    States stay below 2^32, so uint32 holds every value; ``x >= f << (32 -
    prob_bits)`` is tested as ``x >> (32 - prob_bits) >= f`` so that a
    frequency of 2^prob_bits (a one-symbol model) cannot overflow."""
    nb, S = syms.shape
    T = S // n_lanes
    grid = syms.reshape(nb, T, n_lanes)
    f = np.asarray(freqs, np.uint32)
    st = np.asarray(cum[:256], np.uint32)
    k, pb, w = np.uint32(32 - prob_bits), np.uint32(prob_bits), np.uint32(16)
    x = np.full((nb, n_lanes), 1 << L_BITS, np.uint32)
    words = np.empty((nb, T, n_lanes), np.uint16)
    emitted = np.empty((nb, T, n_lanes), bool)
    for t in range(T - 1, -1, -1):
        s = grid[:, t]
        fs = f[s]
        m = (x >> k) >= fs
        emitted[:, t] = m
        words[:, t] = x  # the low half: the word a renorm emits
        x = np.where(m, x >> w, x)
        q, r = np.divmod(x, fs)
        x = (q << pb) + r + st[s]
    heads = x.view(np.uint16).reshape(nb, 2 * n_lanes)  # lo, hi per lane
    return [np.concatenate([heads[b], words[b][emitted[b]]])
            for b in range(nb)]
