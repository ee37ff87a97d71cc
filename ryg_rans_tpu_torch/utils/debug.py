"""Debug validation: state invariants, stream poisoning, container audit.

The port's copy of the reference package's ``utils/debug.py``.  The
reference's closest analogs: RansAssert macros compiled in on demand
(rans_byte.h:11-15), renorm postcondition asserts (rans64.h:88,138,312), and
0xcc-poisoned decode buffers so a decoder that writes nothing fails memcmp
(main.cpp:166,218).  Here the same checks are host-side functions a test or
a paranoid pipeline can call explicitly; the kernels stay branch-free.
"""

from __future__ import annotations

import numpy as np

from ..config import RansConfig, VariantSpec

POISON = 0xCC  # main.cpp:166


def poison(n: int) -> np.ndarray:
    """A 0xcc-filled decode buffer (main.cpp:166): catches decoders that
    silently write nothing."""
    return np.full(n, POISON, np.uint8)


def check_state_invariants(x, spec: VariantSpec) -> None:
    """Every renormalized coder state must satisfy L <= x < b*L
    (rans_byte.h:46-49: the I(s) interval invariant).

    Raises AssertionError with the offending lane indices.
    """
    x = np.asarray(x, np.uint64)
    L = np.uint64(spec.L)
    bL = np.uint64(spec.L) << np.uint64(spec.word_bits)
    bad = np.nonzero((x < L) | (x >= bL))[0]
    if bad.size:
        raise AssertionError(
            f"{bad.size} states outside [L, b*L): lanes {bad[:8].tolist()}"
            f" values {x[bad[:8]].tolist()}")


def check_stream_counts(cfg: RansConfig, payloads) -> None:
    """Container audit: every substream must at least hold its lanes' flushed
    states (the head is mandatory, docs/FORMAT.md)."""
    spec = cfg.spec
    head = cfg.lanes_per_stream * spec.state_words
    for b, blk in enumerate(payloads):
        if len(blk) != cfg.n_streams:
            raise AssertionError(
                f"block {b}: {len(blk)} substreams != {cfg.n_streams}")
        for s, words in enumerate(blk):
            if words.size < head:
                raise AssertionError(
                    f"block {b} substream {s}: {words.size} words < "
                    f"head {head}")


def decode_states_from_head(cfg: RansConfig, stream: np.ndarray) -> np.ndarray:
    """Parse the flushed states out of a substream head (RansDecInit layout)
    for invariant checking."""
    spec = cfg.spec
    lpg = cfg.lanes_per_stream
    head = np.asarray(stream[:lpg * spec.state_words],
                      np.uint64).reshape(lpg, spec.state_words)
    x = np.zeros(lpg, np.uint64)
    for w in range(spec.state_words):
        x |= head[:, w] << np.uint64(spec.word_bits * w)
    return x
