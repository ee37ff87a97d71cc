"""Deterministic synthetic corpora for the ryg_rans_tpu_torch tests.

Made with ``np.random.default_rng(seed)``; nothing reads a corpus file.
"""

import numpy as np

ALPHABET = np.arange(32, 32 + 82, dtype=np.uint8)  # 82 printable symbols


def skewed(n: int, seed: int = 0) -> np.ndarray:
    """Text-like bytes: Zipf(1.1) over 82 printable symbols."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, ALPHABET.size + 1) ** 1.1
    cdf = np.cumsum(p / p.sum())
    idx = np.minimum(np.searchsorted(cdf, rng.random(n)), ALPHABET.size - 1)
    return ALPHABET[idx]


def random_bytes(n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


def one_symbol(n: int, sym: int = 0x41) -> np.ndarray:
    return np.full(n, sym, np.uint8)


def sparse(n: int, seed: int = 0) -> np.ndarray:
    """One dominant symbol plus every other byte value a few times: many
    frequencies round to zero, which exercises the steal loop."""
    rng = np.random.default_rng(seed)
    out = np.full(n, 0x20, np.uint8)
    out[rng.integers(0, n, 3 * 256)] = np.tile(np.arange(256, dtype=np.uint8),
                                               3)
    return out


def dominant(n: int, seed: int = 0) -> np.ndarray:
    """One symbol and three rare ones, n >> 15 times each (at least once):
    at prob_bits 15 the model gives the rare ones freq 1 and the dominant
    one 2^15 - 3, so a WORD lane that codes a rare symbol runs its state
    past 2^31 while it codes the dominant one."""
    rng = np.random.default_rng(seed)
    out = np.full(n, 0x41, np.uint8)
    k = max(1, n >> 15)
    out[rng.integers(0, n, 3 * k)] = np.repeat(
        np.array([0x20, 0x61, 0xF0], np.uint8), k)
    return out


CORPORA = {"skewed": skewed, "random": random_bytes,
           "one_symbol": lambda n, seed=0: one_symbol(n), "sparse": sparse}
