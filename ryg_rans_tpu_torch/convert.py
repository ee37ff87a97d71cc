"""Carry the reference package's state into the port.

A codec has no weights.  What crosses over is the configuration (as plain
fields, so this module needs nothing of the reference package) and the
order-0 model; the container itself is the other carrier, and both
packages read it.
"""

from __future__ import annotations

import numpy as np

from .config import NSYMS, RansConfig, Variant


def config_from_reference(fields: dict) -> RansConfig:
    """``dataclasses.asdict`` of the reference's RansConfig -> RansConfig."""
    return RansConfig(
        variant=Variant(int(fields["variant"])),
        prob_bits=int(fields["prob_bits"]),
        n_lanes=int(fields["n_lanes"]),
        lanes_per_stream=int(fields["lanes_per_stream"]),
        block_symbols=int(fields["block_symbols"]),
        checksum=bool(fields["checksum"]))


def model_from_reference(freqs, cum) -> tuple[np.ndarray, np.ndarray]:
    """Check a normalized model's invariants -> (freqs uint32[256],
    cum uint64[257]).

    Raises ValueError unless cum is the exclusive prefix sum of freqs,
    starts at 0 and totals a power of two of at least 256."""
    f = np.asarray(freqs)
    c = np.asarray(cum)
    if f.shape != (NSYMS,) or c.shape != (NSYMS + 1,):
        raise ValueError("model must be freqs[256] and cum[257]")
    if f.dtype.kind not in "iu" or c.dtype.kind not in "iu":
        raise ValueError("model arrays must hold integers")
    f = f.astype(np.int64)
    c = c.astype(np.int64)
    total = int(c[-1])
    if (np.any(f < 0) or c[0] != 0 or not np.array_equal(np.diff(c), f)
            or total < NSYMS or total & (total - 1)):
        raise ValueError("not a normalized model: cum must be the prefix "
                         "sum of freqs, totalling a power of two >= 256")
    return f.astype(np.uint32), c.astype(np.uint64)
