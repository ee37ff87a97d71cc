"""Static configuration of a coded stream.

The port's own copy of the reference package's configuration: the same
variants, arithmetic parameters and size-adaptive defaults, so that a
container written by either package parses to the same ``RansConfig``.
"""

from __future__ import annotations

import dataclasses
import enum


class Variant(enum.IntEnum):
    """The four codec variants, as container-format IDs.

    BYTE   - 32-bit state, 8-bit renormalization  (rans_byte.h)
    WORD   - 32-bit state, 16-bit renormalization (rans_word_sse41.h)
    RANS64 - 64-bit state, 32-bit renormalization (rans64.h)
    ALIAS  - BYTE state machine + alias-method O(1) symbol lookup
             (main_alias.cpp:241-267)
    """

    BYTE = 0
    WORD = 1
    RANS64 = 2
    ALIAS = 3


#: Alphabet size: 8-bit symbols throughout.
NSYMS = 256


@dataclasses.dataclass(frozen=True)
class VariantSpec:
    """Arithmetic parameters of one codec variant."""

    variant: Variant
    state_bits: int      # bits in the coder state
    word_bits: int       # bits emitted/consumed per renorm step
    l_bits: int          # log2(L), lower bound of normalization interval
    max_prob_bits: int   # max supported scale_bits
    max_renorm: int      # upper bound on renorm iterations per symbol

    @property
    def L(self) -> int:
        return 1 << self.l_bits

    @property
    def word_mask(self) -> int:
        return (1 << self.word_bits) - 1

    @property
    def state_words(self) -> int:
        """Words written by a state flush (RansEncFlush analog)."""
        return self.state_bits // self.word_bits


BYTE_SPEC = VariantSpec(Variant.BYTE, 32, 8, 23, 16, 2)
WORD_SPEC = VariantSpec(Variant.WORD, 32, 16, 16, 16, 1)
RANS64_SPEC = VariantSpec(Variant.RANS64, 64, 32, 31, 31, 1)
ALIAS_SPEC = VariantSpec(Variant.ALIAS, 32, 8, 23, 16, 2)

SPECS: dict[Variant, VariantSpec] = {
    Variant.BYTE: BYTE_SPEC,
    Variant.WORD: WORD_SPEC,
    Variant.RANS64: RANS64_SPEC,
    Variant.ALIAS: ALIAS_SPEC,
}

#: Default prob_bits per variant (main.cpp:136 = 14, main_simd.cpp
#: RANS_WORD_SCALE_BITS = 12, main64.cpp:136 = 14, main_alias.cpp:276 = 16).
DEFAULT_PROB_BITS: dict[Variant, int] = {
    Variant.BYTE: 14,
    Variant.WORD: 12,
    Variant.RANS64: 14,
    Variant.ALIAS: 16,
}


@dataclasses.dataclass(frozen=True)
class RansConfig:
    """Full static description of a coded stream.

    ``n_lanes`` independent coder states are partitioned into
    ``n_streams = n_lanes / lanes_per_stream`` substreams; each substream
    carries the flushed states of its lanes followed by their interleaved
    renorm words (docs/FORMAT.md).  ``lanes_per_stream`` defaults to
    ``n_lanes``: one substream per block, the layout the device kernels
    consume.
    """

    variant: Variant = Variant.WORD
    prob_bits: int = 12
    n_lanes: int = 1024
    lanes_per_stream: int | None = None  # None -> n_lanes
    block_symbols: int = 1 << 19  # symbols per independent block
    checksum: bool = True

    def __post_init__(self):
        spec = self.spec
        if self.prob_bits > spec.max_prob_bits:
            raise ValueError(
                f"prob_bits={self.prob_bits} exceeds "
                f"{spec.variant.name} max {spec.max_prob_bits}")
        if self.prob_bits < 8:
            raise ValueError("prob_bits must be >= 8 (alphabet is 256)")
        if self.n_lanes < 1 or self.n_lanes & (self.n_lanes - 1):
            raise ValueError("n_lanes must be a positive power of two")
        if self.block_symbols < self.n_lanes:
            raise ValueError("block_symbols must be >= n_lanes (and a "
                             "crafted 0 would loop the block iterator)")
        if self.lanes_per_stream is None:
            object.__setattr__(self, "lanes_per_stream", self.n_lanes)
        if self.lanes_per_stream & (self.lanes_per_stream - 1):
            raise ValueError("lanes_per_stream must be a power of two")
        if self.lanes_per_stream > self.n_lanes:
            object.__setattr__(self, "lanes_per_stream", self.n_lanes)
        if self.block_symbols % self.n_lanes:
            raise ValueError("block_symbols must be a multiple of n_lanes")

    @property
    def spec(self) -> VariantSpec:
        return SPECS[self.variant]

    @property
    def n_streams(self) -> int:
        return self.n_lanes // self.lanes_per_stream

    @property
    def prob_scale(self) -> int:
        return 1 << self.prob_bits

    @classmethod
    def reference(cls, variant: Variant, n_lanes: int = 1) -> "RansConfig":
        """Config reproducing the reference demo layouts bit-for-bit."""
        return cls(
            variant=variant,
            prob_bits=DEFAULT_PROB_BITS[variant],
            n_lanes=n_lanes,
            lanes_per_stream=n_lanes,
            checksum=False,
        )

    @classmethod
    def auto(cls, n_bytes: int,
             variant: "Variant | None" = None) -> "RansConfig":
        """Size-adaptive config: the shape ``compress(data)`` uses by default.

        Picks the largest lane count (1024 to 16384) whose flushed-state
        head (4 B per lane per block) stays under ~0.8% of the input
        (n_lanes <= n_bytes/512), and blocks of up to 2^23 symbols.  With no
        explicit ``variant`` the full 16384-lane shape gets WORD
        prob_bits=11 and smaller inputs WORD prob_bits=12.
        """
        n = 1024
        while n < 16384 and n * 2 * 512 <= max(n_bytes, 1):
            n *= 2
        bs = 4 * n
        while bs < (1 << 23) and bs < max(n_bytes, 1):
            bs *= 2
        if variant is None:
            return cls(variant=Variant.WORD,
                       prob_bits=11 if n == 16384 else 12,
                       n_lanes=n, block_symbols=bs)
        return cls(variant=variant, prob_bits=DEFAULT_PROB_BITS[variant],
                   n_lanes=n, block_symbols=bs)
