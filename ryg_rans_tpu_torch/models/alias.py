"""Alias-method symbol lookup tables (Vose's algorithm) for the ALIAS variant.

The port's own copy of the reference package's construction: M slots split
into NSYMS buckets of tgt_sum = M/NSYMS slots, each holding at most two
symbols divided at ``divider[bucket]``, so decode finds a slot's symbol in
O(1).  The construction must reproduce main_alias.cpp:147-237 exactly,
because the bucket sweep order and the slot distribution fix the encoder's
``alias_remap`` bijection and therefore the bitstream:

* the small/large bucket sweep with back-tracking when a donor bucket turns
  small behind the scan cursor (main_alias.cpp:183-204);
* in-order code-slot distribution producing alias_remap, per-half
  slot_adjust and slot_freqs (main_alias.cpp:207-232);
* the "every symbol got exactly freqs[i] slots" postcondition
  (main_alias.cpp:235-236).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import NSYMS


@dataclasses.dataclass
class AliasTables:
    """Alias decode/encode tables (SymbolStats, main_alias.cpp:47-72).

    Decoder side, indexed by bucket2 = 2*bucket + (slot < divider[bucket]):
      divider[NSYMS]        absolute slot threshold of each bucket
                            (bucket*tgt_sum + slots of the lower half)
      slot_freqs[2*NSYMS]   frequency of the symbol in that half
      slot_adjust[2*NSYMS]  subtractive bias folding start + slot base, as
                            u32: a negative value is stored wrapped
      sym_id[2*NSYMS]       symbol id of that half
    Encoder side:
      alias_remap[M]        (cum_freq slot) -> alias-coded slot bijection
    """

    log2_nbuckets: int
    tgt_sum: int
    divider: np.ndarray      # u32 [NSYMS]
    slot_freqs: np.ndarray   # u32 [2*NSYMS]
    slot_adjust: np.ndarray  # u32 [2*NSYMS]
    sym_id: np.ndarray       # u32 [2*NSYMS]
    alias_remap: np.ndarray  # u32 [M]


def make_alias_tables(freqs: np.ndarray, cum_freqs: np.ndarray,
                      scale_bits: int) -> AliasTables:
    M = 1 << scale_bits
    n = NSYMS
    if M % n:
        raise ValueError("prob scale must be a multiple of the bucket count")
    tgt_sum = M // n

    freqs = np.asarray(freqs, dtype=np.int64)
    cum_freqs = np.asarray(cum_freqs, dtype=np.int64)
    remaining = freqs.copy()
    divider = np.full(n, tgt_sum, dtype=np.int64)
    sym_id = np.empty(2 * n, dtype=np.int64)
    sym_id[0::2] = np.arange(n)
    sym_id[1::2] = np.arange(n)

    # Vose's sweep: pair each "small" bucket (fewer than tgt_sum slots
    # remaining) with the current "large" donor (main_alias.cpp:169-204).
    cur_large = 0
    while cur_large < n and remaining[cur_large] < tgt_sum:
        cur_large += 1
    cur_small = 0
    while cur_small < n and remaining[cur_small] >= tgt_sum:
        cur_small += 1
    next_small = cur_small + 1

    while cur_large < n and cur_small < n:
        sym_id[cur_small * 2] = cur_large
        divider[cur_small] = remaining[cur_small]
        remaining[cur_large] -= tgt_sum - divider[cur_small]

        if remaining[cur_large] >= tgt_sum or next_small <= cur_large:
            cur_small = next_small
            while cur_small < n and remaining[cur_small] >= tgt_sum:
                cur_small += 1
            next_small = cur_small + 1
        else:
            # the donor just turned small and lies behind the scan cursor:
            # back-track to it (main_alias.cpp:198-199)
            cur_small = cur_large

        while cur_large < n and remaining[cur_large] < tgt_sum:
            cur_large += 1

    # distribute code slots in bucket order (main_alias.cpp:207-232)
    assigned = np.zeros(n, dtype=np.int64)
    alias_remap = np.zeros(M, dtype=np.uint32)
    slot_freqs = np.zeros(2 * n, dtype=np.int64)
    slot_adjust = np.zeros(2 * n, dtype=np.int64)

    for i in range(n):
        j = int(sym_id[i * 2])
        sym0_height = int(divider[i])          # home symbol i, lower slice
        sym1_height = tgt_sum - sym0_height    # alias symbol j, upper slice
        base0 = int(assigned[i])
        base1 = int(assigned[j])
        cbase0 = int(cum_freqs[i]) + base0
        cbase1 = int(cum_freqs[j]) + base1

        divider[i] = i * tgt_sum + sym0_height

        slot_freqs[i * 2 + 1] = freqs[i]
        slot_freqs[i * 2 + 0] = freqs[j]
        slot_adjust[i * 2 + 1] = i * tgt_sum - base0
        slot_adjust[i * 2 + 0] = i * tgt_sum - (base1 - sym0_height)

        k = np.arange(sym0_height, dtype=np.uint32)
        alias_remap[cbase0:cbase0 + sym0_height] = k + i * tgt_sum
        k = np.arange(sym1_height, dtype=np.uint32)
        alias_remap[cbase1:cbase1 + sym1_height] = \
            (k + sym0_height) + i * tgt_sum

        assigned[i] += sym0_height
        assigned[j] += sym1_height

    if not np.array_equal(assigned, freqs):
        raise AssertionError("alias table slot accounting failed")

    # half convention: bucket2 = 2*bucket is incremented when slot <
    # divider (main_alias.cpp:258-262), so half 1 is the lower slice
    # [bucket*tgt_sum, divider), which holds the home symbol, and half 0
    # the upper slice, which holds the alias symbol: hence sym_id[2i] =
    # alias, sym_id[2i+1] = i above
    return AliasTables(
        log2_nbuckets=8,
        tgt_sum=tgt_sum,
        divider=divider.astype(np.uint32),
        slot_freqs=slot_freqs.astype(np.uint32),
        slot_adjust=slot_adjust.astype(np.uint32),
        sym_id=sym_id.astype(np.uint32),
        alias_remap=alias_remap,
    )
