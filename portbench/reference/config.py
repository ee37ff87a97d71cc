"""The shape a container is coded in: variants, their word sizes, and the
size-adaptive rule that ``compress(data)`` applies when it is given no
configuration (docs/FORMAT.md, ``RansConfig.auto``)."""

from __future__ import annotations

import dataclasses

#: Container variant ids and the bytes of one stream word of each.
VARIANT_IDS = {"BYTE": 0, "WORD": 1, "RANS64": 2, "ALIAS": 3}
VARIANT_NAMES = {v: k for k, v in VARIANT_IDS.items()}
WORD_BYTES = {"BYTE": 1, "WORD": 2, "RANS64": 4, "ALIAS": 1}


@dataclasses.dataclass(frozen=True)
class Shape:
    variant: str
    prob_bits: int
    n_lanes: int
    block_symbols: int
    checksum: bool

    def block_sizes(self, n_bytes: int) -> list[int]:
        """Padded symbols of each block of an input of ``n_bytes``: the
        input is padded to a multiple of 4 * n_lanes (at least one step)."""
        step = 4 * self.n_lanes
        padded = -(-max(n_bytes, 1) // step) * step
        n_full, tail = divmod(padded, self.block_symbols)
        return [self.block_symbols] * n_full + ([tail] if tail else [])


def auto(n_bytes: int, checksum: bool = True) -> Shape:
    """The default shape for ``n_bytes``: the most lanes (1024 to 16384)
    with n_lanes <= n_bytes / 512, blocks of up to 2^23 symbols, WORD at
    prob_bits 11 on 16384 lanes and 12 below."""
    n = 1024
    while n < 16384 and n * 2 * 512 <= max(n_bytes, 1):
        n *= 2
    bs = 4 * n
    while bs < (1 << 23) and bs < max(n_bytes, 1):
        bs *= 2
    return Shape("WORD", 11 if n == 16384 else 12, n, bs, checksum)


def shape_of(rans_config: dict, n_bytes: int) -> Shape:
    """The shape that a configuration's ``rans_config`` codes ``n_bytes``
    in: ``{"rule": "auto", "checksum": c}`` is the rule above, which the
    program applies when it is given no configuration (``c`` is the
    entry point's default: on for host bytes, off on the device);
    ``{"rule": "explicit", "variant", "prob_bits", "n_lanes",
    "block_symbols", "checksum"}`` is that shape, whatever the size."""
    rule = rans_config["rule"]
    if rule == "auto":
        return auto(n_bytes, rans_config["checksum"])
    if rule == "explicit":
        return Shape(rans_config["variant"], rans_config["prob_bits"],
                     rans_config["n_lanes"], rans_config["block_symbols"],
                     rans_config["checksum"])
    raise ValueError(f"no rans_config rule {rule!r} (auto or explicit)")
