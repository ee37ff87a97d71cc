"""The device's peak bandwidth, and what every byte rule counts.

A kernel's rule, ``rooflines/<kernel>.py`` or a coder's
``rooflines/coder_<direction>.py``, gives ``nbytes(header)``: the bytes the kernel cannot do without, from a
container's header.  The count is of the algorithm's work, whatever
implements it: each input byte read once, each output byte written once,
and each table read once a call.  Never counted: dense cells, masks, ring
refills or any byte a kernel reads again.
"""

from __future__ import annotations

import json
from pathlib import Path

#: A coder's frequency and cumulative tables: 256 entries of 4 bytes each.
TABLE_BYTES = 2 * 256 * 4
PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def hbm_bytes_per_s(device_kind: str) -> float | None:
    """The published memory bandwidth of the card named ``device_kind``
    (``torch.cuda.get_device_name``), or None for a card not in
    ``peaks.json``: its shares are then not read."""
    entry = PEAKS.get(device_kind)
    return None if entry is None else float(entry["hbm_bytes_per_s"])
