"""Library logging: routing and sizing decisions are observable via the
standard ``logging`` module.

Enable with e.g.::

    import logging
    logging.getLogger("ryg_rans_tpu_torch").setLevel(logging.DEBUG)
    logging.basicConfig()
"""

from __future__ import annotations

import logging

logger = logging.getLogger("ryg_rans_tpu_torch")


def backend_choice(cfg, requested: str, chosen: str) -> None:
    """Log where a call codes: ``chosen`` is the device or the host backend
    that runs, ``requested`` the argument that named it."""
    logger.debug("coding on %s (requested %s) variant=%s prob_bits=%d "
                 "n_lanes=%d lanes_per_stream=%d block_symbols=%d", chosen,
                 requested, cfg.variant.name, cfg.prob_bits, cfg.n_lanes,
                 cfg.lanes_per_stream, cfg.block_symbols)


def container_summary(orig_len: int, packed_len: int, n_blocks: int) -> None:
    logger.info("container: %d -> %d bytes (%.3f bits/byte), %d blocks",
                orig_len, packed_len,
                8 * packed_len / max(orig_len, 1), n_blocks)
