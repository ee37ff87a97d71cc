"""Text-like bytes: a Zipf law over a run of printable symbols.

Book1 of the Calgary corpus, which rygorous/ryg_rans's ``main.cpp`` codes,
uses 82 distinct bytes; Zipf(1.1) over 82 symbols gives about 4.8 bits a
byte coded order-0.  Drawn on ``device`` with a generator seeded from the
seed, a buffer at a time, and handed over as host ``bytes``: what a user
reads from a file.

Parameters, the configuration's ``data``: ``buffers``, ``bytes`` (each),
``alphabet_first``, ``alphabet_size``, ``zipf_exponent``.  ``tiny`` cuts a
configuration to the size the CPU tests code in a moment.
"""

from __future__ import annotations

import copy

import torch


def make(config: dict, seed: int, device) -> list[tuple[str, bytes]]:
    p = config["data"]
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 64))
    k = torch.arange(1, p["alphabet_size"] + 1, dtype=torch.float64)
    w = k ** -p["zipf_exponent"]
    cdf = torch.cumsum(w / w.sum(), 0).to(torch.float32).to(device)
    out = []
    for b in range(p["buffers"]):
        u = torch.rand(p["bytes"], generator=g, device=device)
        idx = torch.searchsorted(cdf, u, out_int32=True)
        idx.clamp_(max=p["alphabet_size"] - 1).add_(p["alphabet_first"])
        out.append((f"buffer{b}", idx.to(torch.uint8).cpu().numpy()
                    .tobytes()))
        del u, idx
    return out


def tiny(config: dict) -> dict:
    """``config`` with three buffers of 40,000 bytes."""
    c = copy.deepcopy(config)
    c["data"].update(buffers=3, bytes=40000)
    return c
