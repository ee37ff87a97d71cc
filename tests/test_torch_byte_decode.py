"""The plain K3 version through ryg_rans_tpu_torch.ops.codec.decode against
the reference package's Pallas BYTE/ALIAS decoder (interpret mode), symbol
for symbol, on the cases of test_torch_byte that carry the Pallas checks
(kept in a file of their own so that each file stays short)."""

import numpy as np
import pytest

from ryg_rans_tpu.ops import byte_tpu
from ryg_rans_tpu_torch.ops import codec
from test_torch_byte import CASES, IDS, PALLAS, port_encode, setup


@pytest.mark.parametrize("case", [CASES[i] for i in PALLAS],
                         ids=[IDS[i] for i in PALLAS])
def test_decode_matches_pallas(case):
    cfg, jcfg, data, freqs, cum = setup(case)
    blocks, padded = port_encode(cfg, data, freqs, cum)
    sizes = codec.block_sizes(cfg.block_symbols, padded.numel())
    mine = codec.decode(cfg, blocks, sizes, freqs, cum, "cpu").numpy()
    theirs = byte_tpu.decode(jcfg, blocks, padded.numel(), freqs, cum,
                             interpret=True)
    assert mine.dtype == theirs.dtype == np.uint8
    assert np.array_equal(mine, theirs)
    assert np.array_equal(mine[:data.size], data)
